"""Wavefront tracing with alive-prefix compaction (counterpart of
``srt_tpu/models/wavefront_compact.py``).

The bounce loop runs over a static per-bounce **width schedule**: after
each bounce's re-sort (live rays first) the carry is sliced to the next
scheduled width, and the dropped tail — dead, so its radiance is final —
is banked.  Rays exit the wavefront exactly once; the image is assembled
by one scatter into pixel order (the JAX package's argsort + gather is a
TPU scatter workaround).  If a frame has more live rays than a scheduled
width, ``overflow`` counts them instead of silently dropping paths.

``discover_schedule`` derives the widths from one probe frame's alive
counts with a safety margin: path death is a property of (scene, camera,
depth), not of the random numbers.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import pathtracer
from srt_tpu_torch.ops.rng import KeyStream, bounce_slots
from srt_tpu_torch.ops.vec import bc
from srt_tpu_torch.scene import Lights
from srt_tpu_torch.utils.profiling import span

# Width granule of discovered schedules (kept from the JAX package so the
# two packages discover the same schedules).
GRANULE = 4096


@functools.lru_cache(maxsize=None)
def _bounce_span(b: int) -> str:
    """The span name of bounce ``b`` (from 1), built once."""
    return f"srt.bounce.{b}"


def trace_compact(closest_hit, lights: Lights, origins, dirs, stream,
                  cfg: RenderConfig, schedule: Sequence[int], pix_init=None,
                  return_stats: bool = False, emitters=None):
    """Compacted wavefront trace of [3, N] rays.

    ``closest_hit`` is one hit fn or one per bounce; ``schedule`` holds
    the non-increasing per-bounce widths, ``schedule[0] == N``.  ``stream``
    is consumed as one ``take_block(n_bounces * slots)`` in PIXEL order;
    ``pix_init`` (a permutation of 0..N-1) maps wavefront position to
    pixel.  Returns pixel-order radiance [3, N] and, with
    ``return_stats``, stats [B, 2] int32 and the overflow count (int32
    scalar tensor).  ``emitters`` with ``cfg.nee`` turns on next-event
    estimation (3 more slots a bounce); the carry's cone and ``prev_pdf``
    channels are sliced with the rest, so they stay aligned with
    ``pix``."""
    n = origins.shape[1]
    dev = origins.device
    n_bounces = cfg.max_depth + cfg.rr_bounces
    if isinstance(closest_hit, (list, tuple)):
        hit_fns = list(closest_hit)
        if len(hit_fns) != n_bounces:
            raise ValueError(f"{len(hit_fns)} hit fns for {n_bounces} bounces")
    else:
        hit_fns = [closest_hit] * n_bounces
    schedule = tuple(int(w) for w in schedule)
    if len(schedule) != n_bounces:
        raise ValueError(f"schedule has {len(schedule)} widths, need "
                         f"{n_bounces}")
    if schedule[0] != n:
        raise ValueError("schedule[0] must cover every primary ray")
    if any(a < b for a, b in zip(schedule, schedule[1:])):
        raise ValueError("schedule must be non-increasing")
    nee_on = emitters is not None and cfg.nee
    d_slots = bounce_slots(lights.count, nee_on)
    u_blk = stream.take_block(n_bounces * d_slots)

    pix = (None if pix_init is None
           else torch.as_tensor(np.asarray(pix_init), device=dev).long())
    carry = pathtracer.initial_carry(origins, dirs, cfg, nee_on, pix)
    pix_chunks, color_chunks, stats = [], [], []
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    for b in range(n_bounces):
        with span(_bounce_span(b + 1)):
            width = schedule[b]
            if width < carry[0].shape[1]:
                pix_chunks.append(carry[5][width:])
                color_chunks.append(carry[3][:, width:])
                carry = tuple(x[:, :width] if x.ndim == 2 else x[:width]
                              for x in carry)
            u = u_blk.rows_at(b * d_slots, (b + 1) * d_slots, carry[5])
            carry, st = pathtracer.bounce_step(hit_fns[b], lights, cfg,
                                               carry, b, u, sort=True,
                                               emitters=emitters)
            stats.append(st)
            if b + 1 < n_bounces:
                n_alive = carry[4].sum(dtype=torch.int32)
                overflow = overflow + torch.clamp_min(
                    n_alive - schedule[b + 1], 0)

    # Paths alive after the last bounce are truncated as a miss.
    origins, dirs, throughput, color, alive, pix = carry[:6]
    color = color + torch.where(bc(alive),
                                throughput * pathtracer._sky(dirs, cfg),
                                torch.zeros_like(color))
    pix_chunks.append(pix)
    color_chunks.append(color)
    image = torch.empty((3, n), device=dev)
    image[:, torch.cat(pix_chunks)] = torch.cat(color_chunks, dim=1)
    if return_stats:
        return image, torch.stack(stats), overflow
    return image


def trace_image_compact(closest_hit, lights: Lights, cam: CameraConfig,
                        cfg: RenderConfig, stream, schedule: Sequence[int],
                        origin=None, look_at=None, return_stats: bool = False,
                        emitters=None):
    """One full image via the compacted trace; linear [H, W, 3].

    ``cfg.spp`` samples per pixel are traced in one wavefront, a pixel's
    samples adjacent (sample id = pixel * spp + s); the image is their
    mean.  The stream must cover ``spp * W * H`` rays and
    ``schedule[0]`` must equal that total.  ``origin`` / ``look_at``
    override the camera's pose (``derive_viewport``).  With
    ``cfg.ray_cones`` and no ``primary_spread``, the spread is one pixel's
    footprint; ``emitters`` as in ``trace_compact``."""
    cfg = pathtracer.with_primary_spread(cfg, cam)
    k = cfg.spp
    n_pix = cam.width * cam.height
    with span("srt.raygen"):
        jitter = stream.take(2)                               # [2, K*N]
        defocus = stream.take(2) if cam.defocus_angle > 0 else None
        vp = derive_viewport(cam, origin=origin, look_at=look_at,
                             device=jitter.device)
        origins, dirs = generate_rays(vp, cam.width, cam.height, jitter,
                                      defocus)
        pix_init = None
        if cfg.morton_order:
            from srt_tpu_torch.ops.morton import morton_perm, permute_rays
            perm, _ = morton_perm(cam.height, cam.width)
            if k > 1:
                perm = (perm[:, None] * k
                        + np.arange(k, dtype=perm.dtype)[None, :]).reshape(-1)
            origins, dirs = permute_rays(origins, dirs, perm)
            pix_init = perm
    out = trace_compact(closest_hit, lights, origins, dirs, stream, cfg,
                        schedule, pix_init=pix_init,
                        return_stats=return_stats, emitters=emitters)
    radiance = out[0] if return_stats else out
    if k > 1:
        radiance = radiance.T.reshape(n_pix, k, 3).mean(1).T
    img = radiance.T.reshape(cam.height, cam.width, 3)
    if return_stats:
        return img, out[1], out[2]
    return img


def discover_schedule(closest_hit, lights: Lights, cam: CameraConfig,
                      cfg: RenderConfig, key: torch.Tensor,
                      margin: float = 1.25, min_width: int = GRANULE,
                      granule: int = GRANULE, emitters=None) -> tuple:
    """Run one full-width probe frame drawn from ``key`` (``ops/rng.key``;
    with ``emitters`` as the frames will) and round its per-bounce alive
    counts (times ``margin``) up to ``granule`` widths."""
    n = cam.width * cam.height * cfg.spp
    full = tuple([n] * (cfg.max_depth + cfg.rr_bounces))
    _, stats, _ = trace_image_compact(
        closest_hit, lights, cam, cfg, KeyStream(key, n), full,
        return_stats=True, emitters=emitters)
    counts = stats[:, 0].cpu().numpy()
    sched = [n]
    for b in range(1, len(counts)):
        want = max(int(counts[b] * margin), min_width)
        sched.append(min(-(-want // granule) * granule, sched[-1], n))
    return tuple(sched)
