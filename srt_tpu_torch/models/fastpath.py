"""Library-default render plan (counterpart of ``srt_tpu/models/fastpath.py``).

``make_render_plan(scene, lights, cam, cfg)`` packages the per-bounce,
per-query-kind walk schedule (tiled walk at tile 256 for primaries, the
per-group ``pg2:G:W`` walk for later bounces and shadow rays) with the
width-compacted wavefront driver and the coherence re-sorts.  Its
``render(key)`` draws the frame's uniforms from ``KeyStream(key)`` (a key
from ``ops/rng.key``: the same numbers as the JAX plan's
``render(jax.random.key(seed))``) and returns ``(image [H, W, 3], stats
[B, 2] int32, overflow)``; a frame with ``overflow != 0`` is invalid.

Differences from the JAX package: the port always takes the compact
driver (the JAX plan sends scenes of <= 8 superclusters to a ``lax.scan``
integrator, an XLA compile-time heuristic), and its default method is the
walk schedule on every device (CUDA kernels on the GPU, their plain
versions on the CPU).  ``"dense"`` stays available as the baseline.
Models above ``traversal.STREAM_THRESHOLD_CLUSTERS`` clusters walk with
the streamed kernels, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh as mesh_mod
from srt_tpu_torch.models.emitters import Emitters, scene_emitters
from srt_tpu_torch.models.wavefront_compact import (discover_schedule,
                                                    trace_image_compact)
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import Lights
from srt_tpu_torch.utils.profiling import span


def parse_walk(tok: str):
    """Parse one walk token -> (binned_mode, kernel_tile).

    Tokens: ``"tiled"`` | ``"tiled@N"`` (kernel tile N) | ``"binned"``
    (the pair-binned walk) | ``"pg"`` (the mask-scan walk) | ``"pg2:G"`` |
    ``"pg2:G:W"`` (G-ray groups; W has no effect on the result)."""
    tok = tok.strip()
    kt = 0
    if tok.startswith("tiled@"):
        kt = int(tok.split("@", 1)[1])
        tok = "tiled"
    if tok == "tiled":
        return False, kt
    if tok == "binned":
        return True, kt
    if tok.startswith("pg2:") or tok == "pg":
        return tok, kt
    raise ValueError(f"unknown walk token: {tok!r}")


def _pg_group(mode) -> int:
    if isinstance(mode, str) and mode.startswith("pg2:"):
        return int(mode.split(":")[1])
    return 0


def parse_walks(spec: str, n_bounces: int):
    """Comma list of walk tokens, the last one extended to deeper
    bounces -> list of (mode, kernel_tile)."""
    out = [parse_walk(t) for t in spec.split(",")]
    while len(out) < n_bounces:
        out.append(out[-1])
    return out[:n_bounces]


def default_walks(scene, n_bounces: int):
    """The default walk schedule (walks, walks_shadow) for a scene: the
    tiled walk everywhere for <= 8 superclusters, else the measured TPU
    schedule (re-tuning it for the GPU is later work)."""
    if mesh_mod.n_superclusters(scene) <= 8:
        walks = [parse_walk("tiled")] * n_bounces
        return walks, list(walks)
    walks = parse_walks("tiled@256,pg2:128:4,pg2:32:4,pg2:32:4", n_bounces)
    walks_sh = parse_walks("pg2:128:4,pg2:32:4,pg2:32:4,pg2:32:4", n_bounces)
    return walks, walks_sh


def build_hit_fns(scene, walks, walks_shadow, method: str = "walk",
                  plain: bool = False):
    """Per-bounce hit fns for the walk schedule (equal (closest, shadow,
    tile) triples share one fn).  Checks up front that every pg2 group
    divides its bounce's kernel tile.  ``method="dense"`` returns one
    dense hit fn."""
    if method != "walk":
        return mesh_mod.mesh_hit_fn(scene, method=method)
    cache = {}
    fns = []
    for (m, kt), (ms, kts) in zip(walks, walks_shadow):
        kt = kt or kts
        eff = kt or mesh_mod.default_kernel_tile(scene)
        for mode in (m, ms):
            g = _pg_group(mode)
            if g and eff % g != 0:
                raise ValueError(
                    f"pg2 group {g} does not divide kernel tile {eff} "
                    f"(walk {mode!r}); pick a tile that is a multiple "
                    f"of every pg2 group it is paired with")
        key = (m, ms, kt)
        if key not in cache:
            cache[key] = mesh_mod.mesh_hit_fn(
                scene, method=method, binned=m, binned_anyhit=ms,
                kernel_tile=kt, plain=plain)
        fns.append(cache[key])
    return fns


@dataclasses.dataclass
class RenderPlan:
    """A full-frame render plan; ``render(key)`` draws the frame's
    uniforms from ``KeyStream(key)``."""

    cam: CameraConfig
    cfg: RenderConfig
    schedule: tuple
    hit_fns: object
    lights: Lights
    emitters: Optional[Emitters] = None

    def render(self, key: torch.Tensor):
        with span("srt.render"):
            n = self.cam.width * self.cam.height * self.cfg.spp
            return trace_image_compact(self.hit_fns, self.lights, self.cam,
                                       self.cfg, rng.KeyStream(key, n),
                                       self.schedule, return_stats=True,
                                       emitters=self.emitters)


def make_render_plan(scene, lights: Lights, cam: CameraConfig,
                     cfg: Optional[RenderConfig] = None,
                     key: Optional[torch.Tensor] = None,
                     walks=None, walks_shadow=None,
                     method: Optional[str] = None) -> RenderPlan:
    """Build the full-frame render plan for a mesh scene.

    Picks the walk schedule (``default_walks`` unless ``walks`` /
    ``walks_shadow`` strings override), turns on the default toggles
    (bounce re-sort, the all-specular shading shortcut, shadow-batch
    re-sort from bounce 2), and probes one frame with ``key`` (default:
    ``rng.key(0)`` on the scene's device) to discover the width
    schedule.  With ``cfg.nee`` the plan builds the scene's emitter
    tables (``scene_emitters``) and hands them to the probe and to every
    frame."""
    with span("srt.setup.plan"):
        method = method or "walk"
        cfg = cfg or RenderConfig(max_depth=4, rr_bounces=0)
        on_walk = method == "walk"
        n_bounces = cfg.max_depth + cfg.rr_bounces
        cfg = dataclasses.replace(cfg, sort_bounces=on_walk and n_bounces > 1,
                                  uniform_use_spec=True)
        if on_walk and cfg.sort_shadows_from is None:
            cfg = dataclasses.replace(cfg, sort_shadows_from=2)
        if key is None:
            key = rng.key(0, device=scene.device)

        if on_walk:
            dw, dws = default_walks(scene, n_bounces)
            if walks is not None:
                dw = parse_walks(walks, n_bounces)
            if walks_shadow is not None:
                dws = parse_walks(walks_shadow, n_bounces)
            hit_fns = build_hit_fns(scene, dw, dws, method=method)
        else:
            hit_fns = build_hit_fns(scene, None, None, method=method)
        emitters = scene_emitters(scene) if cfg.nee else None
        schedule = discover_schedule(hit_fns, lights, cam, cfg, key,
                                     emitters=emitters)
        return RenderPlan(cam=cam, cfg=cfg, schedule=schedule, hit_fns=hit_fns,
                          lights=lights, emitters=emitters)
