"""The real per-bounce wavefronts of a headline frame: the rays that enter
each bounce, captured by stepping ``pathtracer.bounce_step`` from the host
(the loop that JAX's ``eval_counts.py:70-91`` and ``micro_bounce_real.py``,
``micro_pg2_split.py``, ``micro_pgwalk.py`` and ``micro_footprint.py``
each copy).

Morton-ordered primaries, each bounce's uniform block gathered by the
rays' pixel ids (JAX's ``u_all[b].T[carry[5]].T``) and
``bounce_step(sort=True)``, so live rays come first, as the compact
driver feeds the walks.  Run as ``python3 -m
srt_tpu_torch.tools.wavefronts [--device DEV] [--rows R] [--cols C]
[--size N]``: prints each bounce's live rays.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.ops import rng
from srt_tpu_torch.ops.morton import morton_perm, permute_rays
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common


@dataclasses.dataclass
class Wavefronts:
    """``work[b]`` = (origins [3, N], dirs [3, N], alive [N]) of the rays
    entering bounce b + 1 (live first from bounce 2 on); ``pix[b]`` their
    sample ids."""

    work: list
    pix: list


def capture(hit_fn, lights, cam, cfg: RenderConfig, stream) -> Wavefronts:
    """The rays entering each of the frame's ``max_depth + rr_bounces``
    bounces.  ``stream`` gives the jitter (2 slots) and then every
    bounce's slots in one block, as JAX's loop draws them
    (``rng.KeyStream`` or ``rng.ArrayStream``); ``cfg.spp`` samples a
    pixel are adjacent."""
    spp = cfg.spp
    n = cam.width * cam.height * spp
    jitter = stream.take(2)
    o, d = generate_rays(derive_viewport(cam, device=jitter.device),
                         cam.width, cam.height, jitter)
    perm, _ = morton_perm(cam.height, cam.width)
    if spp > 1:
        perm = (perm[:, None] * spp
                + np.arange(spp, dtype=perm.dtype)[None, :]).reshape(-1)
    o, d = permute_rays(o, d, perm)
    n_b = cfg.max_depth + cfg.rr_bounces
    d_slots = rng.bounce_slots(lights.count)
    u_all = stream.take(n_b * d_slots).reshape(n_b, d_slots, n)
    dev = o.device
    pix = torch.as_tensor(perm, device=dev).long()
    carry = pathtracer.initial_carry(o, d, cfg, False, pix=pix)
    work = [(o, d, torch.ones((n,), dtype=torch.bool, device=dev))]
    pixes = [pix]
    for b in range(n_b - 1):
        carry, _ = pathtracer.bounce_step(hit_fn, lights, cfg, carry, b,
                                          u_all[b][:, carry[5]], sort=True)
        work.append((carry[0], carry[1], carry[4]))
        pixes.append(carry[5])
    return Wavefronts(work=work, pix=pixes)


def headline(scene, size: int, spp: int = 1, depth: int = 4,
             uniform_use_spec: bool = False, key: int = 0) -> Wavefronts:
    """The headline frame's wavefronts on ``scene`` through the walk
    (JAX's tools' ``RenderConfig(max_depth=4, rr_bounces=0,
    sort_bounces=True)`` and key 0)."""
    dev = scene.device
    cam = common.camera(size, common.HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=depth, rr_bounces=0, spp=spp,
                       sort_bounces=True, uniform_use_spec=uniform_use_spec)
    n = size * size * spp
    return capture(mesh.mesh_hit_fn(scene, method="walk"),
                   model_scene_lights(dev), cam, cfg,
                   rng.KeyStream(rng.key(key, dev), n))


def run(device=None, scene=None, rows: int = 160, cols: int = 320,
        size: int = 1024, depth: int = 4, verbose: bool = True):
    """Capture the headline's wavefronts; one record a bounce: ``bounce``,
    ``live``, ``width``, ``seconds`` (the capture's, whole)."""
    dev = resolve(device)
    card = common.header("wavefronts", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    t0 = time.perf_counter()
    waves = headline(scene, size, depth=depth)
    common.sync(dev)
    secs = time.perf_counter() - t0
    records = []
    for b, (o, _, alive) in enumerate(waves.work):
        rec = dict(bounce=b + 1, live=int(alive.sum()), width=o.shape[1],
                   seconds=secs, device=card)
        records.append(rec)
        if verbose:
            print(f"bounce {b + 1}: {rec['live']} live of {rec['width']}",
                  flush=True)
    if verbose:
        print(f"capture: {secs:.4f} s", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_headline(ap, reps=1)
    args = ap.parse_args(argv)
    dev = common.cli_device("wavefronts", args.device)
    if dev is None:
        return 2
    run(dev, None, args.rows, args.cols, args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
