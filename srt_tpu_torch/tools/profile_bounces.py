"""Per-bounce cost of the headline frame through the scan integrator
(``tools/profile_bounces.py``'s counterpart): the marginal wall time of
each bounce (a depth sweep from 1 to 4), the shadow pass's share (the
occlusion test stubbed to "unoccluded"), the frame without the bounce
sort, and the raw walk on the primaries at tiles 128 and 256.

Run as ``python3 -m srt_tpu_torch.tools.profile_bounces [--device DEV]
[--rows R] [--cols C] [--size N] [--reps R]``.  Each frame is JAX's
``frame``: jittered Morton-ordered primaries from ``rng.KeyStream(key
0)`` through ``pathtracer.trace_wavefront`` (every bounce at full width)
with the walk, and its per-bounce (rays traced, shadow queries) stats.
"""

from __future__ import annotations

import argparse
import sys

import torch

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.ops import rng, traversal
from srt_tpu_torch.ops.morton import (PermutedStream, morton_perm,
                                      permute_rays)
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common


def make_frame(scene, size: int, method: str = "walk"):
    """JAX's ``frame(key, cfg)``: returns (radiance [3, N], stats [B, 2])
    of one Morton-ordered frame drawn from ``key``."""
    dev = scene.device
    cam = common.camera(size, common.HEADLINE_CAMERA)
    lights = model_scene_lights(dev)
    hit_fn = mesh.mesh_hit_fn(scene, method=method)
    vp = derive_viewport(cam, device=dev)
    perm, _ = morton_perm(size, size)
    n = size * size

    def frame(key, cfg):
        s = rng.KeyStream(key, n)
        o, d = generate_rays(vp, size, size, s.take(2))
        o, d = permute_rays(o, d, perm)
        return pathtracer.trace_wavefront(hit_fn, lights, o, d,
                                          PermutedStream(s, perm), cfg,
                                          return_stats=True)
    return frame


def run(device=None, scene=None, rows: int = 160, cols: int = 320,
        size: int = 1024, reps: int = 5, method: str = "walk",
        verbose: bool = True):
    """Records: ``case`` "depth" (``depth``, ``ms``, ``marginal_ms``,
    ``stats``), "no_shadow" (``ms``, ``shadow_ms``), "no_sort" (``ms``),
    "raw" (``tile``, ``ms``, ``mrays_s``) and "total" (``rays``).
    ``method`` is the hit function's (``"walk"``; ``"dense"`` for
    comparisons only)."""
    dev = resolve(device)
    card = common.header("profile_bounces", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    n = size * size
    if verbose:
        print(f"scene: {scene.model_tri_count[0]} tris, {size}x{size} "
              f"({n / 1e6:.2f} Mray wavefront)", flush=True)
    frame = make_frame(scene, size, method)
    key = rng.key(0, dev)
    records = []

    def timed(cfg):
        return common.wall_s(lambda: frame(key, cfg), dev=dev, reps=reps)

    prev, stats4 = 0.0, None
    for depth in (1, 2, 3, 4):
        cfg = RenderConfig(max_depth=depth, rr_bounces=0, spp=1,
                           sort_bounces=True)
        dt = timed(cfg)
        stats = frame(key, cfg)[1].cpu().tolist()
        stats4 = stats
        records.append(dict(case="depth", depth=depth, ms=dt * 1e3,
                            marginal_ms=(dt - prev) * 1e3, stats=stats,
                            device=card))
        if verbose:
            print(f"depth={depth}: {dt * 1e3:9.3f} ms  (marginal bounce "
                  f"{depth}: {(dt - prev) * 1e3:8.3f} ms)  per-bounce rays "
                  f"(trace, shadow): {stats}", flush=True)
        prev = dt

    cfg4 = RenderConfig(max_depth=4, rr_bounces=0, spp=1, sort_bounces=True)
    with common.no_shadow_rays():
        dt_ns = timed(cfg4)
    records.append(dict(case="no_shadow", ms=dt_ns * 1e3,
                        shadow_ms=(prev - dt_ns) * 1e3, device=card))
    if verbose:
        print(f"depth=4, NO shadow rays: {dt_ns * 1e3:9.3f} ms (shadow pass "
              f"= {(prev - dt_ns) * 1e3:8.3f} ms)", flush=True)

    dt = timed(RenderConfig(max_depth=4, rr_bounces=0, spp=1,
                            sort_bounces=False))
    records.append(dict(case="no_sort", ms=dt * 1e3, device=card))
    if verbose:
        print(f"depth=4, NO bounce sort: {dt * 1e3:9.3f} ms", flush=True)

    cam = common.camera(size, common.HEADLINE_CAMERA)
    jitter = rng.KeyStream(key, n).take(2)
    o, d = generate_rays(derive_viewport(cam, device=dev), size, size, jitter)
    o, d = permute_rays(o, d, morton_perm(size, size)[0])
    inf = torch.full((n,), float("inf"), device=dev)
    for tile in (128, 256):
        dt = common.wall_s(lambda t=tile: traversal.model_hit(
            scene, 0, o, d, inf, tile=t, refine=False), dev=dev, reps=reps)
        records.append(dict(case="raw", tile=tile, ms=dt * 1e3,
                            mrays_s=n / dt / 1e6, device=card))
        if verbose:
            print(f"raw walk, primary rays, tile={tile}: {dt * 1e3:9.3f} ms "
                  f"({n / dt / 1e6:7.1f} Mrays/s)", flush=True)
    total = int(sum(sum(r) for r in stats4))
    records.append(dict(case="total", rays=total, device=card))
    if verbose:
        print(f"total rays/frame (depth 4): {total / 1e6:.4f} M", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_headline(ap, reps=5)
    args = ap.parse_args(argv)
    dev = common.cli_device("profile_bounces", args.device)
    if dev is None:
        return 2
    run(dev, None, args.rows, args.cols, args.size, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
