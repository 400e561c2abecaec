"""Where the frame time goes, stage by stage, on the Rubik grid
(``tools/profile_breakdown.py``'s counterpart): the closest hit (full hit
record), the any hit (shadow), the raw walk (B1 + B2, no refine), B1
alone, the integrator with a stub hit function (no walk), and the full
frame with its per-bounce [rays traced, shadow queries].

Run as ``python3 -m srt_tpu_torch.tools.profile_breakdown [--device DEV]
[--size N] [--tile T] [--reps R]`` (``SRT_BENCH_SIZE``, default 512;
``SRT_KERNEL_TILE``, default 512).  The scene is ``procgen.rubik_grid()``
(JAX's tool loads the reference's Rubik OBJ, which the repository does
not hold).
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
                                      unpermute_image)
from srt_tpu_torch.scene import Materials, model_scene_lights
from srt_tpu_torch.tools import common


def stub_hit(o, d, t_min, t_max, any_hit=False, cone=None):
    """Every ray hits at t = 5 facing back along itself, with one fixed
    material: the integrator's own cost, no walk."""
    nr = o.shape[1]
    t = torch.full((nr,), 5.0, device=o.device)
    p = o + t[None, :] * d
    zeros = torch.zeros_like(p)
    mat = Materials(albedo=zeros + 0.5, specular=zeros + 0.04,
                    roughness=torch.full((nr,), 0.5, device=o.device),
                    metalness=torch.full((nr,), 0.1, device=o.device),
                    use_spec=torch.ones((nr,), dtype=torch.bool,
                                        device=o.device))
    return pathtracer.Hit(hit=torch.ones((nr,), dtype=torch.bool,
                                         device=o.device),
                          t=t, p=p, normal=-d, mat=mat)


def run(device=None, scene=None, size: int = 512, tile: int = 512,
        reps: int = 10, verbose: bool = True):
    """Records: ``case`` "closest", "any", "raw", "cull", "stub" (``ms``,
    and ``mrays_s`` for the first three) and "full" (``ms``, ``stats``,
    ``rays``, ``mrays_s``)."""
    dev = resolve(device)
    card = common.header("profile_breakdown", dev, verbose)
    scene = scene if scene is not None else common.rubik_scene(dev)
    lights = model_scene_lights(dev)
    cam = common.camera(size, common.RUBIK_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    hit_fn = mesh.mesh_hit_fn(scene, method="walk")
    n = size * size
    vp = derive_viewport(cam, device=dev)
    stream = rng.KeyStream(rng.key(0, dev), n)
    origins, dirs = generate_rays(vp, size, size, stream.take(2))
    inf = torch.full((n,), float("inf"), device=dev)
    records = []

    def report(case, label, fn, rays=None, **extra):
        dt = common.wall_s(fn, dev=dev, reps=reps)
        rec = dict(case=case, ms=dt * 1e3, device=card, **extra)
        tail = ""
        if rays:
            rec["mrays_s"] = rays / dt / 1e6
            tail = f" ({rec['mrays_s']:7.1f} Mrays/s)"
        records.append(rec)
        if verbose:
            print(f"{label:32s} {dt * 1e3:9.3f} ms{tail}", flush=True)
        return rec

    report("closest", "closest-hit (full Hit record):",
           lambda: hit_fn(origins, dirs, 1e-3, inf), n)
    report("any", "any-hit (shadow):",
           lambda: hit_fn(origins, dirs, 1e-3, torch.full((n,), 30.0,
                                                          device=dev),
                          any_hit=True), n)
    report("raw", "raw walk (B1 + B2):",
           lambda: traversal.model_hit(scene, 0, origins, dirs, inf,
                                       tile=tile, refine=False), n)
    rays8 = traversal.pack_rays(scene, 0, origins, dirs, float("inf"),
                                tile)[0]
    sbounds = traversal.model_tables(scene, 0)[2]
    report("cull", f"B1 cull alone ({sbounds.shape[1]} supers):",
           lambda: traversal.cull(rays8, sbounds, tile))

    def run_stub(key):
        s = rng.KeyStream(key, n)
        s.take(2)
        return pathtracer.trace_wavefront(stub_hit, lights, origins, dirs, s,
                                          cfg)
    report("stub", "integrator w/ stub hit fn:",
           lambda: run_stub(rng.key(1, dev)))

    perm, inv = morton_perm(size, size)

    def full(key):
        s = rng.KeyStream(key, n)
        o, d = generate_rays(vp, size, size, s.take(2))
        idx = torch.as_tensor(perm, device=dev).long()
        c, st = pathtracer.trace_wavefront(
            hit_fn, lights, o[:, idx], d[:, idx], PermutedStream(s, perm),
            cfg, return_stats=True)
        return unpermute_image(c, inv), st

    full(rng.key(2, dev))
    stats = full(rng.key(3, dev))[1].cpu()
    rays = int(stats.sum())
    rec = report("full", "full frame:", lambda: full(rng.key(3, dev)),
                 stats=stats.tolist())
    rec["rays"] = rays
    rec["mrays_s"] = rays / rec["ms"] * 1e-3
    if verbose:
        print(f"per-bounce [alive, active]:\n{stats.tolist()}\nuseful rays "
              f"{rays}  -> {rec['mrays_s']:.2f} Mrays/s", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--size", type=int,
                    default=common.env_int("SRT_BENCH_SIZE", 512))
    ap.add_argument("--tile", type=int,
                    default=common.env_int("SRT_KERNEL_TILE", 512))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.cli_device("profile_breakdown", args.device)
    if dev is None:
        return 2
    run(dev, None, args.size, args.tile, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
