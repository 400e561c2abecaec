"""The bench frame's components on the Rubik grid at 512x512
(``tools/profile_bench.py``'s counterpart): the full frame, the uniform
draw, ray generation, four closest + shadow hit calls and four closest
calls with a trivial update between them (no shading), one closest hit
through the hit function, one walk call (``traversal.model_hit``), the
tiled walk's cull (B1, ``traversal.cull``, where JAX's tool still imports
the ``_launch_occupancy`` that its package no longer defines) and the
bounce loop with a stub hit function.

Run as ``python3 -m srt_tpu_torch.tools.profile_bench [--device DEV]
[--size N] [--reps R]``.  The scene is ``procgen.rubik_grid()`` (JAX's
tool loads the reference's Rubik OBJ, which the repository does not
hold).
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
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common
from srt_tpu_torch.tools.profile_breakdown import stub_hit


def run(device=None, scene=None, size: int = 512, reps: int = 10,
        verbose: bool = True):
    """One record a component: ``case``, ``what``, ``ms``."""
    dev = resolve(device)
    card = common.header("profile_bench", dev, verbose)
    scene = scene if scene is not None else common.rubik_scene(dev)
    lights = model_scene_lights(dev)
    cam = common.camera(size, common.RUBIK_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    hit_fn = mesh.mesh_hit_fn(scene, method="walk")
    n = size * size
    vp = derive_viewport(cam, device=dev)
    key = rng.key(0, dev)
    d_slots = rng.bounce_slots(lights.count)
    records = []

    def full(key):
        s = rng.KeyStream(key, n)
        o, d = generate_rays(vp, size, size, s.take(2))
        return pathtracer.trace_wavefront(hit_fn, lights, o, d, s, cfg)

    def rng_only(key):
        return rng.KeyStream(key, n).take(4 * d_slots + 2)

    def raygen(key):
        return generate_rays(vp, size, size, rng.KeyStream(key, n).take(2))

    origins, dirs = raygen(key)
    tmax = torch.full((n,), float("inf"), device=dev)

    def loop4(shadow):
        t_acc = torch.zeros((n,), device=dev)
        o, d = origins, dirs
        for _ in range(4):
            rec = hit_fn(o, d, 1e-3, tmax)
            if shadow:
                hit_fn(rec.p, -d, 1e-3, torch.where(rec.hit, 10.0, 0.0),
                       any_hit=True)
            t_acc = t_acc + torch.where(rec.hit, rec.t, 0.0)
            o = torch.where(rec.hit[None, :], rec.p, o)
            d = torch.where(rec.hit[None, :], -d, d)
        return t_acc

    rays8 = traversal.pack_rays(scene, 0, origins, dirs, tmax,
                                traversal.DEFAULT_TILE)[0]
    sbounds = traversal.model_tables(scene, 0)[2]

    def shade_only(key):
        s = rng.KeyStream(key, n)
        o, d = generate_rays(vp, size, size, s.take(2))
        return pathtracer.trace_wavefront(stub_hit, lights, o, d, s, cfg)

    for case, what, fn in (
            ("full", "full frame", lambda: full(key)),
            ("rng", f"rng draw ({4 * d_slots + 2} slots)",
             lambda: rng_only(key)),
            ("raygen", "raygen", lambda: raygen(key)),
            ("hit_shadow4", "hit+shadow x4 (no shading)",
             lambda: loop4(True)),
            ("closest4", "closest-hit x4 (no shading)",
             lambda: loop4(False)),
            ("closest", "single closest-hit (full wrapper)",
             lambda: hit_fn(origins, dirs, 1e-3, tmax)),
            ("walk", "single walk call (model_hit)",
             lambda: traversal.model_hit(scene, 0, origins, dirs, tmax)),
            ("cull", "B1 cull only",
             lambda: traversal.cull(rays8, sbounds, traversal.DEFAULT_TILE)),
            ("stub", "bounce loop, stub hit (shading only)",
             lambda: shade_only(key))):
        dt = common.wall_s(fn, dev=dev, reps=reps)
        records.append(dict(case=case, what=what, ms=dt * 1e3, device=card))
        if verbose:
            print(f"{what:40s} {dt * 1e3:9.3f} ms", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.cli_device("profile_bench", args.device)
    if dev is None:
        return 2
    run(dev, None, args.size, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
