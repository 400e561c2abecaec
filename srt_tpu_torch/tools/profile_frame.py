"""Bisect the Rubik grid's frame time (``tools/profile_frame.py``'s
counterpart): a depth sweep (1, 2, 4), depth 4 without shadow rays (the
occlusion test stubbed to "unoccluded"), depth 4 on pre-drawn uniforms
(``rng.ArrayStream``) and the hit calls alone: four rounds of closest hit
plus a shadow ray toward (0, 10, 0).

Run as ``python3 -m srt_tpu_torch.tools.profile_frame [--device DEV]
[--size N] [--reps R]``.  The scene is ``procgen.rubik_grid()`` (JAX's
tool loads the reference's Rubik OBJ, which the repository does not
hold).  JAX's no-shadow stub sizes its answer by the rays' first axis,
which is 3 on [3, N] points; the port's answers one value a ray.
"""

from __future__ import annotations

import argparse
import sys

import torch

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common


def run(device=None, scene=None, size: int = 512, reps: int = 5,
        verbose: bool = True):
    """One record a variant: ``case`` ("depth" with ``depth``,
    "no_shadow", "array_stream", "hits_only") and ``ms``."""
    dev = resolve(device)
    card = common.header("profile_frame", dev, verbose)
    scene = scene if scene is not None else common.rubik_scene(dev)
    lights = model_scene_lights(dev)
    cam = common.camera(size, common.RUBIK_CAMERA)
    hit_fn = mesh.mesh_hit_fn(scene, method="walk")
    n = size * size
    vp = derive_viewport(cam, device=dev)
    key = rng.key(0, dev)
    records = []

    def frame(stream, cfg):
        o, d = generate_rays(vp, size, size, stream.take(2))
        return pathtracer.trace_wavefront(hit_fn, lights, o, d, stream, cfg)

    def report(case, label, fn, **extra):
        dt = common.wall_s(fn, dev=dev, reps=reps)
        records.append(dict(case=case, ms=dt * 1e3, device=card, **extra))
        if verbose:
            print(f"{label:30s} {dt * 1e3:9.3f} ms", flush=True)

    for depth in (1, 2, 4):
        cfg = RenderConfig(max_depth=depth, rr_bounces=0, spp=1)
        report("depth", f"frame depth={depth}:",
               lambda c=cfg: frame(rng.KeyStream(key, n), c), depth=depth)
    cfg4 = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    with common.no_shadow_rays():
        report("no_shadow", "frame depth=4 no-shadow:",
               lambda: frame(rng.KeyStream(key, n), cfg4))
    u = torch.as_tensor(rng.host_uniforms(0, n, rng.total_slots(
        lights.count, 4)), device=dev)
    report("array_stream", "frame depth=4 ArrayStream:",
           lambda: frame(rng.ArrayStream(u), cfg4))

    light = torch.tensor([[0.0], [10.0], [0.0]], device=dev)

    def hits_only():
        s = rng.KeyStream(key, n)
        o, d = generate_rays(vp, size, size, s.take(2))
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        for _ in range(4):
            rec = hit_fn(o, d, 1e-3, torch.where(alive, float("inf"), 0.0))
            occ = pathtracer._occluded(hit_fn, rec.p, light, 1e-3,
                                       alive & rec.hit)
            alive = alive & rec.hit & ~occ
            o, d = rec.p, torch.where(alive[None, :], rec.normal, d)
        return o

    report("hits_only", "4x(closest+shadow):", hits_only)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = common.cli_device("profile_frame", args.device)
    if dev is None:
        return 2
    run(dev, None, args.size, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
