"""Dead lanes of the scan integrator, on config3's Rubik grid at 512x512
(``tools/profile_scan.py``'s counterpart).

JAX's tool asked whether ``lax.scan`` costs more than the same bounce loop
unrolled.  Eager PyTorch has no scan to set against an unrolled loop: the
port's scan integrator (``pathtracer.render``) is already a Python loop.
What the question was after is the cost of tracing every bounce at full
width, dead rays included.  So this tool times, on the same key:

* the scan integrator with config3's settings (every bounce at full
  width, dead rays traced with t_max = 0, no bounce sort);
* the same with the bounce sort (live rays first, as the compact driver
  orders them);
* the compact driver (``wavefront_compact.trace_image_compact``) on the
  widths its probe frame discovers (``discover_schedule``), same
  settings: each bounce traces only its live prefix.

For each it prints the frame's wall ms and the device ms of B2's launches
(``intersect``, CUDA events around each launch inside the frame; not
measured on the CPU) with their count.  The gap in B2 ms between the
sorted scan and the compact driver is what dead lanes cost the walk.

Run as ``python3 -m srt_tpu_torch.tools.profile_scan [--device DEV]
[--size N] [--reps R]``.  The scene is ``procgen.rubik_grid()`` (one
super: no B1 launch).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from srt_tpu_torch.config import RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.models.wavefront_compact import (discover_schedule,
                                                    trace_image_compact)
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common

WALK_KERNELS = ("cull", "intersect")


def run(device=None, scene=None, size: int = 512, reps: int = 10,
        verbose: bool = True):
    """One record a route (``case`` "scan", "scan_sorted", "compact"):
    ``ms`` (the frame's wall), ``b2_ms`` and ``b2_launches`` (B2's device
    ms and launches in one frame; ``b2_ms`` None on the CPU), ``b1_ms``,
    ``schedule`` (the compact route's widths)."""
    dev = resolve(device)
    card = common.header("profile_scan", dev, verbose)
    scene = scene if scene is not None else common.rubik_scene(dev)
    lights = model_scene_lights(dev)
    cam = common.camera(size, common.RUBIK_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    hit_fn = mesh.mesh_hit_fn(scene, method="walk", ray_tile=8192)
    key = rng.key(0, dev)
    n = size * size
    schedule = discover_schedule(hit_fn, lights, cam, cfg, key)
    sorted_cfg = dataclasses.replace(cfg, sort_bounces=True)
    routes = (
        ("scan", "scan, config3 (full width)", (n,) * 4,
         lambda: pathtracer.render(hit_fn, lights, cam, cfg, key)),
        ("scan_sorted", "scan, bounce-sorted", (n,) * 4,
         lambda: pathtracer.render(hit_fn, lights, cam, sorted_cfg, key)),
        ("compact", "compact driver", schedule,
         lambda: trace_image_compact(hit_fn, lights, cam, cfg,
                                     rng.KeyStream(key, n), schedule)),
    )
    records = []
    for case, label, widths, frame in routes:
        dt = common.wall_s(frame, dev=dev, reps=reps)
        with common.kernel_times(dev, WALK_KERNELS) as kt:
            frame()
        rec = dict(case=case, ms=dt * 1e3, b2_ms=kt.ms("intersect"),
                   b2_launches=kt.count("intersect"), b1_ms=kt.ms("cull"),
                   schedule=list(widths), device=card)
        records.append(rec)
        if verbose:
            b2 = ("not measured" if rec["b2_ms"] is None
                  else f"{rec['b2_ms']:8.3f} ms")
            print(f"{label:28s} {dt * 1e3:9.3f} ms a frame; B2 {b2} in "
                  f"{rec['b2_launches']} launches; widths {list(widths)}",
                  flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.cli_device("profile_scan", args.device)
    if dev is None:
        return 2
    run(dev, None, args.size, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
