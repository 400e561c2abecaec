"""Headline benchmark of the port (``bench.py``'s counterpart): forward
Mrays/s at 4-bounce path tracing on the high-poly mesh scene.

Run as ``python3 -m srt_tpu_torch.bench [--device DEV]`` (default: the
card; ``--device cpu`` runs the kernels' plain versions).  Prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline"}.

A thin caller of the library's own fast path
(``srt_tpu_torch.models.fastpath.make_render_plan``): the walk schedule,
the width-compacted wavefront and the toggles are library defaults, so
the number is what any user of the public API gets.  Environment overrides, for
experiments only: SRT_BENCH_WALKS / SRT_BENCH_WALKS_SHADOW (comma lists
of walk tokens), SRT_BENCH_METHOD (``walk``, ``dense``; default the
plan's), SRT_BENCH_SIZE / ROWS / COLS / SPP / REPS.

Rays are counted honestly: the per-bounce traced and shadow counts of
the plan's ``stats`` (closest-hit rays plus shadow queries of one frame),
not the padded wavefront width.  Every rep ends in
``torch.cuda.synchronize()``; the overflow check is outside the timed
window.  Scene: ``uv_sphere(160, 320, radius=2.0)`` (101,760 triangles),
the stand-in for the reference's Airplane OBJ that the JAX package's
bench also renders.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh
from srt_tpu_torch.models.fastpath import make_render_plan
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.utils.flatten import flatten_models
from srt_tpu_torch.utils.procgen import uv_sphere

BASELINE_MRAYS = 100.0  # target Mrays/s (BASELINE.md)


def run(device=None):
    """Build the plan, render one untimed frame and ``SRT_BENCH_REPS``
    timed ones (keys 1..reps).  Returns (the JSON record, the plan, the
    rays of the last frame that the rate divides by)."""
    dev = resolve(device)
    rows = int(os.environ.get("SRT_BENCH_ROWS", "160"))
    cols = int(os.environ.get("SRT_BENCH_COLS", "320"))
    mesh_data = uv_sphere(rows, cols, radius=2.0)   # 160x320 ~= 102k tris

    method = os.environ.get("SRT_BENCH_METHOD", "auto")
    if method == "auto":
        method = None  # let the plan pick (the walk)

    scene = mesh.upload(flatten_models([mesh_data], pad_to=128), dev)
    size = int(os.environ.get("SRT_BENCH_SIZE", "1024"))
    spp = int(os.environ.get("SRT_BENCH_SPP", "1"))
    cam = CameraConfig(width=size, height=size, origin=(0.0, 1.0, 5.0),
                       look_at=(0.0, 0.0, 0.0))
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=spp)
    plan = make_render_plan(
        scene, model_scene_lights(dev), cam, cfg,
        walks=os.environ.get("SRT_BENCH_WALKS"),
        walks_shadow=os.environ.get("SRT_BENCH_WALKS_SHADOW"),
        method=method)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    plan.render(rng.key(0, dev))
    sync()
    reps = int(os.environ.get("SRT_BENCH_REPS", "10"))
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        _, stats, overflow = plan.render(rng.key(i + 1, dev))
        sync()
        times.append(time.perf_counter() - t0)
        # Outside the timed window: an under-provisioned schedule must not
        # contribute even one cheaper path-dropping frame.
        if int(overflow) != 0:
            raise RuntimeError(f"compact schedule overflowed at rep {i}: "
                               f"frame dropped live paths")
    dt = sum(times) / reps
    rays = int(stats.sum())  # closest-hit + shadow rays, 1 frame
    mrays = rays / dt / 1e6
    record = {
        "metric": f"fwd Mrays/s/chip, 4-bounce path tracing, "
                  f"{mesh_data.num_triangles}-tri BVH scene "
                  f"({size}x{size}, spp={spp}, library fastpath)",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
    }
    return record, plan, rays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="default: the card")
    args = ap.parse_args(argv)
    try:
        dev = resolve(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    record, _, _ = run(dev)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
