"""``torch.profiler`` trace of one headline frame through the library's
fast path, the composition ``bench`` times (``tools/profile_fastpath.py``'s
counterpart): ``make_render_plan`` on the headline mesh, the frame's wall
time over ``reps`` frames, then one frame under the profiler and its top
device operations.

Run as ``python3 -m srt_tpu_torch.tools.profile_fastpath [--device DEV]
[--rows R] [--cols C] [--size N] [--reps R] [--walks W]
[--walks-shadow W] [--shadow-sort-from B|none] [--trace-dir DIR]
[--top K]``
(``SRT_BENCH_WALKS``, ``SRT_BENCH_WALKS_SHADOW``,
``SRT_SHADOW_SORT_FROM`` and ``SRT_REPS`` as in JAX's tool).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from srt_tpu_torch.config import RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models.fastpath import make_render_plan
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common, parse_trace


def run(device=None, scene=None, rows: int = 160, cols: int = 320,
        size: int = 1024, reps: int = 5, walks=None, walks_shadow=None,
        shadow_sort_from="default", trace_dir=None, top: int = 40,
        verbose: bool = True):
    """Returns one record: ``ms_min`` and ``ms_mean`` (frame wall over
    ``reps`` frames), ``schedule``, ``device_ms`` (the traced frame's
    device operations; None on the CPU), ``events``, ``top``, ``trace``.
    ``shadow_sort_from``: "default" keeps the plan's, None or a bounce
    index overrides it."""
    dev = resolve(device)
    card = common.header("profile_fastpath", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    cam = common.camera(size, common.HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    if shadow_sort_from != "default":
        cfg = dataclasses.replace(cfg, sort_shadows_from=shadow_sort_from)
    plan = make_render_plan(scene, model_scene_lights(dev), cam, cfg,
                            walks=walks, walks_shadow=walks_shadow)
    plan.render(rng.key(0, dev))
    common.sync(dev)
    walls = []
    for i in range(reps):
        t0 = time.perf_counter()
        plan.render(rng.key(i + 1, dev))
        common.sync(dev)
        walls.append(time.perf_counter() - t0)
    summary, path = common.profiled(lambda: plan.render(rng.key(2, dev)),
                                    dev, trace_dir, top)
    rec = dict(ms_min=min(walls) * 1e3, ms_mean=sum(walls) / reps * 1e3,
               schedule=list(plan.schedule), device_ms=summary["total_ms"],
               events=summary["events"], top=summary["top"], trace=path,
               device=card)
    if verbose:
        print(f"frame wall: {rec['ms_min']:.3f} ms (min of {reps}; mean "
              f"{rec['ms_mean']:.3f}); schedule {rec['schedule']}; trace "
              f"{path}", flush=True)
        parse_trace.print_summary(summary)
    return [rec]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_headline(ap, reps=common.env_int("SRT_REPS", 5))
    ap.add_argument("--walks", default=os.environ.get("SRT_BENCH_WALKS"))
    ap.add_argument("--walks-shadow",
                    default=os.environ.get("SRT_BENCH_WALKS_SHADOW"))
    ap.add_argument("--shadow-sort-from",
                    default=os.environ.get("SRT_SHADOW_SORT_FROM"))
    ap.add_argument("--trace-dir")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    dev = common.cli_device("profile_fastpath", args.device)
    if dev is None:
        return 2
    ssf = args.shadow_sort_from
    ssf = ("default" if ssf is None else None if ssf == "none"
           else int(ssf))
    run(dev, None, args.rows, args.cols, args.size, args.reps, args.walks,
        args.walks_shadow, ssf, args.trace_dir, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
