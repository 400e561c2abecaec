#!/usr/bin/env python3
"""Time B4/B4s (``srt_tpu_torch/csrc/pgwalk2.cu``) under several launch
shapes on one NVIDIA GPU.

Usage: ``python3 sweep_pgwalk2.py`` from the repository root.  It records
every B4 call of one headline frame and every B4s call of one config8
frame (``chip_smoke.py``'s scenes, cameras and default walks), adds the
65,536-ray bounce cases of ``chip_smoke.py`` phase 3 at G = 128 and 32,
then times each call (CUDA events, median of 7) under each launch shape:
threads per ray (``traversal.PGWALK2_LANES``) times the fill target that
picks the split P (``traversal.PGWALK2_FILL``) times the most blocks a
group may take (``traversal.PGWALK2_MAX_PARTS``).  Every shape's output must
equal the plain version's.  Prints one line per call and shape, and the
per-frame sums by shape; the shape the wrapper uses is marked.
"""

from __future__ import annotations

import itertools
import sys

import chip_smoke as cs

LANES = (2, 4, 8)
FILLS = (4 * 2048, 8 * 2048, 16 * 2048, 32 * 2048, 64 * 2048)
MAX_PARTS = (64, 128)


def record(plan, key):
    import torch
    with cs.recorded_launches() as calls:
        plan.render(key)
    torch.cuda.synchronize()
    return [(name, args) for name, args, _ in calls
            if name.startswith("pgwalk2")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_pgwalk2: no CUDA device", file=sys.stderr)
        return 2
    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.scene import model_scene_lights

    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    calls = {}
    for label, sphere, size, depth in (
            ("headline", cs.HEADLINE_SPHERE, cs.HEADLINE_SIZE, 4),
            ("config8", cs.CONFIG8_SPHERE, cs.CONFIG8_SIZE, 2)):
        scene, _ = cs.build_scene(dev, *sphere)
        cam = CameraConfig(width=size, height=size, **cs.HEADLINE_CAMERA)
        plan = make_render_plan(scene, model_scene_lights(dev), cam,
                                RenderConfig(max_depth=depth, rr_bounces=0,
                                             spp=1))
        calls[label] = record(plan, rng.key(0, dev))
        if label == "headline":
            woop, _, sbounds, cb8, s_count, _ = tr.model_tables(scene, 0)
            _, bounce8, _ = cs.walk_rays(scene)
            calls["65536-ray cases"] = [
                ("pgwalk2", dict(zip(
                    ("clist", "bits", "counts"),
                    tr.cull_pg2(bounce8, cb8, s_count, g, sbounds)),
                    rays8=bounce8, woop=woop, group=g, any_hit=False))
                for g in (128, 32)]
    default = (tr.PGWALK2_LANES, tr.PGWALK2_FILL, tr.PGWALK2_MAX_PARTS)
    sums = {}
    for label, recorded in calls.items():
        for k, (name, args) in enumerate(recorded):
            fn = getattr(tr, name)
            args = {a: args[a] for a in ("clist", "bits", "counts", "rays8",
                                         "woop", "group", "any_hit")}
            ref = fn(**args, plain=True)
            rays8 = args["rays8"]
            head = (f"{label} call {k}: {rays8.shape[0]} rays "
                    f"({int((rays8[:, 6] > 0).sum())} live), "
                    f"G={args['group']}, "
                    f"{cs.listed_clusters(args['clist'], args['bits'], args['counts'])}"
                    f" listed")
            for shape in itertools.product(LANES, FILLS, MAX_PARTS):
                tr.PGWALK2_LANES, tr.PGWALK2_FILL, tr.PGWALK2_MAX_PARTS = shape
                _, threads, parts = cs.pgwalk2_split(rays8, args["clist"],
                                                     args["group"])
                ms, out = cs.timed_median(lambda: fn(**args), reps=7)
                cs.check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                         f"{head}: shape {shape} differs from the plain "
                         f"version")
                sums[(label, shape)] = sums.get((label, shape), 0.0) + ms
                mark = " (default)" if shape == default else ""
                print(f"{head}: lanes, fill, max parts {shape}: {threads} "
                      f"threads, P={parts}: {ms:.4f} ms{mark}  [{card}]",
                      flush=True)
            tr.PGWALK2_LANES, tr.PGWALK2_FILL, tr.PGWALK2_MAX_PARTS = default
    for (label, shape), ms in sums.items():
        mark = " (default)" if shape == default else ""
        print(f"sum {label}: lanes, fill, max parts {shape}: {ms:.4f} ms"
              f"{mark}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"sweep_pgwalk2: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
