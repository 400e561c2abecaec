#!/usr/bin/env python3
"""Time the tiled-walk cull B1 (``srt_tpu_torch/csrc/cull.cu``), the tiled
walk B2/B2s (``csrc/intersect.cu``), the mask-scan walk B7
(``csrc/pgwalk.cu``) and the group culls B5 (``csrc/cull_perray.cu``) and
B6 (``csrc/cull_gmask.cu``) under their launch shapes on one NVIDIA GPU.

Usage: ``python3 sweep_cull_walk.py [kernel ...]`` from the repository
root (kernels: ``cull``, ``intersect``, ``intersect_stream``, ``pgwalk``,
``cull_perray``, ``cull_gmask``; none sweeps all).  It records every call
of the swept kernels in the frames that run them (``FRAMES``): one
headline frame, one config8 frame and one headline frame each through
``walks="tiled@256,binned"`` and ``"tiled@256,pg"`` (``chip_smoke.py``'s
scenes, cameras and walks), adds the 65,536-ray cases of
``chip_smoke.py`` phases 3, 6a and 8a (B2 on headline primaries, B2s on
config8 primaries, B5, B6 and B7 on bounce and shadow rays) and its
few-group cases, then times each call (``chip_smoke``'s
``device_median``: device time, median of 5) under each choice of its
knobs: B1's rays per thread (``traversal.CULL_RAYS_PER_THREAD``); B2's
lanes per ray, at most ``traversal.INTERSECT_LANES``, fewer where the
launch reaches ``traversal.INTERSECT_FILL`` threads per SM (1 << 30
never limits); B7's groups per tile, lanes per ray (on launches that fill
the card, and on those below ``PGWALK_FILL`` threads per SM), least chunk
and work items per SM (``traversal.PGWALK_*``); B5's and B6's groups per
warp, the launch size below which a warp takes one group (0: never), and
warps per block (``CULL_WARP_GROUPS``, ``CULL_GMASK_WARP_GROUPS``,
``CULL_FILL``, ``CULL_BLOCK_WARPS``).  Every
choice's output must equal the plain version's.  Prints one line per
call and choice, and the per-frame sums by choice; the choice the
wrappers use is marked.
"""

from __future__ import annotations

import sys

import chip_smoke as cs

_WALK = [dict(INTERSECT_LANES=lanes, INTERSECT_FILL=fill)
         for lanes, fill in ((1, 1 << 30), (2, 1 << 30), (2, 4 * 2048),
                             (4, 1 << 30), (4, 4 * 2048), (4, 8 * 2048))]
_PG = dict(PGWALK_GROUPS=8, PGWALK_LANES=4, PGWALK_FEW_LANES=8,
           PGWALK_FILL=1024, PGWALK_MIN_CHUNK=2, PGWALK_ITEMS=16)
_PGWALK = ([dict(_PG, PGWALK_GROUPS=k, PGWALK_LANES=lanes)
            for k in (4, 8, 16) for lanes in (4, 8)]
           + [dict(_PG, PGWALK_FEW_LANES=few, PGWALK_MIN_CHUNK=chunk,
                   PGWALK_ITEMS=items)
              for few in (4, 8, 16) for chunk in (2, 4, 8) for items in (4, 16)
              if (few, chunk, items) != (8, 2, 16)]
           + [dict(_PG, PGWALK_FILL=fill) for fill in (2048, 4096)])
_GC = dict(CULL_WARP_GROUPS=4, CULL_FILL=128, CULL_BLOCK_WARPS=4)
_GROUP_CULL = ([dict(_GC, CULL_WARP_GROUPS=gpw) for gpw in (4, 1, 2)]
               + [dict(_GC, CULL_FILL=fill) for fill in (0, 32, 512)]
               + [dict(_GC, CULL_BLOCK_WARPS=w) for w in (2, 8)])
_GM = dict(CULL_GMASK_WARP_GROUPS=2, CULL_FILL=128, CULL_BLOCK_WARPS=4)
_GMASK = ([dict(_GM, CULL_GMASK_WARP_GROUPS=gpw) for gpw in (2, 1, 4)]
          + [dict(_GM, CULL_FILL=fill) for fill in (0, 32, 512)]
          + [dict(_GM, CULL_BLOCK_WARPS=w) for w in (2, 8)])
CHOICES = {"cull": [dict(CULL_RAYS_PER_THREAD=rpt) for rpt in (1, 2)],
           "intersect": _WALK, "intersect_stream": _WALK,
           "pgwalk": _PGWALK,
           "cull_perray": _GROUP_CULL, "cull_gmask": _GMASK}
# The frames whose calls each kernel's sweep times.
FRAMES = {"cull": ("headline", "config8"),
          "intersect": ("headline", "binned"),
          "intersect_stream": ("config8",), "pgwalk": ("pg",),
          "cull_perray": ("binned",), "cull_gmask": ("pg",)}


def record(plan, key):
    import torch
    with cs.recorded_launches() as calls:
        plan.render(key)
    torch.cuda.synchronize()
    return [(name, args) for name, args, _ in calls if name in CHOICES]


def frames(dev, labels):
    """{label: recorded calls} of the frames named in ``labels``, and the
    scenes."""
    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.scene import model_scene_lights

    calls, scenes = {}, {}
    for label, sphere, size, depth, walks in (
            ("headline", cs.HEADLINE_SPHERE, cs.HEADLINE_SIZE, 4, None),
            ("config8", cs.CONFIG8_SPHERE, cs.CONFIG8_SIZE, 2, None),
            ("binned", cs.HEADLINE_SPHERE, cs.HEADLINE_SIZE, 4, "binned"),
            ("pg", cs.HEADLINE_SPHERE, cs.HEADLINE_SIZE, 4, "pg")):
        if sphere not in scenes:
            scenes[sphere] = cs.build_scene(dev, *sphere)[0]
        if label not in labels:
            continue
        scene = scenes[sphere]
        cam = CameraConfig(width=size, height=size, **cs.HEADLINE_CAMERA)
        cfg = RenderConfig(max_depth=depth, rr_bounces=0, spp=1)
        kw = (dict(walks=f"tiled@256,{walks}", walks_shadow=walks)
              if walks else {})
        plan = make_render_plan(scene, model_scene_lights(dev), cam, cfg,
                                **kw)
        calls[label] = record(plan, rng.key(0, dev))
    return calls, scenes


def cases(scenes):
    """The 65,536-ray cases and the few-group B5, B6 and B7 cases as
    recorded calls."""
    import torch

    from srt_tpu_torch.ops import traversal as tr
    out = []
    scene = scenes[cs.HEADLINE_SPHERE]
    woop, _, sbounds, cb8, s_count, _ = tr.model_tables(scene, 0)
    _, bounce8, shadow8 = cs.walk_rays(scene)
    idx = torch.arange(cs.FEW_GROUP_RAYS, device=bounce8.device)
    live = torch.isin(idx // tr.GROUP, torch.tensor(cs.FEW_LIVE_GROUPS,
                                                    device=idx.device))
    for any_hit, rays8 in ((False, bounce8), (True, shadow8)):
        r8 = rays8[:cs.FEW_GROUP_RAYS].clone()
        r8[~live, 6] = 0.0
        for r in (r8, rays8):
            mask = tr.cull_gmask(r, cb8, s_count, sbounds)
            out.append(("pgwalk", dict(mask=mask, rays8=r, woop=woop,
                                       any_hit=any_hit)))
            out.append(("cull_perray", dict(rays8=r, sbounds=sbounds)))
            out.append(("cull_gmask", dict(rays8=r, cb8=cb8, s_count=s_count,
                                           sbounds=sbounds)))
    for sphere, name in ((cs.HEADLINE_SPHERE, "intersect"),
                         (cs.CONFIG8_SPHERE, "intersect_stream")):
        scene = scenes[sphere]
        woop, cb, sbounds, _, _, _ = tr.model_tables(scene, 0)
        if name == "intersect_stream":
            woop = tr.stream_table(scene, 0)
        prim8 = cs.walk_rays(scene)[0]
        clist, elist, counts = tr.cull(prim8, sbounds, 256)
        out.append((name, dict(counts=counts, clist=clist, elist=elist,
                               rays8=prim8, cb=cb, woop=woop, tile=256,
                               any_hit=False)))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_cull_walk: no CUDA device", file=sys.stderr)
        return 2
    from srt_tpu_torch.ops import traversal as tr

    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    only = set(sys.argv[1:]) or set(CHOICES)
    calls, scenes = frames(dev, {f for k in only for f in FRAMES[k]})
    calls["cases"] = cases(scenes)
    sums, marks = {}, {}
    for label, recorded in calls.items():
        for k, (name, args) in enumerate(recorded):
            if name not in only:
                continue
            fn = getattr(tr, name)
            args = {a: v for a, v in args.items() if a != "plain"}
            ref = cs.as_tuple(fn(**args, plain=True))
            rays8 = args["rays8"]
            default = {knob: getattr(tr, knob) for knob in CHOICES[name][0]}
            head = (f"{label} call {k} {name}: {rays8.shape[0]} rays "
                    f"({int((rays8[:, 6] > 0).sum())} live), "
                    + (f"tile {args['tile']}" if "tile" in args else
                       f"{cs.popcount(args['mask'])} set bits"
                       if "mask" in args else
                       f"S={args['sbounds'].shape[1]}"))
            for choice in CHOICES[name]:
                for knob, value in choice.items():
                    setattr(tr, knob, value)
                out = cs.as_tuple(fn(**args))
                ms = cs.device_median(lambda: fn(**args))[0]
                text = ", ".join(f"{a}={v}" for a, v in choice.items())
                cs.check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                         f"{head}: {text} differs from the plain version")
                key = (label, name, text)
                sums[key] = sums.get(key, 0.0) + ms
                marks[key] = " (default)" if choice == default else ""
                print(f"{head}: {text}: {ms:.4f} ms{marks[key]}  [{card}]",
                      flush=True)
            for knob, value in default.items():
                setattr(tr, knob, value)
    for (label, name, text), ms in sums.items():
        print(f"sum {label} {name}: {text}: {ms:.4f} ms"
              f"{marks[(label, name, text)]}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"sweep_cull_walk: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
