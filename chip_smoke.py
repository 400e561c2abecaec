#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``srt_tpu_torch``) once on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root (no arguments:
every phase, one card).  It imports neither JAX nor the JAX package.

Phases, one line each; the last line is printed only when all pass:

1. Device: the card's name and ``nvidia-smi`` name/power limit.  Exits
   nonzero without a CUDA device.
2. Build: nvcc builds ``srt_tpu_torch/csrc`` into ``build/srt_tpu_torch``.
3. Kernel vs plain PyTorch version, on the card, at the headline scene's
   tables (101,760 triangles, 50 superclusters) and 65,536 rays per case:
   outputs must be equal; median times of both.
4. The headline render at full size: ``make_render_plan`` on
   ``uv_sphere(160, 320, radius=2.0)``, 1024x1024, spp 1, max_depth 4,
   probe + schedule discovery, then one untimed frame in which every
   kernel launch is recorded and replayed through its plain version (the
   main path's own inputs and ray counts; outputs must be equal), then
   10 timed frames; overflow 0, a finite image, every kernel launched;
   Mrays/s with ``bench.py``'s accounting.
5. A 128x128 frame from one injected uniform array (numpy seed 0) through
   the kernels and through the plain versions: equal stats, allclose
   image (rtol 1e-4, atol 1e-5).

``--profile PATH`` also writes a ``torch.profiler`` table of one more
frame to PATH (the source of PERF.md section 5).
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "cull": ("srt_tpu_torch/csrc/cull.cu",
             "srt_tpu/ops/traversal_pallas.py:134"),
    "intersect": ("srt_tpu_torch/csrc/intersect.cu",
                  "srt_tpu/ops/traversal_pallas.py:1061"),
    "cull_pg2": ("srt_tpu_torch/csrc/cull_pg2.cu",
                 "srt_tpu/ops/traversal_pallas.py:527"),
    "pgwalk2": ("srt_tpu_torch/csrc/pgwalk2.cu",
                "srt_tpu/ops/traversal_pallas.py:697"),
}
HEADLINE_CAMERA = dict(origin=(0.0, 1.0, 5.0), look_at=(0.0, 0.0, 0.0))


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def timed_median(fn, reps=10):
    """Median CUDA-event time (ms) of ``fn()`` over ``reps`` runs after one
    warm-up; returns (ms, last result)."""
    import torch
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], out


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# Outputs of each kernel that are float (compared for max_abs_err too);
# all outputs must be equal.
FLOAT_OUTPUTS = {"cull": (1,), "intersect": (0,), "cull_pg2": (),
                 "pgwalk2": (0,)}


def compare(name, case, k_out, p_out):
    """Check a kernel's outputs equal its plain version's; returns the max
    abs difference of the float outputs (0.0 when equal)."""
    import torch
    errs = [0.0]
    for q, (a, b) in enumerate(zip(k_out, p_out)):
        if q in FLOAT_OUTPUTS[name]:
            diff = (a - b).abs()
            finite = torch.isfinite(a) & torch.isfinite(b)
            errs.append(float(diff[finite].max()) if finite.any() else 0.0)
            check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
                  f"{name} {case}: output {q} finiteness differs")
        n_bad = int((a != b).sum())
        check(n_bad == 0, f"{name} {case}: output {q} differs from the "
                          f"plain version in {n_bad} entries")
    return max(errs)


def headline_scene(device):
    from srt_tpu_torch.models import mesh
    from srt_tpu_torch.utils.flatten import flatten_models
    from srt_tpu_torch.utils.procgen import uv_sphere
    t0 = time.perf_counter()
    scene = mesh.upload(flatten_models([uv_sphere(160, 320, radius=2.0)],
                                       pad_to=128), device=device)
    return scene, time.perf_counter() - t0


def phase_kernels(scene, card, results):
    """Phase 3: every kernel against its plain version on the card."""
    import numpy as np
    import torch

    from srt_tpu_torch.camera import derive_viewport, generate_rays
    from srt_tpu_torch.config import CameraConfig
    from srt_tpu_torch.models.pathtracer import _bounce_sort_keys
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.ops.morton import morton_perm, permute_rays

    dev = scene.device
    woop, cb, sbounds, cb8, s_count, n_clusters = tr.model_tables(scene, 0)
    n = 65536
    # Primary rays: the headline camera at 256x256 (Morton order).
    cam = CameraConfig(width=256, height=256, **HEADLINE_CAMERA)
    jit = torch.full((2, n), 0.5, device=dev)
    o, d = generate_rays(derive_viewport(cam, device=dev), 256, 256, jit)
    o, d = permute_rays(o, d, morton_perm(256, 256)[0])
    prim8, _, _ = tr.pack_rays(scene, 0, o, d, float("inf"), 256)
    # Bounce-like rays: random origins around the sphere aimed at points
    # inside it, a third dead, in the integrator's 6-D coherence order.
    rng = np.random.default_rng(0)
    ro = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    ro += np.sign(ro) * 2.0
    rd = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32) - ro
    bo = torch.as_tensor(ro.T.copy(), device=dev)
    bd = torch.as_tensor(rd.T.copy(), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[::3] = False
    order = torch.argsort(_bounce_sort_keys(bo, bd, alive, 1), stable=True)
    bo, bd, alive = bo[:, order], bd[:, order], alive[order]
    t_closest = torch.where(alive, float("inf"), 0.0)
    seg = torch.as_tensor(rng.uniform(1.0, 6.0, n).astype(np.float32),
                          device=dev)[order]
    t_seg = torch.where(alive, seg, 0.0)
    bounce8, _, _ = tr.pack_rays(scene, 0, bo, bd, t_closest, 128)
    shadow8, _, _ = tr.pack_rays(scene, 0, bo, bd, t_seg, 128, t_lo=1e-3)

    def run_case(name, case, kernel_fn, plain_fn):
        k_ms, k_out = timed_median(kernel_fn)
        p_ms, p_out = timed_median(plain_fn)
        err = compare(name, case, k_out, p_out)
        rec = results.setdefault(name, {"cases": []})
        rec["cases"].append(dict(case=case, ms=k_ms, plain_ms=p_ms,
                                 max_abs_err=err))
        print(f"[3] {name:9s} {case:34s} kernel {k_ms:9.3f} ms  plain "
              f"{p_ms:9.3f} ms  equal (max_abs_err {err})  [{card}]",
              flush=True)
        return k_out

    lists = run_case(
        "cull", "primary tile 256",
        lambda: tr.cull(prim8, sbounds, 256),
        lambda: tr.cull(prim8, sbounds, 256, plain=True))
    clist, elist, counts = lists
    for any_hit in (False, True):
        run_case(
            "intersect", f"primary tile 256 {'any' if any_hit else 'closest'}"
            "-hit",
            lambda: tr.intersect(counts, clist, elist, prim8, cb, woop, 256,
                                 any_hit),
            lambda: tr.intersect(counts, clist, elist, prim8, cb, woop, 256,
                                 any_hit, plain=True))
    for group in (128, 32):
        for any_hit, rays8 in ((False, bounce8), (True, shadow8)):
            kind = "any" if any_hit else "closest"
            pg = run_case(
                "cull_pg2", f"bounce G={group} {kind}-hit rays",
                lambda: tr.cull_pg2(rays8, cb8, s_count, group),
                lambda: tr.cull_pg2(rays8, cb8, s_count, group, plain=True))
            run_case(
                "pgwalk2", f"bounce G={group} {kind}-hit",
                lambda: tr.pgwalk2(*pg, rays8, woop, group, any_hit),
                lambda: tr.pgwalk2(*pg, rays8, woop, group, any_hit,
                                   plain=True))
    hits = int((tr.pgwalk2(*tr.cull_pg2(bounce8, cb8, s_count, 32), bounce8,
                           woop, 32)[1] >= 0).sum())
    check(hits > n // 4, f"only {hits} of {n} bounce rays hit the sphere")


@contextlib.contextmanager
def recorded_launches(tr):
    """While the block runs, record each kernel wrapper call of ``tr``:
    yields a list of (name, bound arguments, outputs), tensors cloned."""
    calls = []
    saved = {name: getattr(tr, name) for name in KERNELS}

    def recorder(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kw):
            out = fn(*args, **kw)
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            calls.append((name, {k: v.clone() if hasattr(v, "clone") else v
                                 for k, v in bound.arguments.items()},
                          tuple(o.clone() for o in out)))
            return out
        return call

    for name, fn in saved.items():
        setattr(tr, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(tr, name, fn)


def phase_render(scene, card, results, profile):
    """Phase 4: the headline render at full size."""
    import torch

    from srt_tpu_torch.config import CameraConfig, RenderConfig
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.ops import traversal as tr
    from srt_tpu_torch.scene import model_scene_lights

    dev = scene.device
    cam = CameraConfig(width=1024, height=1024, **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    lights = model_scene_lights(dev)
    t0 = time.perf_counter()
    plan = make_render_plan(scene, lights, cam, cfg,
                            generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"[4] plan: probe + schedule discovery "
          f"{time.perf_counter() - t0:.3f} s, schedule {plan.schedule}",
          flush=True)
    # One untimed frame (as bench.py renders first), recording every
    # kernel launch; each is then replayed through its plain version.
    with recorded_launches(tr) as calls:
        plan.render(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    for k, (name, args, k_out) in enumerate(calls):
        check(not args["plain"], f"{name}: the render path ran the plain "
                                 f"version")
        rays8 = args["rays8"]
        mode = (f"G={args['group']}" if "group" in args
                else f"tile {args['tile']}")
        if "any_hit" in args:
            mode += " any-hit" if args["any_hit"] else " closest-hit"
        case = (f"frame launch {k}: {rays8.shape[0]} rays "
                f"({int((rays8[:, 6] > 0).sum())} live), {mode}")
        t0 = time.perf_counter()
        p_out = getattr(tr, name)(**{**args, "plain": True})
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        err = compare(name, case, k_out, p_out)
        results[name]["cases"].append(dict(case=case, ms=None, plain_ms=p_ms,
                                           max_abs_err=err))
        print(f"[4] {name:9s} {case:52s} equals plain (plain {p_ms:.1f} ms, "
              f"max_abs_err {err})  [{card}]", flush=True)
    check({name for name, _, _ in calls} == set(KERNELS),
          f"the untimed frame launched only {sorted({c[0] for c in calls})}")

    tr.reset_launch_counts()
    times = []
    for i in range(10):
        g = torch.Generator(device=dev).manual_seed(i + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, stats, overflow = plan.render(g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(int(overflow) == 0, f"frame {i}: overflow {int(overflow)}")
    launches = dict(tr.launch_counts)
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched by the "
                                  f"render path")
        results[name]["launches"] = launches[name]
    check(tuple(img.shape) == (1024, 1024, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    mean = float(img.mean())
    check(1e-4 < mean < 10.0, f"image mean {mean} out of range")
    dt = sum(times) / len(times)
    rays = int(stats.sum())
    print(f"[4] stats per bounce (traced, shadow): {stats.tolist()}, image "
          f"mean {mean:.6f}, launches {launches}", flush=True)
    print(f"[4] frame times (s): {[round(t, 6) for t in times]}", flush=True)
    print(f"[4] headline: {rays / dt / 1e6:.4f} Mrays/s ({rays} rays/frame, "
          f"mean frame {dt * 1e3:.3f} ms, 101760-tri uv_sphere, 1024x1024, "
          f"spp 1, 4 bounces)  [{card}]", flush=True)
    if profile:
        from torch.profiler import ProfilerActivity
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            plan.render(torch.Generator(device=dev).manual_seed(99))
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        os.makedirs(os.path.dirname(os.path.abspath(profile)), exist_ok=True)
        with open(profile, "w") as f:
            f.write(table)
        print("[4] profile (top device time):\n" + "\n".join(
            table.splitlines()[:16]), flush=True)
    return plan


def phase_parity(scene, plan, card):
    """Phase 5: reduced frame, kernels vs plain versions, one uniform
    array."""
    import dataclasses

    import torch

    from srt_tpu_torch.models.fastpath import build_hit_fns, default_walks
    from srt_tpu_torch.models.wavefront_compact import trace_image_compact
    from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots

    dev = scene.device
    cam = dataclasses.replace(plan.cam, width=128, height=128)
    cfg = plan.cfg
    n = cam.width * cam.height
    nb = cfg.max_depth + cfg.rr_bounces
    u = torch.as_tensor(host_uniforms(0, n, total_slots(plan.lights.count,
                                                         nb)), device=dev)
    walks, walks_sh = default_walks(scene, nb)
    out = {}
    for plain in (False, True):
        fns = build_hit_fns(scene, walks, walks_sh, plain=plain)
        out[plain] = trace_image_compact(fns, plan.lights, cam, cfg,
                                         ArrayStream(u), (n,) * nb,
                                         return_stats=True)
    (img_k, st_k, ov_k), (img_p, st_p, ov_p) = out[False], out[True]
    check(torch.equal(st_k, st_p), f"stats differ: kernels {st_k.tolist()} "
                                   f"plain {st_p.tolist()}")
    check(int(ov_k) == 0 and int(ov_p) == 0, "overflow in the parity frame")
    close = torch.isclose(img_k, img_p, rtol=1e-4, atol=1e-5)
    check(bool(close.all()), f"{int((~close).sum())} image values differ "
                             f"beyond rtol 1e-4 / atol 1e-5")
    print(f"[5] 128x128 parity: stats equal {st_k.tolist()}, image max abs "
          f"diff {float((img_k - img_p).abs().max())}, mean "
          f"{float(img_k.mean()):.6f}  [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "srt_tpu_torch", "csrc")):
        print("chip_smoke: srt_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # Plain float32 matmuls on the card (the references use no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from srt_tpu_torch.ops import cuda_lib

    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}",
          flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = cuda_lib.load()
    ptxas = [ln for ln in lib.log.splitlines() if "registers" in ln
             or "spill" in ln]
    print(f"[2] build: {lib.build_seconds:.3f} s nvcc ({lib.path.name}), "
          f"load {time.perf_counter() - t0:.3f} s", flush=True)
    for ln in ptxas:
        print(f"[2] {ln.strip()}", flush=True)

    dev = torch.device("cuda", 0)
    results = {k: {"cases": []} for k in KERNELS}
    scene, secs = headline_scene(dev)
    print(f"[3] headline scene: {scene.woop.shape[0]} clusters, "
          f"{scene.num_triangles} triangles, built in {secs:.3f} s",
          flush=True)
    phase_kernels(scene, card, results)
    plan = phase_render(scene, card, results, args.profile)
    phase_parity(scene, plan, card)

    kernels = []
    for k, (src, replaces) in KERNELS.items():
        first = results[k]["cases"][0]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=replaces,
            launches=results[k]["launches"],
            max_abs_err=max(c["max_abs_err"] for c in results[k]["cases"]),
            ms=first["ms"], plain_ms=first["plain_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
