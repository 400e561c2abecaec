"""A closed loop of forward frames through the port's render plan
(``models.fastpath.make_render_plan``, built once in set-up): frame i is
one ``RenderPlan.render(fold_in(key(seed), i))`` call ending in a
synchronise, all of a pixel's samples in one wavefront."""

from __future__ import annotations

import time

from srtbench import core
from srtbench.entries import common
from srtbench.lib import trace as trace_mod
from srtbench.lib import walkwork
from srtbench.lib.spans import Spans
from srtbench.reference import judge

FAULTS = ("scaled", "half_samples")


def plant(fault):
    """Break the timed path underneath, for the tests that see ``correct``
    come out false: ``scaled`` alters every path's radiance where the
    compact driver produces it; ``half_samples`` leaves out half of each
    pixel's samples, the mean taken over the rest.  Returns the undo."""
    from srt_tpu_torch.models import wavefront_compact as wc

    original = wc.trace_compact

    def broken(*args, **kwargs):
        out = original(*args, **kwargs)
        image = out[0] if isinstance(out, tuple) else out
        if fault == "scaled":
            image.mul_(1.0 + 1e-3)
        elif fault == "half_samples":
            image[:, 1::2] = image[:, 0::2]
        else:
            raise ValueError(f"unknown fault {fault!r}")
        return out

    wc.trace_compact = broken
    return lambda: setattr(wc, "trace_compact", original)


def walk_work(scene, calls, per_super: int) -> list:
    """The work of each captured walk call (``lib/walkwork``)."""
    out = []
    for args, kwargs, res in calls:
        _, _, origins, dirs, t_best = args[:5]
        out.append(walkwork.count_call(
            scene.cluster_min, scene.cluster_max, scene.woop.shape[2],
            per_super, origins, dirs, float(kwargs.get("t_min", 0.0)),
            t_best, res[0], res[1] >= 0, bool(kwargs.get("any_hit"))))
    return out


def run(cell: core.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, cpu: bool = False, fault=None) -> core.Outcome:
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.ops import rng, traversal

    undo = plant(fault) if fault else None
    cfg, tr = cell.config, cell.traffic
    dev = common.device_for(0, cpu)
    spans = Spans()
    mesh, scene, lights = common.program_scene(cfg, dev, spans)
    cam, rcfg = common.camera_and_render(cfg)
    calls, capturing = [], [False]
    if trace:
        spans.wrap_everywhere(
            traversal.model_hit, "srt_tpu_torch", "srtbench.walk",
            lambda a, k, r: capturing[0] and calls.append((a, k, r)))
    plan = make_render_plan(scene, lights, cam, rcfg)
    key = rng.key(seed, dev)

    def frame(i):
        img, _, overflow = plan.render(rng.fold_in(key, i))
        return img, overflow

    for j in range(int(tr["warm_frames"])):
        frame(common.WARM_BASE - j)
    common.sync(dev)
    pick = 1 + seed % int(tr["check"]["pick_below"])
    kept, overflows = [], []
    common.reset_peak(dev)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    times = []
    reading = None
    breakdown = None
    if not trace:
        i = 0
        while True:
            t0 = time.perf_counter()
            img, overflow = frame(i)
            common.sync(dev)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            overflows.append(overflow)
            if i in (0, pick):
                kept.append((i, img))
            last = (i, img)
            i += 1
            if t1 - t_w0 >= seconds:
                break
        if last[0] not in (0, pick):
            kept.append(last)
        window = core.Window(seconds=t1 - t_w0, setup_s=setup_s,
                             peak_bytes=common.peak_bytes(dev),
                             frame_s=times,
                             paths_per_frame=cam.width * cam.height
                             * rcfg.spp)
    else:
        window = None
        n_span = int(tr["trace"]["span_frames"])
        n_prof = int(tr["trace"]["profiled_frames"])
        for i in range(n_span):
            with spans.span("srtbench.dispatch"):
                img, overflow = frame(i)
            common.sync(dev)
            overflows.append(overflow)
            if i == 0:
                kept.append((i, img))

        def step(j):
            capturing[0] = j == n_prof
            # The last traced frame's walk calls are counted (lib/walkwork).
            with spans.span("srtbench.capture" if capturing[0]
                            else "srtbench.frame"):
                img, overflow = frame(n_span + j)
            capturing[0] = False
            overflows.append(overflow)
            if j == n_prof:
                kept.append((n_span + j, img))

        tr_ = trace_mod.capture(step, n_prof, spans)
        work = walk_work(scene, calls, traversal.SUPER)
        calls.clear()
        reading = common.Reading(
            trace=tr_, spans=spans.seconds, work=work, steps=tr_.n_steps,
            extra={"scene_build_s": spans.seconds["srtbench.scene_build"][0]})
        breakdown = {"device_ops": tr_.top_ops(), "idle_gaps":
                     tr_.idle_gaps()}
    spans.restore()
    if undo is not None:
        undo()
    failed = sum(int(x) != 0 for x in overflows)
    attempted = len(overflows)
    peak = common.peak_bytes(dev)
    device = common.device_record(dev, cell.chips, peak)
    if trace:
        device["busy_s"] = reading.trace.busy_s
        device["window_s"] = reading.trace.window_s
    del plan, scene, lights
    common.free(dev)
    r = judge.pixel_readings(kept, seed, cfg, mesh, tr["check"]["scheme"],
                             tr["check"]["layout"], dev,
                             int(tr["check"]["pixels"]))
    checks = {"px_off_pct": (r["px_off_pct"],
                             float(tr["check"]["limits"]["px_off_pct"]))}
    return core.Outcome(attempted=attempted, failed=failed, checks=checks,
                        device=device, window=window, reading=reading,
                        breakdown=breakdown)


def readings(cell: core.Cell, seeds, cpu: bool = False, control=None,
             last: int = 200):
    """For each seed, the compared number of the program's frames 0, the
    seed's picked frame and frame ``last`` (as a run of about that many
    frames checks them), and of the control (the reference in the
    ``control`` dtype put in the program's place).  One set-up serves
    every seed.  Yields (seed, program readings, control readings)."""
    from srt_tpu_torch.models.fastpath import make_render_plan
    from srt_tpu_torch.ops import rng

    cfg, tr = cell.config, cell.traffic
    dev = common.device_for(0, cpu)
    mesh, scene, lights = common.program_scene(cfg, dev, Spans())
    cam, rcfg = common.camera_and_render(cfg)
    plan = make_render_plan(scene, lights, cam, rcfg)
    for seed in seeds:
        key = rng.key(seed, dev)
        pick = 1 + seed % int(tr["check"]["pick_below"])
        frames = [(i, plan.render(rng.fold_in(key, i))[0])
                  for i in (0, pick, last)]
        args = (seed, cfg, mesh, tr["check"]["scheme"],
                tr["check"]["layout"], dev, int(tr["check"]["pixels"]))
        prog = judge.pixel_readings(frames, *args)
        ctrl = (judge.pixel_readings(frames, *args, control=control)
                if control is not None else None)
        yield seed, prog, ctrl
