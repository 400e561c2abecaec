"""Inverse rendering through the port's optimizer loop
(``optim.run_inverse_rendering``): Adam over (diffuse colour, vertex
positions), each step's image rendered by ``pathtracer.render`` over
``mesh.mesh_hit_fn(with_positions(...), method="walk")`` with fresh noise
(step i keyed ``fold_in(key(seed), i)``), the loss the image MSE against
a target rendered once in set-up at the true parameters.

Set-up builds one optimizer run and drives it through its first steps;
the same run goes on into the window, which ends on a whole step (the
loop is stopped from its callback).  The first steps are what the
reference follows: their losses, the first gradient as Adam's state holds
it after one step, and the parameters' change after the steps.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from srtbench import core
from srtbench.entries import common
from srtbench.lib import threefry
from srtbench.lib import trace as trace_mod
from srtbench.lib.spans import Spans
from srtbench.reference import judge

BETAS = (0.9, 0.999)
EPS = 1e-8
TARGET_FOLD = 2 ** 32 - 1      # the target's key: fold_in(key(seed), this)
FAULTS = ("frozen", "half", "scaled")


class _Stop(Exception):
    """Raised from the loop's callback to end the window on a whole step."""


def _program(cell, dev, spans, fault=None):
    """The port's side: scene, target maker, render and loss functions."""
    from srt_tpu_torch.models import mesh as mesh_mod
    from srt_tpu_torch.models import pathtracer

    cfg, tr = cell.config, cell.traffic
    mesh, scene, lights = common.program_scene(cfg, dev, spans)
    cam, rcfg = common.camera_and_render(cfg)

    def target_of(key):
        with torch.no_grad():
            return pathtracer.render(
                mesh_mod.mesh_hit_fn(scene, method="walk"), lights, cam,
                dataclasses.replace(rcfg, spp=int(tr["target_spp"])), key)

    def render_fn(params, key):
        diffuse, positions = params
        s = mesh_mod.with_positions(
            dataclasses.replace(scene, mat_diffuse=diffuse), positions)
        img = pathtracer.render(mesh_mod.mesh_hit_fn(s, method="walk"),
                                lights, cam, rcfg, key)
        return img * 1.01 if fault == "scaled" else img

    loss_fn = None
    if fault == "half":
        def loss_fn(params, target, key):
            img = render_fn(params, key)
            h = img.shape[0] // 2
            return torch.mean((img[:h] - target[:h]) ** 2)

    init = (scene.mat_diffuse * float(tr["start"]["diffuse"]),
            scene.positions * float(tr["start"]["positions"]))
    return mesh, init, target_of, render_fn, loss_fn


def _optimizer(tr, holder, fault=None):
    def make(leaves):
        opt = torch.optim.Adam(leaves, lr=float(tr["learning_rate"]),
                               betas=BETAS, eps=EPS)
        if fault == "frozen":
            opt.step = lambda closure=None: None
        holder["opt"] = opt
        return opt
    return make


def _first_steps(holder, init, losses, n_first, out):
    """The callback's record of the first steps: losses, the first
    gradient worked out from Adam's state, and the change after them."""
    def record(i, loss):
        losses.append(loss)
        leaves = holder["opt"].param_groups[0]["params"]
        if i == 0:
            st = holder["opt"].state
            out["grad_norms"] = [
                float(torch.linalg.vector_norm(st[p]["exp_avg"]
                                               / (1 - BETAS[0])))
                if p in st else 0.0 for p in leaves]
        if i == n_first - 1:
            out["losses"] = list(losses)
            out["change_norms"] = [
                float(torch.linalg.vector_norm(p.detach() - p0))
                for p, p0 in zip(leaves, init)]
    return record


def reference_train(cell, mesh, seed: int, dev, dtype=torch.float32):
    """The reference's own first steps from the same inputs: target,
    losses, first gradients and change, in ``dtype``."""
    cfg, tr = cell.config, cell.traffic
    n_first = int(tr["first_steps"])
    pix = torch.arange(cfg["camera"]["width"] * cfg["camera"]["height"],
                       device=dev)
    shape = (cfg["camera"]["height"], cfg["camera"]["width"], 3)
    key = threefry.key(seed, dev)
    tcfg = dict(cfg, render=dict(cfg["render"], spp=int(tr["target_spp"])))
    true = judge.reference_scene(cfg, mesh, dev, dtype)
    with torch.no_grad():
        target = judge.reference_pixels(
            true, tcfg, "per_sample", "slots",
            threefry.fold_in(key, TARGET_FOLD), pix).reshape(shape)
    kd0 = torch.tensor([cfg["material"]["diffuse"]], device=dev)
    pos0 = torch.as_tensor(mesh[0], device=dev)
    init = [kd0 * float(tr["start"]["diffuse"]),
            pos0 * float(tr["start"]["positions"])]

    def grads_of(params, i):
        p = [x.detach().requires_grad_(True) for x in params]
        s = judge.reference_scene(cfg, mesh, dev, dtype, positions=p[1],
                                  kd=p[0][0])
        s.search = true.search
        img = judge.reference_pixels(s, cfg, "per_sample", "slots",
                                     threefry.fold_in(key, i),
                                     pix).reshape(shape)
        loss = torch.mean((img.float() - target.float()) ** 2)
        return loss.detach(), torch.autograd.grad(loss, p)

    losses, first, final = judge.adam_steps(
        init, grads_of, float(tr["learning_rate"]), n_first, BETAS, EPS)
    return {"losses": losses,
            "grad_norms": [float(torch.linalg.vector_norm(g.float()))
                           for g in first],
            "change_norms": [float(torch.linalg.vector_norm(
                (a - b).float())) for a, b in zip(final, init)]}


def run(cell: core.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, cpu: bool = False, fault=None) -> core.Outcome:
    from srt_tpu_torch import optim
    from srt_tpu_torch.ops import rng

    tr = cell.traffic
    dev = common.device_for(0, cpu)
    spans = Spans()
    mesh, init, target_of, render_fn, loss_fn = _program(cell, dev, spans,
                                                         fault)
    key = rng.key(seed, dev)
    target = target_of(rng.fold_in(key, TARGET_FOLD))
    n_first = int(tr["first_steps"])
    holder, losses, first = {}, [], {}
    record = _first_steps(holder, init, losses, n_first, first)
    times, state = [], {}
    win = trace_mod.Window(int(tr["trace"]["profiled_steps"]), spans) \
        if trace else None

    def callback(i, params, loss):
        if i < n_first:
            record(i, loss)
            if i == n_first - 1:
                common.sync(dev)
                common.reset_peak(dev)
                state["t0"] = state["prev"] = time.perf_counter()
                if win is not None:
                    win.begin()
            return
        common.sync(dev)
        t = time.perf_counter()
        times.append(t - state["prev"])
        state["prev"] = t
        state["losses"] = state.get("losses", 0) + 1
        state["bad"] = state.get("bad", 0) + (loss != loss)
        if win is not None:
            win.step()
            if win.done:
                raise _Stop
        elif t - state["t0"] >= seconds:
            raise _Stop

    try:
        optim.run_inverse_rendering(
            render_fn, init, target, key, steps=2 ** 31,
            optimizer=_optimizer(tr, holder, fault), loss_fn=loss_fn,
            fixed_noise=False, log_every=0, callback=callback)
    except _Stop:
        pass
    window = reading = breakdown = None
    if not trace:
        window = core.Window(seconds=state["prev"] - state["t0"],
                             setup_s=state["t0"] - t_start,
                             peak_bytes=common.peak_bytes(dev),
                             step_s=times)
    else:
        reading = common.Reading(
            trace=win.trace, spans=spans.seconds, work=[],
            steps=win.trace.n_steps,
            extra={"scene_build_s": spans.seconds["srtbench.scene_build"][0]})
        breakdown = {"device_ops": win.trace.top_ops(),
                     "idle_gaps": win.trace.idle_gaps()}
    peak = common.peak_bytes(dev)
    device = common.device_record(dev, cell.chips, peak)
    if trace:
        device["busy_s"] = win.trace.busy_s
        device["window_s"] = win.trace.window_s
    del holder, target, init, render_fn, loss_fn, target_of
    common.free(dev)
    ref = reference_train(cell, mesh, seed, dev)
    r = judge.train_readings(first, ref)
    lim = tr["check"]["limits"]
    checks = {k: (r[k], float(lim[k])) for k in ("loss_gap", "grad_gap",
                                                  "change_gap")}
    attempted = n_first + len(times)
    return core.Outcome(attempted=attempted, failed=int(state.get("bad", 0)),
                        checks=checks, device=device, window=window,
                        reading=reading, breakdown=breakdown)


def readings(cell: core.Cell, seeds, cpu: bool = False, control=None,
             fault=None):
    """For each seed, the compared numbers of the program's first steps
    (with ``fault`` planted, if any) and of the control (the reference in
    the ``control`` dtype put in the program's place).  Yields (seed,
    program readings, control readings)."""
    from srt_tpu_torch import optim
    from srt_tpu_torch.ops import rng

    tr = cell.traffic
    dev = common.device_for(0, cpu)
    mesh, init, target_of, render_fn, loss_fn = _program(cell, dev, Spans(),
                                                         fault)
    n_first = int(tr["first_steps"])
    for seed in seeds:
        key = rng.key(seed, dev)
        target = target_of(rng.fold_in(key, TARGET_FOLD))
        holder, losses, first = {}, [], {}
        record = _first_steps(holder, init, losses, n_first, first)
        optim.run_inverse_rendering(
            render_fn, init, target, key, steps=n_first,
            optimizer=_optimizer(tr, holder, fault), loss_fn=loss_fn,
            fixed_noise=False, log_every=0,
            callback=lambda i, p, loss: record(i, loss))
        del holder, target
        ref = reference_train(cell, mesh, seed, dev)
        prog = judge.train_readings(first, ref)
        ctrl = None
        if control is not None:
            ctrl = judge.train_readings(
                reference_train(cell, mesh, seed, dev, control), ref)
        yield seed, dict(prog, **first), ctrl
