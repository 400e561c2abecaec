"""A closed loop of one-sample frames sharded over the rays of several
cards (``parallel.render_sharded`` over a ``device_mesh(N, 1)``): every
rank traces its columns of the frame against the replicated scene and the
radiance is all-gathered, each frame ending in a synchronise on every
rank.  The run's process spawns one process a card (NCCL, a TCP store on
localhost); rank 0 measures, traces and checks, and hands its result
back.  Frame i is keyed ``fold_in(key(seed), i)``."""

from __future__ import annotations

import importlib
import os
import socket
import time
import traceback

import torch
import torch.distributed as dist

from srtbench import core
from srtbench.entries import common
from srtbench.lib import trace as trace_mod
from srtbench.lib.spans import Spans
from srtbench.reference import judge

JOIN_S = 60.0
RESULT_S = 340.0
FAULTS = ("no_gather",)


def plant(fault) -> None:
    """Break the timed path underneath, in this rank's process, for the
    tests that see ``correct`` come out false: ``no_gather`` leaves out
    the exchange between cards (each rank keeps its own columns and
    zeros elsewhere)."""
    # The package re-exports the function under the module's name.
    rs = importlib.import_module("srt_tpu_torch.parallel.render_sharded")
    if fault != "no_gather":
        raise ValueError(f"unknown fault {fault!r}")

    class NoGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, local, group, order, lo, hi):
            out = local.new_zeros(local.shape[:-1] + (local.shape[-1]
                                                      * len(order),))
            out[..., lo:hi] = local
            return out

    rs._GatherRays = NoGather


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, cell, seed, seconds, trace, t_start, cpu,
          fault=None):
    from srt_tpu_torch.models import mesh as mesh_mod
    from srt_tpu_torch.ops import rng
    from srt_tpu_torch.parallel import mesh as pmesh
    from srt_tpu_torch.parallel.render_sharded import render_sharded

    if fault:
        plant(fault)
    cfg, tr = cell.config, cell.traffic
    dev = common.device_for(rank, cpu)
    if cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pmesh.init_distributed(f"localhost:{port}", world, rank, device=dev,
                           timeout=300)
    host = dist.new_group(backend="gloo")      # host-side agreement only
    grid = pmesh.device_mesh(world, 1, device=dev)
    spans = Spans()
    mesh, scene, lights = common.program_scene(cfg, dev, spans)
    cam, rcfg = common.camera_and_render(cfg)
    key = rng.key(seed, dev)

    def make_hit(s):
        return mesh_mod.mesh_hit_fn(s, method="walk")

    def frame(i):
        return render_sharded(make_hit, scene, lights, cam, rcfg,
                              rng.fold_in(key, i), grid)

    def agree(value: float, op=dist.ReduceOp.MAX) -> float:
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=op, group=host)
        return float(t[0])

    for j in range(int(tr["warm_frames"])):
        frame(common.WARM_BASE - j)
    common.sync(dev)
    pick = 1 + seed % int(tr["check"]["pick_below"])
    kept, times = [], []
    agree(0.0)
    common.reset_peak(dev)
    t_w0 = time.perf_counter()
    reading = breakdown = None
    if not trace:
        i = 0
        while True:
            t0 = time.perf_counter()
            img = frame(i)
            common.sync(dev)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if rank == 0 and i in (0, pick):
                kept.append((i, img))
            last = (i, img)
            i += 1
            if agree(rank == 0 and t1 - t_w0 >= seconds) > 0:
                break
        if rank == 0 and last[0] not in (0, pick):
            kept.append(last)
        window_s = t1 - t_w0
    else:
        n_span = int(tr["trace"]["span_frames"])
        n_prof = int(tr["trace"]["profiled_frames"])
        for i in range(n_span):
            with spans.span("srtbench.dispatch"):
                img = frame(i)
            common.sync(dev)
            if rank == 0 and i == 0:
                kept.append((i, img))
        # Every rank traces, so that the device's busy time is averaged
        # over the cards; the per-layer metrics read rank 0's window.
        win = trace_mod.Window(n_prof, spans)
        win.begin()
        for j in range(n_prof + 1):
            with spans.span("srtbench.frame"):
                img = frame(n_span + j)
            common.sync(dev)
            win.step()
        busy_s = agree(win.trace.busy_s, dist.ReduceOp.SUM) / world
        traced_s = agree(win.trace.window_s, dist.ReduceOp.SUM) / world
        if rank == 0:
            kept.append((n_span + n_prof, img))
            reading = common.Reading(
                trace=win.trace, spans=spans.seconds, work=[],
                steps=win.trace.n_steps,
                extra={"scene_build_s":
                       spans.seconds["srtbench.scene_build"][0]})
            breakdown = {"device_ops": win.trace.top_ops(),
                         "idle_gaps": win.trace.idle_gaps()}
        window_s = time.perf_counter() - t_w0
    peak = agree(common.peak_bytes(dev))
    attempted = len(times) if not trace else n_span + n_prof + 1
    dist.barrier(group=host)
    del scene, lights, grid
    dist.destroy_process_group()
    if rank != 0:
        return {"rank": rank, "forbidden": core.forbidden_loaded()}
    device = common.device_record(dev, cell.chips, peak)
    if trace:
        device["busy_s"] = busy_s
        device["window_s"] = traced_s
    window = None if trace else core.Window(
        seconds=window_s, setup_s=t_w0 - t_start, peak_bytes=int(peak),
        frame_s=times, paths_per_frame=cam.width * cam.height * rcfg.spp)
    common.free(dev)
    r = judge.pixel_readings(kept, seed, cfg, mesh, tr["check"]["scheme"],
                             tr["check"]["layout"], dev,
                             int(tr["check"]["pixels"]))
    device["forbidden"] = core.forbidden_loaded()
    return {"rank": 0, "outcome": core.Outcome(
        attempted=attempted, failed=0,
        checks={"px_off_pct": (r["px_off_pct"],
                               float(tr["check"]["limits"]["px_off_pct"]))},
        device=device, window=window, reading=reading, breakdown=breakdown)}


def _worker(rank, world, port, cell, seed, seconds, trace, t_start, cpu,
            fault, queue):
    try:
        queue.put(_rank(rank, world, port, cell, seed, seconds, trace,
                        t_start, cpu, fault))
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def run(cell: core.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, cpu: bool = False, fault=None) -> core.Outcome:
    import multiprocessing as mp
    import queue as queue_mod

    if not cpu:
        # Build the kernel library once, before the ranks load it.
        from srt_tpu_torch.ops import cuda_lib
        cuda_lib.load()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    world = cell.chips
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, port, cell, seed, seconds, trace,
                               t_start, cpu, fault, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            try:
                msg = results.get(timeout=RESULT_S)
            except queue_mod.Empty:
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   " sent no result") from None
            if "error" in msg:
                raise RuntimeError(f"rank {msg['rank']} failed:\n"
                                   f"{msg['error']}")
            got[msg["rank"]] = msg
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join()
        results.close()
        results.join_thread()
    out = got[0]["outcome"]
    out.device["forbidden"] = sorted({m for msg in got.values()
                                      for m in msg.get("forbidden", [])}
                                     | set(out.device.get("forbidden", [])))
    return out


def readings(cell: core.Cell, seeds, cpu: bool = False, control=None,
             last: int = 200):
    """The control's compared number at the cell's own size: the
    reference in the ``control`` dtype put in the program's place, at the
    pixels a run checks of frames 0, the seed's pick and ``last``.  It
    needs no card of the mesh; the program's own readings come from its
    runs.  Yields (seed, None, control readings)."""
    from srtbench.lib import config as config_mod

    if control is None:
        raise ValueError("the sharded program's readings come from its runs")
    cfg, tr = cell.config, cell.traffic
    dev = common.device_for(0, cpu)
    mesh = config_mod.make_mesh(cfg["mesh"])
    for seed in seeds:
        pick = 1 + seed % int(tr["check"]["pick_below"])
        frames = [(i, None) for i in (0, pick, last)]
        yield seed, None, judge.pixel_readings(
            frames, seed, cfg, mesh, tr["check"]["scheme"],
            tr["check"]["layout"], dev, int(tr["check"]["pixels"]),
            control=control)
