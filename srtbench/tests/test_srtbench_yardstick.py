"""The frozen yardstick: window statistics, the trace's idle share, the
walk's work count and roofline, the mesh and the uniforms."""

import math

import numpy as np
import pytest
import torch

from srtbench import core
from srtbench.entries.common import Reading
from srtbench.lib import (layers, peaks, stats, threefry, trace, uvsphere,
                          walkwork)


def test_rate_and_tail_over_all_frames():
    frames = [0.1] * 190 + [0.2] * 10
    assert stats.rate(4 * 200, 20.0) == 40.0
    assert stats.percentile(frames, 95) == 0.1
    assert stats.percentile(frames + [0.3], 95) == 0.2
    assert stats.percentile([5.0], 95) == 5.0


def test_end_to_end_readers():
    w = core.Window(seconds=10.0, setup_s=7.5, peak_bytes=3 * 2 ** 30,
                    frame_s=[0.1] * 100, paths_per_frame=4_194_304)
    assert core.e2e_reader("mpaths_s").read(w) == pytest.approx(41.943040)
    assert core.e2e_reader("frame_ms_p95").read(w) == pytest.approx(100.0)
    assert core.e2e_reader("peak_mem_gib").read(w) == 3.0
    assert core.e2e_reader("setup_s").read(w) == 7.5
    assert core.e2e_reader("step_s").read(w) is None
    s = core.Window(seconds=9.0, setup_s=1.0, peak_bytes=0,
                    step_s=[0.3] * 30)
    assert core.e2e_reader("step_s").read(s) == pytest.approx(0.3)


def _events():
    """A traced window of 100 us: a step span on the main thread, a walk
    span inside it, a walk kernel at [10, 30], elementwise kernels at
    [20, 40] and [60, 70] and a copy at [80, 85]."""
    host = dict(ph="X", pid=1, tid=1)
    ev = [dict(host, cat="user_annotation", name=trace.STEP, ts=0, dur=100),
          dict(host, cat="user_annotation", name="srtbench.walk", ts=5,
               dur=20),
          dict(host, cat="cpu_op", name="aten::mul", ts=30, dur=40)]
    launches = [(7, 1), (31, 2), (50, 3), (75, 4)]
    for ts, c in launches:
        ev.append(dict(host, cat="cuda_runtime", name="cudaLaunchKernel",
                       ts=ts, dur=1, args={"correlation": c}))
    dev = dict(ph="X", pid=0, tid=7, cat="kernel")
    ev += [dict(dev, name="void (anonymous namespace)::intersect_kernel"
                "<false>(int const*, float const*, int)", ts=10, dur=20,
                args={"correlation": 1}),
           dict(dev, name="void at::native::vectorized_elementwise_kernel"
                "<4, at::native::mul>(int, at::native::mul)", ts=20, dur=20,
                args={"correlation": 2}),
           dict(dev, name="mul", ts=60, dur=10, args={"correlation": 3}),
           dict(dev, name="Memcpy HtoD (Pageable -> Device)", ts=80, dur=5,
                cat="gpu_memcpy", args={"correlation": 4})]
    return ev


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::pgwalk2_kernel(int const*, int)",
     "pgwalk2_kernel"),
    ("cull_kernel(float const*, float const*, int, int)", "cull_kernel"),
    ("void pgwalk_kernel<true>(int const*)", "pgwalk_kernel"),
    ("void at::native::index_elementwise_kernel<128, 4>(long)",
     "index_elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "HtoD")])
def test_kernel_names(name, want):
    assert layers.kernel_name(name) == want


def test_idle_share_and_attribution_from_a_trace():
    t = trace.Trace(_events())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)
    r = Reading(trace=t, spans={}, work=[], steps=1, extra={})
    assert core.metric_reader("idle_pct.frame").read(r) == pytest.approx(55)
    walk = core.metric_reader("walk_ms.render").read(r)
    rest = core.metric_reader("elementwise_ms.render").read(r)
    copy = core.metric_reader("copy_ms.render").read(r)
    assert (walk, rest, copy) == (pytest.approx(0.020), pytest.approx(0.030),
                                  pytest.approx(0.005))
    # The three add up to the traced device time.
    assert walk + rest + copy == pytest.approx(t.device_ms(lambda op: True))
    gaps = dict(t.idle_gaps())
    assert gaps["aten::mul"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(55e-6)
    assert t.top_ops()[0][1] == pytest.approx(20e-6)


def _two_clusters():
    cmin = torch.tensor([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
    cmax = torch.tensor([[1.0, 1.0, 1.0], [6.0, 1.0, 1.0]])
    return cmin, cmax


def test_work_count_on_a_tiny_scene():
    cmin, cmax = _two_clusters()
    o = torch.tensor([[0.5, 0.5, -1.0], [-1.0, 0.5, 0.5], [9.0, 9.0, 9.0],
                      [0.5, 0.5, -1.0]]).T
    d = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                      [0.0, 0.0, 1.0]]).T
    t_hi = torch.tensor([math.inf, math.inf, math.inf, 0.0])
    found = torch.tensor([True, False, False, False])
    t_out = torch.tensor([1.5, math.inf, math.inf, math.inf])
    w = walkwork.count_call(cmin, cmax, 128, 16, o, d, 0.0, t_hi, t_out,
                            found, any_hit=False)
    # Three live rays test the one super; two enter it (2 cluster tests
    # each); ray 0 enters cluster 0 only, ray 1 crosses both boxes.
    assert w["slab"] == 3 * 1 + 2 * 2
    assert w["woop"] == 128 * 3
    assert w["bytes"] == 4 * 36 + 2 * 13 * 128 * 4 + 2 * 24 + 24
    occ = walkwork.count_call(cmin, cmax, 128, 16, o, d, 0.0, t_hi, t_out,
                              found, any_hit=True)
    assert occ["slab"] == 3 + 1 + 2 * 1 and occ["woop"] == 1 + 128 * 2


def test_roofline_bound_is_the_busier_limit():
    ops = {"slab": 1e9, "woop": 0.0, "bytes": 0.0}
    assert walkwork.bound_s(ops) == pytest.approx(
        14e9 / peaks.PEAK_ALU_INSTR_S)
    woop = {"slab": 0.0, "woop": 1e9, "bytes": 0.0}
    assert walkwork.bound_s(woop) == pytest.approx(
        46e9 / peaks.PEAK_FMA_INSTR_S)
    mem = {"slab": 0.0, "woop": 0.0, "bytes": 3.35e12}
    assert walkwork.bound_s(mem) == pytest.approx(1.0)


def test_roofline_reader():
    cap = dict(ph="X", pid=1, tid=1, cat="user_annotation", ts=0, dur=100,
               name="srtbench.capture")
    t = trace.Trace(_events() + [cap])
    work = [{"slab": 0.0, "woop": 0.0, "bytes": 3.35e12 * 10e-6}]
    r = Reading(trace=t, spans={}, work=work, steps=1, extra={})
    # 10 us of bound over the 20 us walk kernel of the captured frame.
    assert core.metric_reader("walk_roofline_pct.render").read(r) == \
        pytest.approx(50.0)
    assert core.metric_reader("walk_roofline_pct.render").read(
        Reading(trace=t, spans={}, work=[], steps=1, extra={})) is None


def test_roofline_not_read_when_a_walk_went_uncounted():
    """A walk kernel of the captured frame launched outside every
    ``srtbench.walk`` span: its work was not counted, so no share."""
    ev = _events() + [dict(ph="X", pid=1, tid=1, cat="user_annotation",
                           ts=0, dur=100, name="srtbench.capture")]
    for e in ev:
        if e["name"] == "srtbench.walk":
            e["ts"] = 8
    t = trace.Trace(ev)
    work = [{"slab": 0.0, "woop": 0.0, "bytes": 3.35e12 * 10e-6}]
    r = Reading(trace=t, spans={}, work=work, steps=1, extra={})
    assert core.metric_reader("walk_ms.render").read(r) == \
        pytest.approx(0.020)
    assert core.metric_reader("walk_roofline_pct.render").read(r) is None


@pytest.mark.parametrize("rows,cols", [(4, 8), (16, 24), (40, 60)])
def test_uv_sphere_equals_the_ports(rows, cols):
    from srt_tpu_torch.utils.procgen import uv_sphere

    want = uv_sphere(rows, cols, radius=2.0)
    pos, uvs, vidx = uvsphere.uv_sphere(rows, cols, radius=2.0)
    assert np.array_equal(pos, want.positions)
    assert np.array_equal(uvs, want.uvs)
    assert np.array_equal(vidx, want.tri_vidx)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 32 + 3])
def test_threefry_equals_the_ports(seed):
    from srt_tpu_torch.ops import rng

    k = rng.key(seed, "cpu")
    mine = threefry.key(seed)
    assert torch.equal(k, mine)
    assert torch.equal(rng.fold_in(k, 123), threefry.fold_in(mine, 123))
    sub = rng.fold_in(k, 1)
    cols = torch.tensor([0, 5, 999])
    assert torch.equal(
        rng.SlotBlock(sub, 7, 1000).rows_at(2, 6, cols),
        threefry.block_columns(threefry.fold_in(mine, 1), range(2, 6), 1000,
                               cols))
    rows = rng.SlotBlock(sub, 50, 10).full()
    pts = torch.arange(50)[:, None] * 10 + torch.arange(10)[None, :]
    assert torch.equal(rows, threefry.uniforms_at(threefry.fold_in(mine, 1),
                                                  pts))
