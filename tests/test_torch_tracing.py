"""The renderer's spans (``srt_tpu_torch/utils/profiling.span``) and the
benchmark's readers of them (``srtbench/metrics``), on the CPU.

A frame of the render plan on ``uv_sphere(80, 160)`` (13 superclusters,
so bounces past the first take the pg2 walks) at 32 x 32, 2 samples a
pixel: with no profiler its spans land in the aggregate, one
``srt.render`` over four ``srt.bounce.<b>``, a ``srt.walk`` for every
``traversal.model_hit`` call, children inside their parents, and
``record_function`` is never entered; under a ``torch.profiler`` window
the same spans appear nested as ``user_annotation`` ranges of the
exported trace, the aggregate gains nothing, and the image is the same
bit for bit.

The readers run on a made-up aggregate and a made-up trace: the three
host metrics add up to the ``srt.render`` total, the probe frame under
``srt.setup.plan`` is left out, ``plan_build_s`` takes out a nested
kernel build, ``launches.render`` counts only what ``srt.render``
launched, per step, an idle gap inside ``srt.shade`` is put down to it,
and without the port's profiling module every reader of the aggregate
reads nothing.
"""

import collections
import json
import sys
import types

import pytest
import torch

from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh
from srt_tpu_torch.models.fastpath import make_render_plan
from srt_tpu_torch.ops import rng, traversal
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.utils import profiling
from srt_tpu_torch.utils.flatten import flatten_models
from srt_tpu_torch.utils.procgen import uv_sphere
from srtbench import core
from srtbench.entries.common import Reading
from srtbench.lib import portspans
from srtbench.lib import trace as trace_mod

SEED = 3_000_000_019
BOUNCES = 4
HOST_METRICS = ("plan_host_ms.render", "shade_host_ms.render",
                "walk_host_ms.render")
AGGREGATE_METRICS = HOST_METRICS + ("plan_build_s", "flatten_s")


@pytest.fixture(scope="module")
def plan():
    """The render plan, its hit functions bound to a ``model_hit`` that
    counts its calls; (plan, calls)."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    real = traversal.model_hit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(traversal, "model_hit", counted)
        scene = mesh.upload(flatten_models([uv_sphere(80, 160, radius=2.0)],
                                           pad_to=128), "cpu")
        assert mesh.n_superclusters(scene) > 8
        cam = CameraConfig(width=32, height=32, origin=(0.0, 1.0, 5.0),
                           look_at=(0.0, 0.0, 0.0))
        p = make_render_plan(scene, model_scene_lights("cpu"), cam,
                             RenderConfig(max_depth=BOUNCES, rr_bounces=0,
                                          spp=2))
    return p, calls


@pytest.fixture(scope="module")
def frame(plan):
    """One frame with no profiler: (image, the aggregate, model_hit
    calls)."""
    p, calls = plan
    profiling.reset_spans()
    calls.clear()
    img, _, overflow = p.render(rng.key(SEED, "cpu"))
    assert int(overflow) == 0
    return img, profiling.span_totals(), len(calls)


@pytest.fixture(scope="module")
def profiled(plan, tmp_path_factory):
    """The same frame under a CPU profiler window: (image, the aggregate
    after it, the ``srt.*`` ranges of the exported trace, model_hit
    calls)."""
    from torch.profiler import ProfilerActivity, profile

    p, calls = plan
    profiling.reset_spans()
    calls.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img, _, _ = p.render(rng.key(SEED, "cpu"))
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith("srt.")]
    return img, profiling.span_totals(), ranges, len(calls)


def test_one_frame_in_the_aggregate(frame):
    _, tot, hits = frame
    assert all(p.split("/")[0] == "srt.render" for p in tot)
    assert tot["srt.render"][0] == 1
    assert tot["srt.render/srt.raygen"][0] == 1
    bounces = {p for p in tot if p.count("/") == 1
               and p.startswith("srt.render/srt.bounce.")}
    assert bounces == {f"srt.render/srt.bounce.{b}"
                       for b in range(1, BOUNCES + 1)}
    for b in bounces:
        assert tot[b][0] == tot[b + "/srt.shade"][0] == 1
    walks = sum(n for p, (n, _) in tot.items() if p.endswith("/srt.walk"))
    assert walks == hits >= 2 * BOUNCES


def test_spans_nest(frame):
    """Each span's children together take no longer than it."""
    _, tot, _ = frame
    children = collections.defaultdict(float)
    for path, (_, sec) in tot.items():
        parent = path.rpartition("/")[0]
        if parent:
            children[parent] += sec
    assert children
    for parent, sec in children.items():
        assert sec <= tot[parent][1]


def test_host_metrics_of_a_real_frame(frame, monkeypatch):
    _, tot, _ = frame
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(tot))
    r = Reading(trace=None, spans={}, work=[], steps=0, extra={})
    ms = [core.metric_reader(m).read(r) for m in HOST_METRICS]
    assert all(x > 0 for x in ms)
    assert sum(ms) == pytest.approx(1e3 * tot["srt.render"][1])


def test_no_profiler_range_without_a_window(plan, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.reset_spans()
    plan[0].render(rng.key(SEED + 1, "cpu"))
    assert profiling.span_totals()["srt.render"][0] == 1


def test_a_profiler_window_gets_the_spans_nested(profiled):
    _, tot, ranges, hits = profiled
    assert tot == {}
    names = collections.Counter(e["name"] for e in ranges)
    want = {"srt.render": 1, "srt.raygen": 1, "srt.shade": BOUNCES,
            "srt.walk": hits}
    want.update({f"srt.bounce.{b}": 1 for b in range(1, BOUNCES + 1)})
    assert names == want

    def inside(a, b):
        return (b["ts"] - 0.01 <= a["ts"]
                and a["ts"] + a["dur"] <= b["ts"] + b["dur"] + 0.01)

    def named(prefix):
        return [e for e in ranges if e["name"].startswith(prefix)]

    (render,) = named("srt.render")
    assert all(inside(e, render) for e in ranges)
    for child, parent in (("srt.shade", "srt.bounce."),
                          ("srt.walk", "srt.shade")):
        for e in named(child):
            assert any(inside(e, p) for p in named(parent)), e


def test_a_frame_is_the_same_under_a_profiler(frame, profiled):
    assert torch.equal(frame[0], profiled[0])


def test_span_pops_on_an_exception_and_stays_bounded():
    profiling.reset_spans()
    with pytest.raises(ValueError):
        with profiling.span("a"):
            with profiling.span("b"):
                raise ValueError
    for _ in range(100):
        with profiling.span("c"):
            with profiling.span("b"):
                pass
    tot = profiling.span_totals()
    assert {p: n for p, (n, _) in tot.items()} == {
        "a": 1, "a/b": 1, "c": 100, "c/b": 100}
    profiling.reset_spans()
    assert profiling.span_totals() == {}


# -- the readers, on a made-up aggregate and trace ----------------------

PROBE = {
    "srt.setup.plan": (1, 0.9),
    "srt.setup.plan/srt.raygen": (1, 0.01),
    "srt.setup.plan/srt.bounce.1": (1, 0.5),
    "srt.setup.plan/srt.bounce.1/srt.shade": (1, 0.45),
    "srt.setup.plan/srt.bounce.1/srt.shade/srt.walk": (2, 0.3),
    "srt.setup.plan/srt.bounce.1/srt.shade/srt.walk/srt.setup.kernels":
        (1, 0.25),
}
FRAMES = {
    "srt.render": (4, 0.6),
    "srt.render/srt.raygen": (4, 0.04),
    "srt.render/srt.bounce.1": (4, 0.2),
    "srt.render/srt.bounce.1/srt.shade": (4, 0.16),
    "srt.render/srt.bounce.1/srt.shade/srt.walk": (8, 0.06),
    "srt.render/srt.bounce.2": (4, 0.12),
    "srt.render/srt.bounce.2/srt.shade": (4, 0.1),
    "srt.render/srt.bounce.2/srt.shade/srt.walk": (8, 0.04),
    # A walk outside any bounce step counts as a walk, not as the plan's.
    "srt.render/srt.bounce.2/srt.walk": (4, 0.008),
}
TOTALS = dict(PROBE, **FRAMES, **{"srt.setup.flatten": (1, 0.2)})
EMPTY = Reading(trace=None, spans={}, work=[], steps=0, extra={})


def _port_with(monkeypatch, totals):
    fake = types.SimpleNamespace(span_totals=lambda: dict(totals))
    monkeypatch.setitem(sys.modules, portspans.MODULE, fake)


def _read(name, r=EMPTY):
    return core.metric_reader(name).read(r)


def test_host_metrics_add_up_to_the_frame(monkeypatch):
    _port_with(monkeypatch, TOTALS)
    plan, shade, walk = (_read(m) for m in HOST_METRICS)
    assert walk == pytest.approx(1e3 * (0.06 + 0.04 + 0.008) / 4)
    assert shade == pytest.approx(1e3 * (0.16 + 0.1 - 0.1) / 4)
    assert plan == pytest.approx(1e3 * (0.6 - 0.26 - 0.008) / 4)
    assert plan + shade + walk == pytest.approx(1e3 * 0.6 / 4)


def test_the_probe_frame_is_left_out(monkeypatch):
    _port_with(monkeypatch, TOTALS)
    with_probe = [_read(m) for m in HOST_METRICS]
    _port_with(monkeypatch, FRAMES)
    assert [_read(m) for m in HOST_METRICS] == with_probe
    _port_with(monkeypatch, PROBE)
    assert [_read(m) for m in HOST_METRICS] == [None] * 3


def test_set_up_readers(monkeypatch):
    _port_with(monkeypatch, TOTALS)
    assert _read("plan_build_s") == pytest.approx(0.9 - 0.25)
    assert _read("flatten_s") == pytest.approx(0.2)
    _port_with(monkeypatch, FRAMES)
    assert _read("plan_build_s") is None and _read("flatten_s") is None


def test_aggregate_readers_read_nothing_without_the_port(monkeypatch):
    monkeypatch.delitem(sys.modules, portspans.MODULE, raising=False)
    assert [_read(m) for m in AGGREGATE_METRICS] == [None] * 5
    # A port whose profiling module keeps no spans.
    monkeypatch.setitem(sys.modules, portspans.MODULE,
                        types.SimpleNamespace())
    assert [_read(m) for m in AGGREGATE_METRICS] == [None] * 5


def _step_events(t0, corr0):
    """One traced frame of 100 us from ``t0``: the benchmark's step and
    frame spans; inside them ``srt.render`` [5, 90] over ``srt.bounce.1``
    [10, 80] over ``srt.shade`` [12, 75], with ``aten::mul`` [20, 30]
    open; kernels launched at 3 (before ``srt.render``), 21 (in
    ``aten::mul``) and 50 (in ``srt.shade``, no op open), running at
    [4, 8], [22, 32] and [52, 57]."""
    host = dict(ph="X", pid=1, tid=1)
    ev = [dict(host, cat="user_annotation", name=name, ts=t0 + a, dur=b - a)
          for name, a, b in ((trace_mod.STEP, 0, 100),
                             ("srtbench.frame", 0, 100),
                             ("srt.render", 5, 90),
                             ("srt.bounce.1", 10, 80),
                             ("srt.shade", 12, 75))]
    ev.append(dict(host, cat="cpu_op", name="aten::mul", ts=t0 + 20,
                   dur=10))
    dev = dict(ph="X", pid=0, tid=7, cat="kernel", name="k")
    for i, (launch, a, b) in enumerate(((3, 4, 8), (21, 22, 32),
                                        (50, 52, 57))):
        corr = corr0 + i
        ev.append(dict(host, cat="cuda_runtime", name="cudaLaunchKernel",
                       ts=t0 + launch, dur=1, args={"correlation": corr}))
        ev.append(dict(dev, ts=t0 + a, dur=b - a,
                       args={"correlation": corr}))
    return ev


def _two_steps():
    return trace_mod.Trace(_step_events(0, 1) + _step_events(100, 11))


def test_launches_counts_what_the_frame_launched_per_step():
    t = _two_steps()
    assert t.n_steps == 2 and len(t.ops) == 6
    assert _read("launches.render", Reading(
        trace=t, spans={}, work=[], steps=2, extra={})) == 2.0
    assert _read("launches.render") is None
    older = [e for e in _step_events(0, 1) if e["name"] != "srt.render"]
    assert _read("launches.render", Reading(
        trace=trace_mod.Trace(older), spans={}, work=[], steps=1,
        extra={})) is None


def test_an_idle_gap_in_a_span_is_put_down_to_it():
    gaps = dict(_two_steps().idle_gaps())
    # [8, 22] and [32, 52] of each step lie in srt.shade with no op open;
    # only [0, 4], before the first srt.render, has no span of the port.
    assert gaps["srtbench.frame/srt.shade"] == pytest.approx(2 * 34e-6)
    assert gaps["srtbench.frame/host"] == pytest.approx(4e-6)
    assert sum(gaps.values()) == pytest.approx((200 - 2 * 19) * 1e-6)
