"""The port's measurement tools (``srt_tpu_torch/tools``) on the CPU at
small sizes, against the JAX package where they compute something:

* ``wavefronts.capture`` against JAX's loop (``tools/eval_counts.py:
  70-91``) on the same uniforms, dense hits on both sides;
* ``eval_counts``' per-bounce supers processed and clusters evaluated
  against JAX's ``pallas_model_hit(count_evals=True)`` in interpret mode
  on the same rays (sums: the two pad B2c's rows differently), and its
  fit against ``np.linalg.lstsq``;
* ``profile_bounces``' per-bounce stats at depths 1-4 against JAX's
  ``trace_wavefront(return_stats=True)`` on the same key (jitted, as
  JAX's tool runs it);
* every tool's ``run(device="cpu")``: its records, with finite positive
  times and the keys of its JAX counterpart; ``parity_smoke`` passes
  JAX's thresholds on the plain versions; ``parse_trace`` sums a
  synthetic chrome trace; without a card every ``main`` exits 2.

JAX's bounce loop for the wavefronts runs under ``jax.disable_jit()``:
compiled (JAX's tool jits its step), XLA contracts multiply-adds, which
moved one coordinate by 1.9e-5 relative here, and the float comparison
would then measure that.
"""

import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.camera import derive_viewport as jax_viewport
from srt_tpu.camera import generate_rays as jax_generate_rays
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.ops import morton as jax_morton
from srt_tpu.ops import rng as jax_rng
from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import RenderConfig
from srt_tpu_torch.models import mesh
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import lights_from_arrays
from srt_tpu_torch.tools import (common, eval_counts, parse_trace,
                                 profile_bounces, wavefronts)
from tests.test_torch_traversal import exact_reciprocal  # noqa: F401
from tests.test_torch_traversal import port_scene_of

torch.set_num_threads(2)

SIZE, RUN_SIZE = 32, 16
N = SIZE * SIZE
CAM = dict(width=SIZE, height=SIZE, **common.HEADLINE_CAMERA)
TOOLS = ("micro_occ", "wavefronts", "eval_counts", "profile_bounces",
         "profile_breakdown", "profile_bench", "profile_frame",
         "profile_scan", "profile_fastpath", "profile_trace", "parse_trace",
         "parity_smoke", "micro_bounce_real", "micro_pg2_split",
         "micro_pgwalk", "micro_gather", "micro_soa", "micro_layout",
         "micro_binned", "micro_footprint", "micro_sortkeys",
         "multihost_2proc")


def lights_of(jl):
    return lights_from_arrays({k: np.asarray(getattr(jl, k))
                               for k in ("position", "color", "intensity")},
                              "cpu")


@pytest.fixture(scope="module")
def small():
    """uv_sphere(12, 18), one super: JAX's scene, the port's, lights."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(12, 18)],
                                     pad_to=128))
    jl = jax_lights()
    return js, port_scene_of(js), jl, lights_of(jl)


@pytest.fixture(scope="module")
def three_supers(exact_reciprocal):
    """uv_sphere(40, 60, radius 2): 37 clusters, 3 supers (B1 culls)."""
    js = jax_mesh.upload(jax_flatten(
        [jax_procgen.uv_sphere(40, 60, radius=2.0)], pad_to=128))
    return js, port_scene_of(js)


def test_wavefronts_match_jax_loop(small):
    js, ps, jl, pl = small
    cfg_kw = dict(max_depth=4, rr_bounces=0, spp=1, sort_bounces=True)
    d_slots = 2 * jl.count + 6
    u = rng.host_uniforms(3, N, 2 + 4 * d_slots)
    got = wavefronts.capture(mesh.mesh_hit_fn(ps, method="dense"), pl,
                             common.camera(SIZE, common.HEADLINE_CAMERA),
                             RenderConfig(**cfg_kw),
                             rng.ArrayStream(torch.as_tensor(u)))
    # JAX's loop (eval_counts.py:70-91), its step not jitted (module
    # docstring).
    with jax.disable_jit():
        cfg = JaxRenderConfig(**cfg_kw)
        hit_fn = jax_mesh.mesh_hit_fn(js, method="dense")
        s = jax_rng.ArrayStream(jnp.asarray(u))
        o, d = jax_generate_rays(jax_viewport(JaxCamera(**CAM)), SIZE, SIZE,
                                 s.take(2))
        perm, _ = jax_morton.morton_perm(SIZE, SIZE)
        o, d = jax_morton.permute_rays(o, d, perm)
        u_all = s.take(4 * d_slots).reshape(4, d_slots, N)
        carry = (o, d, jnp.ones((3, N), jnp.float32),
                 jnp.zeros((3, N), jnp.float32), jnp.ones((N,), bool),
                 jnp.asarray(perm, jnp.int32))
        work, pix = [(o, d, jnp.ones((N,), bool))], [carry[5]]
        for b in range(3):
            carry, _ = jax_pt.bounce_step(hit_fn, jl, cfg, carry, b,
                                          u_all[b].T[carry[5]].T, sort=True)
            work.append((carry[0], carry[1], carry[4]))
            pix.append(carry[5])
    assert len(got.work) == len(work) == 4
    assert int(got.work[1][2].sum()) > 0
    for (po, pd, pa), pp, (jo, jd, ja), jp in zip(got.work, got.pix, work,
                                                  pix):
        # In pixel order: the sort keys may differ by a float ulp.
        p_ord = torch.argsort(pp).numpy()
        j_ord = np.argsort(np.asarray(jp))
        np.testing.assert_array_equal(pa.numpy()[p_ord],
                                      np.asarray(ja)[j_ord])
        for a, b in ((po, jo), (pd, jd)):
            np.testing.assert_allclose(a.numpy()[:, p_ord],
                                       np.asarray(b)[:, j_ord], rtol=1e-5,
                                       atol=1e-6)


def test_eval_counts_match_jax(three_supers):
    js, ps = three_supers
    recs = eval_counts.run("cpu", ps, size=SIZE, tile=128, reps=1,
                           verbose=False)
    waves = wavefronts.headline(ps, SIZE)
    bounces = [r for r in recs if r["bounce"] != "fit"]
    assert [r["bounce"] for r in bounces] == [1, 2]
    for rec in bounces:
        o, d, alive = waves.work[rec["bounce"] - 1]
        assert rec["live"] == int(alive.sum())
        w = common.live_width(rec["live"], N)
        t_max = np.where(alive.numpy()[:w], np.inf, 0.0).astype(np.float32)
        ctr = np.asarray(jax_tp.pallas_model_hit(
            js, 0, jnp.asarray(o[:, :w].numpy()),
            jnp.asarray(d[:, :w].numpy()), jnp.asarray(t_max), tile=128,
            refine=False, count_evals=True)[4])
        assert (rec["supers"], rec["clusters"]) == (int(ctr[:, 0].sum()),
                                                    int(ctr[:, 1].sum()))
        assert rec["clusters"] > 0
    fit = [r for r in recs if r["bounce"] == "fit"]
    assert len(fit) == 1 and fit[0]["rows"] == 6
    assert math.isfinite(fit[0]["b_ns"]) and fit[0]["b_bound_ns"] > 0


def test_eval_counts_fit_is_least_squares():
    gen = np.random.default_rng(5)
    rows = [(int(gen.integers(10, 1000)), int(gen.integers(10, 5000)),
             int(gen.integers(1, 64)), float(gen.uniform(1e-4, 1e-2)))
            for _ in range(7)]
    coef, resid = eval_counts.fit(rows)
    x = np.array([r[:3] for r in rows], float)
    y = np.array([r[3] for r in rows])
    want = np.linalg.lstsq(x, y, rcond=None)[0]
    np.testing.assert_allclose(coef, want, rtol=1e-12)
    assert resid == pytest.approx(np.abs((x @ want - y) / y).max())


def test_profile_bounces_stats_match_jax(small):
    js, ps, jl, _ = small
    recs = profile_bounces.run("cpu", ps, size=SIZE, reps=1, method="dense",
                               verbose=False)
    depths = [r for r in recs if r["case"] == "depth"]
    assert [r["depth"] for r in depths] == [1, 2, 3, 4]
    hit_fn = jax_mesh.mesh_hit_fn(js, method="dense")
    vp = jax_viewport(JaxCamera(**CAM))
    perm, _ = jax_morton.morton_perm(SIZE, SIZE)
    for rec in depths:
        cfg = JaxRenderConfig(max_depth=rec["depth"], rr_bounces=0, spp=1,
                              sort_bounces=True)

        @jax.jit
        def frame(key, cfg=cfg):
            # JAX's tool's frame (jitted there too).
            s = jax_rng.KeyStream(key, N)
            o, d = jax_generate_rays(vp, SIZE, SIZE, s.take(2))
            o, d = jax_morton.permute_rays(o, d, perm)
            return jax_pt.trace_wavefront(
                hit_fn, jl, o, d, jax_morton.PermutedStream(s, perm), cfg,
                return_stats=True)[1]
        assert rec["stats"] == np.asarray(frame(jax.random.key(0))).tolist()
    assert depths[0]["stats"][0][0] == N and depths[0]["stats"][0][1] > 0
    total = [r for r in recs if r["case"] == "total"][0]
    assert total["rays"] == sum(map(sum, depths[-1]["stats"]))


# Keys each tool's records carry (JAX's printed quantities), and the
# "case" values it must report.
RUN_KEYS = {
    "micro_occ": ({"variant", "what", "ms", "device_ms"}, None),
    "wavefronts": ({"bounce", "live", "width", "seconds"}, None),
    "eval_counts": ({"bounce", "live", "supers", "clusters", "tiles", "ms",
                     "ns_per_ceval", "gflops", "peak_share", "mrays_s"},
                    None),
    "profile_bounces": ({"case"}, {"depth", "no_shadow", "no_sort", "raw",
                                   "total"}),
    "profile_breakdown": ({"case", "ms"}, {"closest", "any", "raw", "cull",
                                           "stub", "full"}),
    "profile_bench": ({"case", "what", "ms"},
                      {"full", "rng", "raygen", "hit_shadow4", "closest4",
                       "closest", "walk", "cull", "stub"}),
    "profile_frame": ({"case", "ms"}, {"depth", "no_shadow", "array_stream",
                                       "hits_only"}),
    "profile_scan": ({"case", "ms", "b2_ms", "b2_launches", "schedule"},
                     {"scan", "scan_sorted", "compact"}),
    "profile_fastpath": ({"ms_min", "ms_mean", "device_ms", "events", "top",
                          "schedule"}, None),
    "profile_trace": ({"frame_ms", "device_ms", "events", "top"}, None),
    "parity_smoke": ({"case", "rays", "hit_rate_pallas", "hit_rate_dense",
                      "hit_agree", "same_id", "not_farther",
                      "t_rel_err_same_id", "pass"}, None),
    "micro_bounce_real": ({"case", "bounce"}, {"walk", "cull"}),
    "micro_pg2_split": ({"case", "bounce"}, {"split", "shadow"}),
    "micro_pgwalk": ({"case", "bounce"}, {"closest", "shadow", "gmask"}),
    "micro_gather": ({"what", "ms", "device_ms"}, None),
    "micro_soa": ({"what", "ms", "device_ms", "launches"}, None),
    "micro_layout": ({"what", "ms", "device_ms", "launches"}, None),
    "micro_binned": ({"case"}, {"scene", "hit", "stage", "supers", "pairs"}),
    "micro_footprint": ({"bounce", "live", "sampled", "mean", "p50", "p90",
                         "unions", "shadow"}, None),
    "micro_sortkeys": ({"case"}, {"footprint", "shadow", "key"}),
    "multihost_2proc": ({"bit_equal_to_single_process", "max_abs_diff",
                         "scaling_efficiency", "per_process"}, None),
}
# Times (positive) and time differences (finite) a record may carry.
TIMES = ("ms", "seconds", "cull_ms", "walk_ms", "total_ms", "tiled_ms",
         "frame_ms", "ms_min", "ms_mean", "ns_per_ceval", "binned_ms",
         "single_process_frame_s", "multi_process_tile_s")
DIFFERENCES = ("marginal_ms", "shadow_ms")


def small_run(name, ps, tmp_path):
    """``run(device="cpu")`` of a tool at a small size (16 x 16 frames),
    one rep."""
    tool = importlib.import_module(f"srt_tpu_torch.tools.{name}")
    kw = dict(verbose=False)
    if name == "micro_occ":
        return tool.run("cpu", n=4096, tile=512, groups=(8,), reps=1, **kw)
    if name == "parity_smoke":
        return tool.run("cpu", ps, ps, sizes=dict(
            rubik=(16, 256), headline=(16, 512), big=(16, 256)),
            out=str(tmp_path / "parity.json"), **kw)
    if name in ("profile_breakdown", "profile_bench", "profile_frame",
                "profile_scan", "profile_trace"):
        if name == "profile_trace":
            return tool.run("cpu", size=RUN_SIZE, trace_dir=str(tmp_path),
                            **kw)
        return tool.run("cpu", size=RUN_SIZE, reps=1, **kw)
    if name == "wavefronts":
        return tool.run("cpu", ps, size=RUN_SIZE, **kw)
    if name == "profile_fastpath":
        return tool.run("cpu", ps, size=RUN_SIZE, reps=1,
                        trace_dir=str(tmp_path), **kw)
    if name == "micro_pg2_split":
        return tool.run("cpu", ps, size=RUN_SIZE, groups=(16, 32), reps=1,
                        **kw)
    if name in ("micro_gather", "micro_soa", "micro_layout"):
        return tool.run("cpu", n=4096, reps=1, **kw)
    if name == "micro_binned":
        return tool.run("cpu", ps, n=2048, reps=1, **kw)
    if name == "micro_footprint":
        return tool.run("cpu", ps, size=RUN_SIZE, **kw)
    if name == "micro_sortkeys":
        dump = str(tmp_path / "rays.npz")
        importlib.import_module("srt_tpu_torch.tools.micro_pg2_split").run(
            "cpu", ps, size=SIZE, dump=dump, dump_only=True, **kw)
        return tool.run("cpu", ps, dump=dump, bounce=0, **kw)
    if name == "multihost_2proc":
        return tool.run("cpu", "dense", workdir=str(tmp_path / "world"),
                        threads=1, **kw)
    return tool.run("cpu", ps, size=RUN_SIZE, reps=1, **kw)


@pytest.mark.parametrize("name", sorted(RUN_KEYS))
def test_tool_run_on_cpu(name, three_supers, tmp_path):
    recs = small_run(name, three_supers[1], tmp_path)
    keys, cases = RUN_KEYS[name]
    assert recs and all(r["device"] == "cpu" for r in recs)
    assert keys <= set(recs[0]), (keys - set(recs[0]))
    if cases is not None:
        assert cases <= {r["case"] for r in recs}
    for rec in recs:
        for k in TIMES:
            if rec.get(k) is not None:
                assert math.isfinite(rec[k]) and rec[k] > 0, (k, rec)
        for k in DIFFERENCES:
            if k in rec:
                assert math.isfinite(rec[k])
        # No device time or launch exists on the CPU.
        for k in ("device_ms", "b2_ms", "launches", "kernel_ms",
                  "tiled_device_ms", "binned_device_ms", "tiled_launches",
                  "binned_launches"):
            assert rec.get(k) is None
    if name == "multihost_2proc":
        assert recs[0]["bit_equal_to_single_process"]
    if name == "micro_binned":
        hits = [r for r in recs if r["case"] == "hit"]
        assert [r["branch"] for r in hits] == ["pairs", "pairs"]
        stages = [r["stage"] for r in recs if r["case"] == "stage"]
        assert stages == ["front", "cull", "pairs", "gather", "kern"]
    if name == "parity_smoke":
        assert all(r["pass"] for r in recs) and len(recs) == 9
        saved = json.loads((tmp_path / "parity.json").read_text())
        assert saved["pass"] and len(saved["cases"]) == 9


def test_parse_trace_sums_device_events(tmp_path):
    """Complete events of the CUDA categories count; CPU operations,
    instants and other phases do not."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "intersect_kernel", "dur": 120},
        {"ph": "X", "cat": "kernel", "name": "intersect_kernel", "dur": 80},
        {"ph": "X", "cat": "kernel", "name": "cull_kernel", "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 4},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 999},
        {"ph": "i", "cat": "kernel", "name": "marker", "dur": 999},
        {"ph": "M", "name": "process_name", "args": {"name": "GPU 0"}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = parse_trace.run(str(path), top=2, verbose=False)
    assert got["total_ms"] == pytest.approx(0.264)
    assert got["events"] == 5
    assert got["top"] == [
        dict(name="intersect_kernel", ms=pytest.approx(0.2), count=2),
        dict(name="cull_kernel", ms=pytest.approx(0.05), count=1)]


@pytest.mark.parametrize("name", [t for t in TOOLS if t != "parse_trace"])
def test_tool_main_needs_a_card(name, monkeypatch, capsys):
    """Without a card and ``--device cpu`` every tool exits 2 and prints
    nothing on stdout; ``run`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(f"srt_tpu_torch.tools.{name}")
    assert tool.main([]) == 2
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError):
        tool.run()
