"""The port's last measurement tools (``srt_tpu_torch/tools``:
``micro_gather``, ``micro_soa``, ``micro_layout``, ``micro_binned``,
``micro_footprint``, ``micro_sortkeys``) on the CPU at small sizes,
against the JAX tools' own functions or printout.

* ``micro_gather``, ``micro_soa``, ``micro_layout``: JAX's tools run
  their work at import, so their functions are taken from the source with
  ``ast`` (the ``def``s, and the lambdas passed to ``timeit``) and run
  under ``jax.disable_jit()`` on the same numpy inputs (N = 4,096, seeded)
  as the port's.  Gathers, the one-hot matmul and the argsort must be
  equal; the float chains (the select chain, the dot chains, the shading)
  agree within rtol 1e-5 / atol 1e-6.  The shading is not bit for bit:
  torch's ``x ** 5`` is a ``pow`` while JAX's is ``integer_pow``
  (repeated multiplies), and the three-term luminance matvec rounds
  differently; the x4 accumulators hold the same tolerance.
* ``micro_binned``: the sort order against JAX's ``_bounce_sort_keys``
  argsort; the rays operand against JAX's ``front`` (extracted, eager);
  B5's entries, the per-group super stats, the pair capacity, pairs,
  total and overflow, the pair gather, and B2 on the pair tiles against
  JAX's ``_launch_cull_perray``, ``_pair_capacity``, ``_binned_pairs``
  and ``_launch`` in interpret mode with the exact reciprocal
  (``tests/test_torch_traversal.py``): equal, and B2's winners up to
  verified near-ties, t within 2e-6 along the triangle's normal
  (``SCALE_TOL``: the rays start on the radius-2 mesh;
  ``assert_pair_hits_match`` says why).
* ``micro_footprint``: JAX's ``main()`` at 16 x 16 on ``uv_sphere(40,
  60)``; its lines must equal the port's records printed the same way
  (so equal to the printed precision).  JAX's ``mesh_hit_fn`` is asked
  for ``method="dense"`` there: under ``jax.disable_jit()`` its Pallas
  kernels run in interpret mode op by op (44 s at this size); the dense
  sweep gives the same closest hits on this convex mesh.
* ``micro_sortkeys``: a ``micro_pg2_split`` dump written by the port;
  JAX's ``main()`` on it must print the port's lines.
"""

import ast
import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models.pathtracer import _bounce_sort_keys as jax_sort_keys
from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.ops import traversal as tr
from srt_tpu_torch.tools import (micro_binned, micro_footprint, micro_gather,
                                 micro_layout, micro_pg2_split,
                                 micro_sortkeys, micro_soa)
from tests.test_torch_traversal import exact_reciprocal  # noqa: F401
from tests.test_torch_traversal import j, port_scene_of

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096
ROWS, COLS = 40, 60
SCALE_TOL = 2e-6    # 1e-6 of the radius-2 sphere the binned rays start on


def _module_of(tool):
    path = os.path.join(ROOT, "tools", f"{tool}.py")
    return path, ast.parse(open(path).read())


def jax_functions(tool, **glob):
    """JAX's functions of ``tools/{tool}.py`` without running the module:
    every ``def`` but ``timeit`` (decorators kept), and each ``timeit``
    line's function under its label.  ``glob`` gives the module globals
    they read."""
    path, tree = _module_of(tool)
    env = dict(jax=jax, jnp=jnp, **glob)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name != "timeit":
            module = ast.fix_missing_locations(
                ast.Module(body=[node], type_ignores=[]))
            exec(compile(module, path, "exec"), env)
    for node in tree.body:
        call = getattr(node, "value", None)
        if (isinstance(node, ast.Expr) and isinstance(call, ast.Call)
                and getattr(call.func, "id", None) == "timeit"):
            env[call.args[0].value] = eval(
                compile(ast.Expression(call.args[1]), path, "eval"), env)
    return env


def as_numpy(out):
    if isinstance(out, (tuple, list)):
        return np.stack([np.asarray(x) for x in out])
    return np.asarray(out)


def jax_call(fn, args):
    with jax.disable_jit():
        return as_numpy(fn(*[jnp.asarray(a.numpy()) for a in args]))


def assert_float_chain(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# (a) micro_gather, micro_soa, micro_layout
# ---------------------------------------------------------------------------

def gather_data():
    g = np.random.default_rng(0)
    d = dict(table=g.normal(size=(1280, 3)), table1=g.normal(size=1280),
             small=g.normal(size=(6, 3)), idx=g.integers(0, 1280, N),
             idx6=g.integers(0, 6, N), occ=g.integers(0, 2, (512, 10)),
             a=g.normal(size=(N, 3)))
    d = {k: (v.astype(np.float32) if v.dtype == np.float64
             else v.astype(np.int32)) for k, v in d.items()}
    d["m"] = d["idx"] > 640
    return d


GATHER_EXACT = ("gather [N] from [1280,3]", "gather [N] from [1280]",
                "gather [N] from [6,3]", "onehot matmul [N] from [6,3]",
                "gather x6 from [1280,3]", "argsort [512,10]")


@pytest.mark.parametrize("label", GATHER_EXACT + ("where chain x20 [N,3]",))
def test_micro_gather_matches_jax(label):
    d = gather_data()
    port = {k: torch.as_tensor(v) for k, v in d.items()}
    for k in ("idx", "idx6"):
        port[k] = port[k].long()
    cases = {what: (fn, args) for what, fn, args in micro_gather.cases(port)}
    assert set(cases) == set(GATHER_EXACT) | {"where chain x20 [N,3]"}
    fns = jax_functions("micro_gather", **{
        k: jnp.asarray(d[k]) for k in ("table", "table1", "small")})
    fn, args = cases[label]
    got = fn(*args).numpy()
    want = jax_call(fns[label], args)
    if label in GATHER_EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        assert_float_chain(got, want)


@pytest.mark.parametrize("case", range(3))
def test_micro_soa_matches_jax(case):
    g = np.random.default_rng(1)
    a, b = (torch.as_tensor(g.normal(size=(N, 3)).astype(np.float32))
            for _ in range(2))
    _, fn, args = micro_soa.cases(a, b)[case]
    want = jax_call(jax_functions("micro_soa")[fn.__name__], args)
    got = as_numpy(fn(*args))
    assert np.isfinite(want).any()
    assert_float_chain(got, want)


@pytest.mark.parametrize("case", range(4))
def test_micro_layout_matches_jax(case):
    g = np.random.default_rng(2)

    def unit():
        x = g.normal(size=(N, 3)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    data = tuple(torch.as_tensor(x) for x in (
        unit(), unit(), unit(), g.uniform(size=(N, 3)).astype(np.float32),
        g.uniform(size=N).astype(np.float32),
        g.uniform(size=N).astype(np.float32)))
    _, fn, args = micro_layout.cases(data)[case]
    want = jax_call(jax_functions("micro_layout", n=N)[fn.__name__], args)
    got = as_numpy(fn(*args))
    assert np.isfinite(want).all() and np.abs(want).max() > 0.0
    assert_float_chain(got, want)


# ---------------------------------------------------------------------------
# (b) micro_binned
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def three_supers(exact_reciprocal):
    """uv_sphere(40, 60, radius 2): 37 clusters, 3 supers."""
    js = jax_mesh.upload(jax_flatten(
        [jax_procgen.uv_sphere(ROWS, COLS, radius=2.0)], pad_to=128))
    return js, port_scene_of(js)


@pytest.fixture(scope="module")
def binned_rays():
    return micro_binned.random_rays(N, "cpu", seed=3)


def test_micro_binned_sort_order_matches_jax(binned_rays):
    o, d, o_s, d_s = binned_rays
    with jax.disable_jit():
        keys = jax_sort_keys(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                             jnp.ones((N,), bool))
        want = np.asarray(jnp.argsort(keys, stable=True))
    order = micro_binned.sort_order(o, d).numpy()
    np.testing.assert_array_equal(order, want)
    np.testing.assert_array_equal(o_s.numpy(), o.numpy()[:, want])
    np.testing.assert_array_equal(d_s.numpy(), d.numpy()[:, want])


def test_micro_binned_front_matches_jax(three_supers, binned_rays):
    """``pack_rays`` packs every ray as JAX's ``front`` does; the super
    bounds are equal."""
    js, ps = three_supers
    _, _, o_s, d_s = binned_rays
    path, tree = _module_of("micro_binned")
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "front")
    env = dict(jnp=jnp, tp=jax_tp, scene=js, tile=micro_binned.TILE,
               transform_rays=jax_mesh.transform_rays)
    exec(compile(ast.fix_missing_locations(
        ast.Module(body=[node], type_ignores=[])), path, "exec"), env)
    with jax.disable_jit():
        want8, want_sb = env["front"](jnp.asarray(o_s.numpy()),
                                      jnp.asarray(d_s.numpy()),
                                      jnp.full((N,), jnp.inf))
    rays8, sbounds = micro_binned.front(ps, o_s, d_s)
    np.testing.assert_array_equal(rays8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(sbounds.numpy(), np.asarray(want_sb))


def test_micro_binned_stages_match_jax(three_supers, binned_rays):
    js, ps = three_supers
    _, _, o_s, d_s = binned_rays
    tile = micro_binned.TILE
    rays8, sbounds = micro_binned.front(ps, o_s, d_s)
    got = micro_binned.pipeline(ps, rays8, sbounds)
    # B5 and the per-group super stats.
    e = np.asarray(jax_tp._launch_cull_perray(j(rays8), j(sbounds), tile,
                                              True))
    np.testing.assert_array_equal(got["e"].numpy(), e)
    occ = (e < jax_tp.BIG).sum(1)
    stats = micro_binned.group_supers(got["e"])
    assert stats == dict(groups=occ.size, mean=occ.mean(),
                         p90=np.percentile(occ, 90),
                         p99=np.percentile(occ, 99), max=occ.max())
    assert 1 <= stats["mean"] <= 3 and stats["max"] == 3
    # Capacity, pairs, total, overflow.
    n_groups, s = e.shape
    gpt = tile // tr.GROUP
    p_cap = jax_tp._pair_capacity(n_groups, s, gpt, 8)
    assert got["p_cap"] == p_cap
    ref = jax_tp._binned_pairs(jnp.asarray(e), gpt, p_cap)
    for a, b in zip(got["pairs"], ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    total = int(got["pairs"][3])
    assert 0 < total <= p_cap
    # The pair gather (JAX's gath) and B2 on the pair tiles (JAX's kern).
    pair_grp, tile_super, tile_counts, _ = ref
    rays_grp = j(rays8).reshape(n_groups, tr.GROUP * 8)
    dead = jnp.tile(jnp.array([0., 0., 0., 1., 1., 1., 0., 0.], jnp.float32),
                    (1, tr.GROUP))
    pr = jnp.concatenate([rays_grp, dead], axis=0)[pair_grp].reshape(
        p_cap * tr.GROUP, 8)
    np.testing.assert_array_equal(got["pr"].numpy(), np.asarray(pr))
    woop, cb = tr.model_tables(ps, 0)[:2]
    ref_t, ref_i = jax_tp._launch(
        tile_counts, tile_super, jnp.zeros((p_cap // gpt, 1), jnp.float32),
        pr, j(cb), j(woop), tile, True)
    t, i = got["hit"]
    assert int((i >= 0).sum()) > N // 4
    assert_pair_hits_match(ref_t, ref_i, t, i, got["pr"], woop, ps)


def assert_pair_hits_match(ref_t, ref_i, t, i, pr, woop, scene):
    """B2's pair hits against JAX's: hit masks equal; winners equal but at
    near-ties (both triangles valid for the ray, candidate t within
    ``SCALE_TOL`` of each other), at most 0.5% of the hits; for equal
    winners, t within ``SCALE_TOL`` along the triangle's normal (|dt| *
    |cos| between ray and normal).  The rays start on the radius-2 mesh,
    so many hit within t ~ 0.01 of their origin at a grazing angle: a
    candidate t carries the rounding of coordinates of size 2 (XLA
    contracts the Woop multiply-adds, torch rounds each), divided by that
    cosine, so ``tests/test_torch_traversal.py``'s t-relative rule does
    not apply."""
    ref_t, ref_i = np.asarray(ref_t)[:, 0], np.asarray(ref_i)[:, 0]
    t, i = t.numpy()[:, 0], i.numpy()[:, 0]
    np.testing.assert_array_equal(i >= 0, ref_i >= 0)
    bad = np.nonzero(ref_i != i)[0]
    assert len(bad) <= max(1, (ref_i >= 0).sum() // 200), bad
    for r in bad:
        ts = []
        for tri in (ref_i[r], i[r]):
            c, lane = divmod(int(tri), tr.CLUSTER)
            t_c, valid = tr._woop_candidates(
                [pr[r, q].reshape(1, 1) for q in range(3)],
                [pr[r, 3 + q].reshape(1, 1) for q in range(3)],
                woop[c:c + 1, :13, lane:lane + 1], False)
            assert bool(valid), (r, tri)
            ts.append(float(t_c))
        assert abs(ts[0] - ts[1]) <= SCALE_TOL, (r, ts)
    same = np.nonzero((ref_i >= 0) & (ref_i == i))[0]
    v0, v1, v2 = (x.numpy()[i[same]] for x in (scene.tri_v0, scene.tri_v1,
                                               scene.tri_v2))
    nrm = np.cross(v1 - v0, v2 - v0)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    cos = np.abs((pr.numpy()[same, 3:6] * nrm).sum(1))
    along = np.abs(t[same] - ref_t[same]) * cos
    assert along.max() <= SCALE_TOL, (same[along.argmax()], along.max())
    np.testing.assert_array_equal(t[ref_i < 0], ref_t[ref_i < 0])


# ---------------------------------------------------------------------------
# (c) micro_footprint, (d) micro_sortkeys
# ---------------------------------------------------------------------------

def jax_main_lines(tool, argv, monkeypatch, patch_dense=False):
    """Run JAX's ``tools/{tool}.py`` ``main()`` under
    ``jax.disable_jit()`` at the test's sizes; its printed lines."""
    import importlib.util
    monkeypatch.setenv("SRT_BENCH_ROWS", str(ROWS))
    monkeypatch.setenv("SRT_BENCH_COLS", str(COLS))
    monkeypatch.setenv("SRT_BENCH_SIZE", "16")
    monkeypatch.setattr(sys, "argv", [tool] + argv)
    if patch_dense:
        real = jax_mesh.mesh_hit_fn
        monkeypatch.setattr(jax_mesh, "mesh_hit_fn", lambda s, method=None,
                            **kw: real(s, method="dense", **kw))
    spec = importlib.util.spec_from_file_location(
        f"jax_{tool}", os.path.join(ROOT, "tools", f"{tool}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), jax.disable_jit(), \
            np.errstate(all="ignore"):
        module.main()
    return buf.getvalue().splitlines()


def test_micro_footprint_matches_jax_printout(three_supers, monkeypatch):
    _, ps = three_supers
    recs = micro_footprint.run("cpu", ps, size=16, verbose=False)
    want = jax_main_lines("micro_footprint", [], monkeypatch,
                          patch_dense=True)
    assert [r["bounce"] for r in recs] == [1, 2]
    assert recs[0]["shadow"] is None and recs[1]["shadow"] is not None
    assert [ln for r in recs for ln in micro_footprint.lines(r)] == want


@pytest.fixture(scope="module")
def pg2_dump(three_supers, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dump") / "rays.npz")
    micro_pg2_split.run("cpu", three_supers[1], size=32, dump=path,
                        dump_only=True, verbose=False)
    return path


@pytest.mark.parametrize("bounce", [0, 1])
def test_micro_sortkeys_matches_jax_printout(three_supers, pg2_dump, bounce,
                                             monkeypatch):
    with np.errstate(all="ignore"):
        recs = micro_sortkeys.run("cpu", three_supers[1], dump=pg2_dump,
                                  bounce=bounce, verbose=False)
    want = jax_main_lines("micro_sortkeys", [pg2_dump, str(bounce)],
                          monkeypatch)
    cases = [r["case"] for r in recs]
    assert cases[:2] == ["footprint", "shadow"]
    # Bounce 2's rays (index 1) almost never hit again on this convex
    # mesh, so its shadow batch is empty (JAX prints nan there too).
    assert (recs[1]["rays"] > 0) == (bounce == 0)
    assert cases.count("key") == 8
    assert "\n".join(micro_sortkeys.line(r) for r in recs).splitlines() \
        == want
