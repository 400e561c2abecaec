"""PyTorch port vs JAX package: the four walk kernels' plain versions
against the interpret-mode Pallas launches, and ``model_hit`` against
``pallas_model_hit``.

Every comparison feeds both sides the same operands (rays8 and tables
from the port, as numpy).  Interpret mode evaluates
``pl.reciprocal(approx=True)`` through bfloat16, which leaves ~1e-5
relative error in the Pallas candidate t even after its Newton step and
flips winners between triangles that near-tie; the ``exact_reciprocal``
fixture therefore runs the Pallas kernels with an exact reciprocal (the
port's arithmetic) by swapping the ``pl`` name inside
``traversal_pallas`` for this module only, and clears JAX's caches on
both sides so no patched trace outlives it.

Cull outputs must be equal, hit masks equal and candidate t within rtol
1e-6.  Winner ids must be equal except at float near-ties: XLA on the CPU
contracts the Woop multiply-adds into FMAs and torch rounds each
operation, so two triangles whose candidate t agree to ~1 ulp can swap.
Each such ray is checked to be a genuine near-tie (both triangles valid
for the ray, port candidate t within 1e-6 relative), and at most 0.5% of
the hits may be one.  One test (``shipped_pallas``) holds ``model_hit``
against the unpatched package at a looser tolerance stated there."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pl

from srt_tpu.models import mesh as jax_mesh
from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.models import mesh
from srt_tpu_torch.ops import traversal as tr
from tests.test_mesh import random_rays

torch.set_num_threads(2)

N_RAYS = 1024
TILE = 128


class _ExactReciprocalPallas(types.ModuleType):
    """``jax.experimental.pallas`` with an exact ``reciprocal``."""

    def __getattr__(self, name):
        return getattr(jax_pl, name)

    @staticmethod
    def reciprocal(x, approx=False):
        return 1.0 / x


@pytest.fixture(scope="module")
def exact_reciprocal():
    jax.clear_caches()
    saved = jax_tp.pl
    jax_tp.pl = _ExactReciprocalPallas("pallas_exact_reciprocal")
    try:
        yield
    finally:
        jax_tp.pl = saved
        jax.clear_caches()


def port_scene_of(jax_scene):
    d = {f: (None if getattr(jax_scene, f) is None
             else np.asarray(getattr(jax_scene, f))) for f in mesh.ARRAY_FIELDS}
    static = {k: getattr(jax_scene, k) for k in mesh.STATIC_FIELDS}
    return mesh.scene_from_arrays(d, static, "cpu")


@pytest.fixture(scope="module")
def scenes(exact_reciprocal):
    """uv_sphere(40, 60): 37 clusters, 3 superclusters."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(40, 60)],
                                     pad_to=128))
    return js, port_scene_of(js)


def ray_batch(seed, mixed, any_hit=False):
    """[3, N] rays made as ``tests/test_mesh.random_rays`` makes them, as
    (jax origins, jax dirs, jax t_max) and torch counterparts.  ``mixed``
    kills every third ray; ``any_hit`` clips live rays to a 4.5 segment."""
    o, d = random_rays(N_RAYS, seed=seed)
    t = np.full(N_RAYS, np.inf, np.float32)
    if mixed:
        t[::3] = 0.0
    if any_hit:
        t = np.where(t > 0, 4.5, 0.0).astype(np.float32)
    return (o, d, jnp.asarray(t)), tuple(
        torch.as_tensor(np.array(x)) for x in (o, d, t))


def operands(scene, seed, mixed, any_hit):
    """Shared launch operands: rays8 and the walk tables (torch), plus the
    pg2 cull's padded cluster table and bitpack matrix (numpy, JAX side)."""
    _, (o, d, t) = ray_batch(seed, mixed, any_hit)
    rays8, _, _ = tr.pack_rays(scene, 0, o, d, t, TILE,
                               t_lo=1e-2 if any_hit else 0.0)
    woop, cb, sbounds, cb8, s, n_cl = tr.model_tables(scene, 0)
    return dict(rays8=rays8, woop=woop, cb=cb, sbounds=sbounds, cb8=cb8,
                s=s, **pg2_jax_tables(cb8, s, n_cl))


def pg2_jax_tables(cb8, s, n_cl):
    """The JAX pg2 cull's padded cluster table ``cb8_j`` and bitpack matrix
    ``w_bp`` (numpy) for the port's cb8 [8, 16*s] of n_cl real clusters."""
    c_pad = -(-cb8.shape[1] // jax_tp.CHUNK_C) * jax_tp.CHUNK_C
    cb8_j = np.full((8, c_pad), np.nan, np.float32)
    cb8_j[:, :cb8.shape[1]] = cb8.numpy()
    cb8_j[6:] = 0.0
    c_idx = np.arange(c_pad)
    w_bp = np.where((c_idx[:, None] < n_cl)
                    & (c_idx[:, None] // tr.SUPER == np.arange(s)[None, :]),
                    (1 << (c_idx % tr.SUPER))[:, None], 0).astype(np.float32)
    return dict(cb8_j=cb8_j, w_bp=w_bp)


def j(x):
    return jnp.asarray(np.asarray(x))


def assert_winners_equal(ref_i, got_i, rays8, woop, nested, lo=0):
    """Equal winner ids, except at verified float near-ties (module
    doc).  ``ref_i``/``got_i`` [N] global ids (-1 miss); ``rays8`` the
    launch rays (model space); ``lo`` the model's first triangle."""
    ref_i, got_i = np.asarray(ref_i).reshape(-1), got_i.numpy().reshape(-1)
    np.testing.assert_array_equal(ref_i >= 0, got_i >= 0)
    bad = np.nonzero(ref_i != got_i)[0]
    assert len(bad) <= max(1, (ref_i >= 0).sum() // 200), bad
    for r in bad:
        ts = []
        for tri in (ref_i[r] - lo, got_i[r] - lo):
            c, lane = divmod(int(tri), tr.CLUSTER)
            ray = rays8[r]
            t, valid = tr._woop_candidates(
                [ray[q].reshape(1, 1) for q in range(3)],
                [ray[3 + q].reshape(1, 1) for q in range(3)],
                woop[c:c + 1, :13, lane:lane + 1], nested)
            assert bool(valid), (r, tri)
            ts.append(float(t))
        assert abs(ts[0] - ts[1]) <= 1e-6 * abs(ts[0]), (r, ts)


def assert_walk_equal(ref_t, ref_i, t, i, op, nested):
    ref_t = np.asarray(ref_t)
    assert_winners_equal(ref_i, i, op["rays8"], op["woop"], nested)
    hit = np.asarray(ref_i)[:, 0] >= 0
    assert hit.any()
    np.testing.assert_allclose(t.numpy()[hit], ref_t[hit], rtol=1e-6)
    np.testing.assert_array_equal(t.numpy()[~hit], ref_t[~hit])


def assert_hits_match(ref, got, rays8, woop, nested):
    """``model_hit`` outputs against ``pallas_model_hit``'s: winners as in
    ``assert_winners_equal``; refined t, u, v of equal winners within
    rtol 1e-6; misses at +inf."""
    assert_winners_equal(ref[1], got[1], rays8, woop, nested)
    hit = np.asarray(ref[1]) >= 0
    same = hit & (np.asarray(ref[1]) == got[1].numpy())
    for a, b in zip(got[0::2], ref[0::2]):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=1e-6, atol=1e-7)
    assert np.isinf(got[0].numpy()[~hit]).all()


@pytest.mark.parametrize("mixed", [False, True], ids=["live", "mixed"])
def test_cull_matches_pallas(scenes, mixed):
    op = operands(scenes[1], 7, mixed, False)
    ref = jax_tp._launch_cull(j(op["rays8"]), j(op["sbounds"]), TILE, True)
    got = tr.cull(op["rays8"], op["sbounds"], TILE)
    assert int(got[2].sum()) > 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("mixed", [False, True], ids=["live", "mixed"])
def test_intersect_matches_pallas(scenes, mixed, any_hit):
    op = operands(scenes[1], 7, mixed, any_hit)
    clist, elist, counts = jax_tp._launch_cull(j(op["rays8"]),
                                               j(op["sbounds"]), TILE, True)
    ref_t, ref_i = jax_tp._launch(counts, clist, elist, j(op["rays8"]),
                                  j(op["cb"]), j(op["woop"]), TILE, True,
                                  any_hit=any_hit)
    t, i = tr.intersect(*(torch.tensor(np.asarray(x))
                          for x in (counts, clist, elist)),
                        op["rays8"], op["cb"], op["woop"], TILE, any_hit)
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=False)


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("mixed", [False, True], ids=["live", "mixed"])
def test_cull_pg2_matches_pallas(scenes, mixed, group):
    op = operands(scenes[1], 11, mixed, False)
    ref = jax_tp._launch_cull_pg2(j(op["rays8"]), j(op["cb8_j"]),
                                  j(op["w_bp"]), TILE, True, group=group)
    got = tr.cull_pg2(op["rays8"], op["cb8"], op["s"], group, op["sbounds"])
    assert int(got[2].sum()) > 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("mixed", [False, True], ids=["live", "mixed"])
def test_pgwalk2_matches_pallas(scenes, mixed, group, any_hit):
    op = operands(scenes[1], 11, mixed, any_hit)
    lists = jax_tp._launch_cull_pg2(j(op["rays8"]), j(op["cb8_j"]),
                                    j(op["w_bp"]), TILE, True, group=group)
    ref_t, ref_i = jax_tp._launch_pgwalk2(*lists, j(op["rays8"]),
                                          j(op["woop"]), True,
                                          any_hit=any_hit, group=group,
                                          ewidth=4)
    t, i = tr.pgwalk2(*(torch.tensor(np.asarray(x)) for x in lists),
                      op["rays8"], op["woop"], group, any_hit)
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=True)


@pytest.mark.parametrize("walk", [False, "pg2:32:4"], ids=["tiled", "pg2"])
def test_model_hit_matches_pallas(scenes, walk):
    """Whole wrapper: root clip, padding, tables, dispatch, exact refine."""
    js, ps = scenes
    for mixed in (False, True):
        (o, d, t), (po, pd, pt) = ray_batch(3, mixed)
        ref = jax_tp.pallas_model_hit(js, 0, o, d, t, tile=TILE, binned=walk)
        got = tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk)
        rays8, _, _ = tr.pack_rays(ps, 0, po, pd, pt, TILE)
        assert_hits_match(ref, got, rays8, ps.woop, bool(walk))


@pytest.fixture
def shipped_pallas(exact_reciprocal):
    """The JAX package as shipped (approximate reciprocal) for one test."""
    jax.clear_caches()
    jax_tp.pl = jax_pl
    try:
        yield
    finally:
        jax_tp.pl = _ExactReciprocalPallas("pallas_exact_reciprocal")
        jax.clear_caches()


@pytest.mark.parametrize("walk", [False, "pg2:32:4"], ids=["tiled", "pg2"])
def test_model_hit_matches_shipped_pallas(scenes, shipped_pallas, walk):
    """``model_hit`` against the unpatched ``pallas_model_hit``, so drift
    in the reference's own arithmetic shows.  Its bfloat16-rounded
    approximate reciprocal leaves ~1e-5 relative error in candidate t
    after the Newton step, so winners may swap between triangles whose
    candidates lie that close (at shared edges, where one may fall just
    outside the exact edge slop).  Hit masks stay exact; the refined t of
    every hit agrees within rtol 1e-5 whichever triangle won; at most
    0.5% of hits swap; u/v of equal winners within rtol 1e-6."""
    js, ps = scenes
    for seed in (4, 7):
        for mixed in (False, True):
            (o, d, t), (po, pd, pt) = ray_batch(seed, mixed)
            ref = jax_tp.pallas_model_hit(js, 0, o, d, t, tile=TILE,
                                          binned=walk)
            got = tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk)
            ref_i, got_i = np.asarray(ref[1]), got[1].numpy()
            hit = ref_i >= 0
            np.testing.assert_array_equal(got_i >= 0, hit)
            assert hit.any()
            assert (ref_i != got_i).sum() <= max(1, hit.sum() // 200)
            np.testing.assert_allclose(got[0].numpy()[hit],
                                       np.asarray(ref[0])[hit], rtol=1e-5)
            same = hit & (ref_i == got_i)
            for a, b in zip(got[2:], ref[2:]):
                np.testing.assert_allclose(a.numpy()[same],
                                           np.asarray(b)[same],
                                           rtol=1e-6, atol=1e-7)
            assert np.isinf(got[0].numpy()[~hit]).all()


def test_cpu_tensors_launch_no_kernel(scenes):
    """CPU tensors run every walk's plain version: no kernel launch is
    counted; only the pair-binned walk's branch counters move."""
    from srt_tpu_torch.ops.cuda_lib import BRANCH_COUNTERS
    _, ps = scenes
    _, (o, d, t) = ray_batch(5, True)
    tr.reset_launch_counts()
    for walk in (False, "pg2:16:4", True, "pg"):
        for any_hit in (False, True):
            tr.model_hit(ps, 0, o, d, t, tile=TILE, binned=walk,
                         any_hit=any_hit)
    counts = dict(tr.launch_counts)
    assert counts.pop("binned_pairs") + counts.pop("binned_fallback") == 2
    assert set(BRANCH_COUNTERS).isdisjoint(counts)
    assert all(v == 0 for v in counts.values())
