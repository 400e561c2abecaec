"""PyTorch port vs JAX package: the pair-binned walk (B5, the pair
binning, B2 on pair tiles, the segment-min combine, the overflow
fallback) and the mask-scan walk (B6, B7), their dispatch in
``model_hit``, and the render plan through either walk.

Operands, the exact-reciprocal patch and the near-tie rule (winner ids
exact up to verified 1-ulp near-ties, hit masks exact) are those of
``tests/test_torch_traversal.py``; its model, ``uv_sphere(40, 60)``, has
37 clusters in 3 superclusters.  B5's entries, the pair binning and B6's
masks must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import fastpath as jax_fastpath
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import fastpath, mesh
from srt_tpu_torch.ops import rng
from srt_tpu_torch.ops import traversal as tr
from srt_tpu_torch.scene import lights_from_arrays
from srt_tpu_torch.utils import procgen
from srt_tpu_torch.utils.flatten import flatten_models
from tests.test_torch_traversal import (  # noqa: F401  (fixtures)
    exact_reciprocal, scenes)
from tests.test_torch_traversal import (TILE, assert_hits_match,
                                        assert_walk_equal, j, operands,
                                        port_scene_of, ray_batch)

torch.set_num_threads(2)

WALKERS = ("cull", "intersect", "intersect_stream", "cull_pg2", "pgwalk2",
           "cull_perray", "cull_gmask", "pgwalk")


@pytest.fixture
def spy(monkeypatch):
    """Record the names of the traversal wrappers that run, in order."""
    calls = []
    for name in WALKERS:
        def call(*a, _fn=getattr(tr, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tr, name, call)
    return calls


@pytest.mark.parametrize("mixed", [False, True], ids=["live", "mixed"])
def test_cull_perray_matches_pallas(scenes, mixed):
    op = operands(scenes[1], 7, mixed, False)
    ref = jax_tp._launch_cull_perray(j(op["rays8"]), j(op["sbounds"]), TILE,
                                     True)
    got = tr.cull_perray(op["rays8"], op["sbounds"])
    assert (got < tr.BIG).any() and (got == tr.BIG).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("factor", [1, 3, 8])
def test_binned_pairs_match_jax(scenes, factor):
    """Same entries in, same capacity, pair slots, tile supers, tile
    counts and total out; at factor 1 the pairs overflow and the slots
    past the capacity are dropped, at factor 3 they fill it exactly."""
    op = operands(scenes[1], 7, True, False)
    e = np.asarray(jax_tp._launch_cull_perray(j(op["rays8"]),
                                              j(op["sbounds"]), TILE, True))
    n_groups, s = e.shape
    gpt = TILE // tr.GROUP
    p_cap = tr.pair_capacity(n_groups, s, gpt, factor)
    assert p_cap == jax_tp._pair_capacity(n_groups, s, gpt, factor)
    ref = jax_tp._binned_pairs(jnp.asarray(e), gpt, p_cap)
    got = tr.binned_pairs(torch.tensor(e), gpt, p_cap)
    assert (int(got[3]) > p_cap) == (factor == 1)
    assert (int(got[3]) == p_cap) == (factor == 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mixed", [False, True], ids=["live", "mixed"])
def test_cull_gmask_matches_pallas(scenes, mixed):
    op = operands(scenes[1], 11, mixed, False)
    ref = jax_tp._launch_cull_gmask(j(op["rays8"]), j(op["cb8_j"]),
                                    j(op["w_bp"]), TILE, True)
    got = tr.cull_gmask(op["rays8"], op["cb8"], op["s"], op["sbounds"])
    assert (got != 0).any() and (got == 0).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("mixed", [False, True], ids=["live", "mixed"])
def test_pgwalk_matches_pallas(scenes, mixed, any_hit):
    op = operands(scenes[1], 11, mixed, any_hit)
    mask = jax_tp._launch_cull_gmask(j(op["rays8"]), j(op["cb8_j"]),
                                     j(op["w_bp"]), TILE, True)
    ref_t, ref_i = jax_tp._launch_pgwalk(mask, j(op["rays8"]), j(op["woop"]),
                                         True, any_hit=any_hit)
    t, i = tr.pgwalk(torch.tensor(np.asarray(mask)), op["rays8"], op["woop"],
                     any_hit)
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=False)


@pytest.mark.parametrize("n", [1024, 700])
@pytest.mark.parametrize("walk", [True, "pg"], ids=["binned", "pg"])
def test_model_hit_matches_pallas(scenes, monkeypatch, walk, n):
    """Whole wrapper in both binned modes.  At n = 700 and tile 128,
    padding to the tile (768 rays) and to JAX's 8-tile windows (1,024)
    give different pair capacities (384 and 512 slots): the port pads as
    JAX does, so capacity, total and branch are JAX's."""
    js, ps = scenes
    seen = []

    def record(e_group, gpt, p_cap, _fn=tr.binned_pairs):
        out = _fn(e_group, gpt, p_cap)
        seen.append((p_cap, int(out[3])))
        return out
    monkeypatch.setattr(tr, "binned_pairs", record)
    npad = -(-n // (TILE * 8)) * TILE * 8
    for mixed in (False, True):
        (o, d, t), (po, pd, pt) = ray_batch(3, mixed)
        o, d, t = o[:, :n], d[:, :n], t[:n]
        po, pd, pt = po[:, :n], pd[:, :n], pt[:n]
        ref = jax_tp.pallas_model_hit(js, 0, o, d, t, tile=TILE, binned=walk)
        got = tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk)
        rays8, _, _ = tr.pack_rays(ps, 0, po, pd, pt, TILE * 8)
        assert rays8.shape[0] == npad
        assert (np.asarray(ref[1]) >= 0).any()
        assert_hits_match(ref, got, rays8, ps.woop, nested=False)
        if walk is True:
            sbounds = tr.model_tables(ps, 0)[2]
            e = jax_tp._launch_cull_perray(j(rays8), j(sbounds), TILE, True)
            p_cap = jax_tp._pair_capacity(npad // 8, 3, TILE // 8, 8)
            total = int(jax_tp._binned_pairs(e, TILE // 8, p_cap)[3])
            assert seen.pop() == (p_cap, total) and total <= p_cap
    assert not seen


def test_pair_factor_fallback_and_boundary(scenes, spy):
    """``pair_factor=1`` overflows: one fallback, and the result is the
    tiled walk's exactly.  Rays that share one footprint put the pair
    total at m * n_groups (m supers entered), so ``pair_factor=m`` gives
    a capacity equal to the total, which takes the pair branch (the
    ``<=`` of JAX's ``lax.cond``); m - 1 falls back."""
    _, ps = scenes
    _, (o, d, t) = ray_batch(3, True)
    tr.reset_launch_counts()
    ref = tr.model_hit(ps, 0, o, d, t, tile=TILE)
    spy.clear()
    got = tr.model_hit(ps, 0, o, d, t, tile=TILE, binned=True, pair_factor=1)
    assert spy == ["cull_perray", "cull", "intersect"]
    assert (tr.launch_counts["binned_fallback"],
            tr.launch_counts["binned_pairs"]) == (1, 0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)

    n = 1024
    o1 = torch.tensor([[0.05], [0.1], [5.0]]).expand(3, n).contiguous()
    d1 = torch.tensor([[0.0], [0.0], [-1.0]]).expand(3, n).contiguous()
    rays8 = tr.pack_rays(ps, 0, o1, d1, float("inf"), TILE * 8)[0]
    e = tr.cull_perray(rays8, tr.model_tables(ps, 0)[2])
    m = int((e[0] < tr.BIG).sum())
    assert m >= 2 and bool((e == e[0]).all())
    tiled = tr.model_hit(ps, 0, o1, d1, float("inf"), tile=TILE)
    assert bool((tiled[1] >= 0).all())
    for factor, branch in ((m, "binned_pairs"), (m - 1, "binned_fallback")):
        tr.reset_launch_counts()
        got = tr.model_hit(ps, 0, o1, d1, float("inf"), tile=TILE,
                           binned=True, pair_factor=factor)
        assert tr.launch_counts[branch] == 1
        for a, b in zip(got, tiled):
            assert torch.equal(a, b)
    n_groups = n // tr.GROUP
    assert tr.pair_capacity(n_groups, 3, TILE // 8, m) == m * n_groups


@pytest.mark.parametrize("walk", [True, "pg"], ids=["binned", "pg"])
def test_binned_dispatch(scenes, monkeypatch, spy, walk):
    """JAX's conditions: on a streamed model both binned modes take the
    tiled walk with B2s; on a one-super model the tiled walk with the
    one-entry list; ``count_evals`` raises."""
    js, ps = scenes
    (o, d, t), (po, pd, pt) = ray_batch(3, True)
    tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk)
    assert spy == (["cull_perray", "intersect"] if walk is True
                   else ["cull_gmask", "pgwalk"])

    spy.clear()
    monkeypatch.setattr(tr, "STREAM_THRESHOLD_CLUSTERS", 36)   # 37 clusters
    got = tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk)
    assert spy == ["cull", "intersect_stream"]
    ref = jax_tp.pallas_model_hit(js, 0, o, d, t, tile=TILE, binned=walk,
                                  stream=True)
    assert_hits_match(ref, got, tr.pack_rays(ps, 0, po, pd, pt, TILE)[0],
                      ps.woop, nested=False)

    small = mesh.upload(flatten_models([procgen.uv_sphere(12, 18)],
                                       pad_to=128), device="cpu")
    assert mesh.n_superclusters(small) == 1
    spy.clear()
    got = tr.model_hit(small, 0, po, pd, pt, tile=TILE, binned=walk)
    assert spy == ["intersect"]
    for a, b in zip(got, tr.model_hit(small, 0, po, pd, pt, tile=TILE)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="tiled walk only"):
        tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk,
                     count_evals=True)


@pytest.fixture(scope="module")
def plan_scene(exact_reciprocal):
    """uv_sphere(50, 170): 131 clusters, 9 superclusters, so the JAX plan
    takes the compact wavefront path; resident walks."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(50, 170)],
                                     pad_to=128))
    jl = jax_lights()
    pl = lights_from_arrays({k: np.asarray(getattr(jl, k))
                             for k in ("position", "color", "intensity")},
                            "cpu")
    return js, port_scene_of(js), jl, pl


@pytest.mark.parametrize("walk,kernels", [
    ("binned", {"cull", "intersect", "cull_perray"}),
    ("pg", {"cull", "intersect", "cull_gmask", "pgwalk"})])
def test_render_plan_matches_jax_for_one_key(plan_scene, spy, walk, kernels):
    """The slice as a whole: ``make_render_plan(walks="tiled@256,<walk>",
    walks_shadow="<walk>").render(key)`` in both packages, 32x32, two
    bounces, probed with key 0 and rendered with key 3.  Schedules and
    stats must be equal; pixels allclose (rtol 1e-4, atol 1e-5) on >=
    99.5% of the image (an ulp can flip a lobe choice; see
    tests/test_torch_render.py)."""
    js, ps, jl, pl = plan_scene
    cam = dict(width=32, height=32, origin=(0.0, 1.0, 5.0),
               look_at=(0.0, 0.0, 0.0))
    kw = dict(max_depth=2, rr_bounces=0, spp=1)
    walks = dict(walks=f"tiled@256,{walk}", walks_shadow=walk)
    j_plan = jax_fastpath.make_render_plan(js, jl, JaxCamera(**cam),
                                           JaxRenderConfig(**kw),
                                           method="pallas", **walks)
    j_img, j_st, j_ov = j_plan.render(jax.random.key(3))
    tr.reset_launch_counts()
    p_plan = fastpath.make_render_plan(ps, pl, CameraConfig(**cam),
                                       RenderConfig(**kw), **walks)
    p_img, p_st, p_ov = p_plan.render(rng.key(3, "cpu"))
    assert set(spy) == kernels
    if walk == "binned":
        assert tr.launch_counts["binned_pairs"] > 0
    assert p_plan.schedule == j_plan.schedule
    assert int(j_ov) == int(p_ov) == 0
    np.testing.assert_array_equal(p_st.numpy(), np.asarray(j_st))
    a, b = p_img.numpy(), np.asarray(j_img)
    assert a.shape == b.shape == (32, 32, 3)
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.995, \
        f"outlier pixels {np.argwhere(~close).tolist()}"
    assert a.mean() > 0.01
