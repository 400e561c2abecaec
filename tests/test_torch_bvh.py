"""PyTorch port vs JAX package: the BVH stack route (``method="bvh"``).

``intersect.ray_aabb`` (the slab test), ``bvh.validate_bvh``,
``mesh._bvh_model_hit`` (the reference's per-ray stack walk, run for all
rays at once), ``mesh_hit_fn``, ``wavefront.hit_ids`` and
``trace_edge_aware_mesh`` with ``method="bvh"``, and the refusal of a
``refit_accel``-ed scene.  The setups are those of ``tests/test_mesh.py``
and ``tests/test_features.py``; inputs are made with numpy from a seed.

Tolerances: hit masks and triangle ids equal (the BVH and dense routes
evaluate each (ray, triangle) pair with the same operations,
``intersect.mt_hits``, and the port's stack walk visits nodes in JAX's
order); t within rtol 1e-5 / atol 1e-6 (``tests/test_mesh.py``'s); the
slab distances equal, inf and NaN lanes included; images rtol 1e-4 /
atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import edge_aware_mesh as jax_eam
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.models import wavefront as jax_wavefront
from srt_tpu.ops import intersect as jax_intersect
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import bvh as jax_bvh
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import edge_aware_mesh, mesh, pathtracer, wavefront
from srt_tpu_torch.ops import intersect, rng
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.utils import bvh, procgen
from srt_tpu_torch.utils.flatten import flatten_models, set_frame

torch.set_num_threads(2)

MODELS = {"cube": lambda p: p.cube(), "rubik": lambda p: p.rubik_grid(),
          "sphere": lambda p: p.uv_sphere(8, 12)}


def random_rays(n, seed, spread=4.0):
    """``tests/test_mesh.py``'s rays: origins outside the model, aimed at
    the origin with noise; [N, 3] numpy each."""
    r = np.random.default_rng(seed)
    origins = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    origins += np.sign(origins) * 2.0
    dirs = -origins
    dirs += r.normal(0, 0.3, (n, 3)).astype(np.float32)
    return origins, dirs


def scenes(model, pad_to=1):
    """(JAX scene, port scene) of one procedural model."""
    return (jax_mesh.upload(jax_flatten([model(jax_procgen)], pad_to=pad_to)),
            mesh.upload(flatten_models([model(procgen)], pad_to=pad_to),
                        device="cpu"))


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("case", ["random", "axis-parallel"])
def test_ray_aabb_matches_jax(case):
    """The slab test against JAX's: random rays and boxes, and
    axis-parallel rays whose zero components divide to inf (and 0 * inf to
    NaN for origins on a slab plane): inf and NaN lanes equal."""
    r = np.random.default_rng(4)
    n = 512
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    lo = r.uniform(-2, 0, (n, 3)).astype(np.float32)
    hi = lo + r.uniform(0.1, 2, (n, 3)).astype(np.float32)
    if case == "axis-parallel":
        axis = r.integers(0, 3, n)
        d = np.zeros((n, 3), np.float32)
        d[np.arange(n), axis] = r.choice([-1.0, 1.0], n)
        # Every fourth origin on a box face in a zero-direction coordinate.
        other = (axis + 1) % 3
        on = np.arange(n) % 4 == 0
        o[on, other[on]] = lo[on, other[on]]
    got = intersect.ray_aabb(t(o), t(d), t(lo), t(hi)).numpy()
    want = np.asarray(jax_intersect.ray_aabb(jnp.asarray(o), jnp.asarray(d),
                                             jnp.asarray(lo),
                                             jnp.asarray(hi)))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).any() and np.isinf(got).any()
    if case == "axis-parallel":
        # 0 * inf lanes: the NaN propagates through the minima and maxima
        # (torch.minimum / amax, as jnp.minimum / max) to a miss.
        with np.errstate(divide="ignore", invalid="ignore"):
            nan_lane = np.isnan((lo - o) * (1.0 / d)).any(-1)
        assert nan_lane.any() and np.isinf(got[nan_lane]).all()


def test_validate_bvh_matches_jax():
    """``uv_sphere(16, 24)``'s BVH passes both packages' check; the same
    leaf table with one primitive duplicated fails both."""
    m = procgen.uv_sphere(16, 24)
    tree = bvh.triangle_bvh(m.positions, m.tri_vidx)
    centers = np.zeros((m.num_triangles, 3))
    bvh.validate_bvh(tree, centers)
    jax_bvh.validate_bvh(tree, centers)
    order = tree.prim_order.copy()
    order[1] = order[0]
    bad = dataclasses.replace(tree, prim_order=order)
    for check in (bvh.validate_bvh, jax_bvh.validate_bvh):
        with pytest.raises(AssertionError):
            check(bad, centers)


@pytest.mark.parametrize("name", list(MODELS))
def test_bvh_traversal_matches_dense_and_jax(name):
    """``_bvh_model_hit`` against ``_dense_model_hit`` (``tests/
    test_mesh.py``'s test: 256 rays, seed 1): equal hit masks and ids, t
    within rtol 1e-5 / atol 1e-6; ids and t equal to JAX's BVH route."""
    js, ps = scenes(MODELS[name])
    o, d = random_rays(256, seed=1)
    inf = torch.full((256,), float("inf"))
    td, id_, _, _ = mesh._dense_model_hit(ps, 0, t(o).T, t(d).T, inf)
    tb, ib, ub, vb = mesh._bvh_model_hit(ps, 0, t(o).T, t(d).T, inf)
    hit_d = torch.isfinite(td)
    hit_b = ib != -1
    assert torch.equal(hit_d, hit_b) and int(hit_b.sum()) > 0
    np.testing.assert_allclose(tb[hit_b].numpy(), td[hit_d].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(ib[hit_b], id_[hit_d])
    jt, ji, ju, jv = jax.jit(lambda o_, d_: jax_mesh._bvh_model_hit(
        js, 0, o_, d_, jnp.full((256,), jnp.inf)))(jnp.asarray(o).T,
                                                   jnp.asarray(d).T)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)


def test_exact_ties_go_to_the_first_triangle_visited():
    """A cube whose twelve triangles are each listed twice: every hit is
    an exact tie between the two copies.  The port's BVH ids equal JAX's
    (the first triangle visited wins, as JAX's strict ``t <`` keeps it),
    and each BVH winner is the dense sweep's winner (the lowest index) or
    its copy: the same corners and the same t."""
    def doubled(p):
        m = p.cube()
        return dataclasses.replace(
            m, tri_vidx=np.concatenate([m.tri_vidx, m.tri_vidx]),
            tri_mat=np.concatenate([m.tri_mat, m.tri_mat]))

    js, ps = scenes(doubled)
    o, d = random_rays(256, seed=3)
    inf = torch.full((256,), float("inf"))
    td, id_, _, _ = mesh._dense_model_hit(ps, 0, t(o).T, t(d).T, inf)
    tb, ib, _, _ = mesh._bvh_model_hit(ps, 0, t(o).T, t(d).T, inf)
    _, ji, _, _ = jax.jit(lambda o_, d_: jax_mesh._bvh_model_hit(
        js, 0, o_, d_, jnp.full((256,), jnp.inf)))(jnp.asarray(o).T,
                                                   jnp.asarray(d).T)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ji))
    hit = ib != -1
    assert int(hit.sum()) > 0 and torch.equal(hit, torch.isfinite(td))
    assert torch.equal(tb[hit], td[hit])
    for c in (ps.tri_v0, ps.tri_v1, ps.tri_v2):
        assert torch.equal(c[ib[hit].long()], c[id_[hit].long()])


def test_crafted_rays_hit_then_model_moved_misses():
    """The reference integration test (``tests/test_mesh.py``): 64 rays
    from z = 10, odd ones toward the Rubik grid hit, even ones away miss;
    after ``set_frame`` moves the model out of their path, none hits."""
    flat = flatten_models([procgen.rubik_grid()])
    n = 64
    o = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    o[:, 2] = 10.0
    d[1::2] = (0.0, 0.0, -1.0)
    d[0::2] = (0.0, 0.0, 1.0)
    inf = torch.full((n,), float("inf"))
    rec = mesh.mesh_hit_fn(mesh.upload(flat, device="cpu"), method="bvh")(
        t(o).T, t(d).T, 1e-3, inf)
    assert bool(rec.hit[1::2].all()) and not bool(rec.hit[0::2].any())
    moved = np.eye(4, dtype=np.float32)
    moved[0, 3] = 100.0
    rec2 = mesh.mesh_hit_fn(mesh.upload(set_frame(flat, 0, moved),
                                        device="cpu"), method="bvh")(
        t(o).T, t(d).T, 1e-3, inf)
    assert not bool(rec2.hit.any())


def test_hit_ids_bvh_matches_dense_and_jax():
    """``tests/test_features.py``'s wavefront case: ``uv_sphere(10, 14)``,
    ``pad_to=128``, 128 rays (seed 0): BVH ids equal dense ids and JAX's
    BVH ids, also through ``intersect_rays``."""
    js, ps = scenes(lambda p: p.uv_sphere(10, 14), pad_to=128)
    r = np.random.default_rng(0)
    o = r.uniform(-4, 4, (128, 3)).astype(np.float32) + 5
    d = -o
    i_bvh, t_bvh = wavefront.hit_ids(ps, o, d, method="bvh")
    i_dense, _ = wavefront.hit_ids(ps, o, d, method="dense")
    assert torch.equal(i_bvh, i_dense) and int((i_bvh >= 0).sum()) > 0
    j_ids, j_t = jax_wavefront.hit_ids(js, jnp.asarray(o), jnp.asarray(d),
                                       method="bvh")
    np.testing.assert_array_equal(i_bvh.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_bvh.numpy(), np.asarray(j_t), rtol=1e-5,
                               atol=1e-6)
    idx, t_hit = wavefront.intersect_rays(ps, o, d, method="bvh")
    assert torch.equal(idx, i_bvh)
    assert bool(torch.isinf(t_hit[idx < 0]).all())


def test_cube_render_bvh_matches_dense_and_jax():
    """``tests/test_mesh.py``'s render: ``cube(size=2.0)``, 16x12 from (0,
    1, 5), 2 + 1 bounces, key 0: the BVH image against the dense image
    and JAX's BVH image, rtol 1e-4 / atol 1e-5."""
    m = lambda p: p.cube(size=2.0)  # noqa: E731
    js, ps = scenes(m)
    cam = dict(width=16, height=12, origin=(0, 1, 5), look_at=(0, 0, 0))
    cfg = dict(max_depth=2, rr_bounces=1)
    lights = model_scene_lights("cpu")
    images = {method: pathtracer.render(
        mesh.mesh_hit_fn(ps, method=method), lights, CameraConfig(**cam),
        RenderConfig(**cfg), rng.key(0, "cpu")) for method in ("dense",
                                                                "bvh")}
    assert bool(torch.isfinite(images["bvh"]).all())
    assert float(images["bvh"].std()) > 0.01
    np.testing.assert_allclose(images["bvh"].numpy(),
                               images["dense"].numpy(), rtol=1e-4, atol=1e-5)
    want = jax.jit(lambda k: jax_pt.render(
        jax_mesh.mesh_hit_fn(js, method="bvh"), jax_lights(),
        JaxCamera(**cam), JaxRenderConfig(**cfg), k))(jax.random.key(0))
    np.testing.assert_allclose(images["bvh"].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_refit_scene_refuses_bvh():
    """``refit_accel`` leaves the node bounds stale: the BVH route raises
    ``ValueError`` from ``hit_ids``, ``mesh_hit_fn`` and ``_bvh_model_hit``,
    as JAX's does; the dense route still runs."""
    js, ps = scenes(lambda p: p.uv_sphere(10, 14), pad_to=128)
    refit = mesh.refit_accel(ps)
    assert refit.stale_node_bounds
    o, d = random_rays(16, seed=2)
    with pytest.raises(ValueError, match="stale"):
        wavefront.hit_ids(refit, o, d, method="bvh")
    with pytest.raises(ValueError, match="stale"):
        mesh.mesh_hit_fn(refit, method="bvh")(
            t(o).T, t(d).T, 1e-3, torch.full((16,), float("inf")))
    with pytest.raises(ValueError):
        jax_wavefront.hit_ids(jax_mesh.refit_accel(js), jnp.asarray(o),
                              jnp.asarray(d), method="bvh")
    ids, _ = wavefront.hit_ids(refit, o, d, method="dense")
    assert torch.equal(ids, wavefront.hit_ids(ps, o, d, method="dense")[0])


def test_edge_aware_mesh_bvh_matches_jax():
    """``trace_edge_aware_mesh(method="bvh")`` (the primary winner from the
    dense sweep, as JAX's; the bounces through the BVH) against JAX's
    under ``jax.disable_jit()`` and against the port's dense route:
    ``cube(size=2.0)``, 24x20 from (0, 1, 5), 2 bounces, the seed-13
    uniforms (``tests/test_torch_edge_aware_mesh.py``'s setup); rtol 1e-4
    / atol 1e-5 on every pixel."""
    js, ps = scenes(lambda p: p.cube(size=2.0))
    cam = dict(width=24, height=20, origin=(0.0, 1.0, 5.0),
               look_at=(0.0, 0.0, 0.0))
    cfg = dict(max_depth=2, rr_bounces=0, morton_order=False)
    u = host_uniforms(13, 24 * 20, total_slots(6, 2))

    def port(method):
        return edge_aware_mesh.trace_edge_aware_mesh(
            ps, model_scene_lights("cpu"), CameraConfig(**cam),
            RenderConfig(**cfg), ArrayStream(t(u)), method=method)

    got = port("bvh")
    assert torch.equal(got, port("dense"))
    with jax.disable_jit():
        want = jax_eam.trace_edge_aware_mesh(
            js, jax_lights(), JaxCamera(**cam), JaxRenderConfig(**cfg),
            JaxArrayStream(jnp.asarray(u)), method="bvh")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError):
        edge_aware_mesh._primary_winner(ps, t(np.zeros((3, 4), np.float32)),
                                        t(np.ones((3, 4), np.float32)), 1e-3,
                                        "octree")
