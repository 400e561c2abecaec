"""PyTorch port vs JAX package: mesh gradients, ``with_positions``,
``refit_accel`` and the stop-gradient contract of the walk.

The setup of ``tests/test_mesh_gradients.py``: ``uv_sphere(6, 8)``
flattened with ``pad_to=128`` (one cluster), the model scene's lights,
12x10 from (0, 0.5, 4), ``max_depth=2``, the seed-7 uniforms through one
injected array.  The loss is the image mean; gradients are taken with
respect to ``mat_diffuse``, the shared vertex buffer (through
``with_positions``) and ``frames``, through the port's walk (the kernels'
plain versions on the CPU) and its dense sweep, and through JAX's
``method="pallas"`` (interpret mode, with the exact reciprocal of
``tests/test_torch_traversal.py``, under ``jax.disable_jit()``).  The
JAX scene's leaves reach the port through ``scene_from_arrays``.

Tolerances: walk against dense (the port), rtol 1e-6 and atol 1e-6 x max
|dense| (the walk's winners equal the dense sweep's and the refine is
the dense arithmetic, so only reduction order differs); port against JAX,
rtol 1e-4 and atol 1e-4 x max |JAX| (measured: at most 6e-6 relative);
``refit_accel`` against JAX's and the host build, rtol 2e-4 and atol 2e-5
(JAX's own test tolerance) and the cluster boxes exactly;
``with_positions``' scatter-add against JAX's, rtol = atol = 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.ops import traversal
from srt_tpu_torch.ops.rng import host_uniforms, total_slots
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.utils import procgen
from srt_tpu_torch.utils.flatten import flatten_models
from tests.test_torch_traversal import _ExactReciprocalPallas, port_scene_of

torch.set_num_threads(2)

CAM = dict(width=12, height=10, origin=(0.0, 0.5, 4.0),
           look_at=(0.0, 0.0, 0.0))
CFG = dict(max_depth=2, rr_bounces=0)
LEAVES = ("mat_diffuse", "positions", "frames")
# Every walk the port's ``model_hit`` can take, on a three-super model.
WALKS = {"tiled": False, "binned": True, "pg": "pg", "pg2": "pg2:32"}
# The cull each walk launches.
WALK_CULL = {"tiled": "cull", "binned": "cull_perray", "pg": "cull_gmask",
             "pg2": "cull_pg2"}
# The wrappers whose arguments are kernel operands.
WRAPPERS = ("cull", "intersect", "intersect_stream", "cull_pg2", "pgwalk2",
            "pgwalk2_stream", "cull_perray", "cull_gmask", "pgwalk")


def uniforms():
    return host_uniforms(7, CAM["width"] * CAM["height"], total_slots(6, 2))


def port_loss(scene, leaves, method, binned=False):
    """Image mean with ``leaves`` (mat_diffuse, positions, frames) in
    ``scene``."""
    s = mesh.with_positions(dataclasses.replace(
        scene, mat_diffuse=leaves["mat_diffuse"], frames=leaves["frames"]),
        leaves["positions"])
    img = pathtracer.trace_with_uniforms(
        mesh.mesh_hit_fn(s, method=method, binned=binned),
        model_scene_lights("cpu"), CameraConfig(**CAM), RenderConfig(**CFG),
        torch.tensor(uniforms()))
    return img.mean()


def port_grads(scene, method, binned=False):
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in LEAVES}
    port_loss(scene, leaves, method, binned).backward()
    return {k: v.grad for k, v in leaves.items()}


def assert_close(got, want, rtol, name):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=name)


@pytest.fixture(scope="module")
def small():
    """(JAX scene, port scene) of uv_sphere(6, 8)."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(6, 8, radius=1.0)],
                                     pad_to=128))
    return js, port_scene_of(js)


@pytest.fixture(scope="module")
def grads(small):
    """JAX's pallas gradients and the port's walk and dense gradients."""
    js, ps = small
    saved = jax_tp.pl
    jax.clear_caches()
    jax_tp.pl = _ExactReciprocalPallas("pallas_exact_reciprocal")
    try:
        def loss(diffuse, positions, frames):
            s = jax_mesh.with_positions(
                js.replace(mat_diffuse=diffuse, frames=frames), positions)
            return jnp.mean(jax_pt.trace_with_uniforms(
                jax_mesh.mesh_hit_fn(s, method="pallas"), jax_lights(),
                JaxCamera(**CAM), JaxRenderConfig(**CFG),
                jnp.asarray(uniforms())))

        with jax.disable_jit():
            g = jax.grad(loss, argnums=(0, 1, 2))(
                js.mat_diffuse, js.positions, js.frames)
    finally:
        jax_tp.pl = saved
        jax.clear_caches()
    return {"jax": dict(zip(LEAVES, g)), "walk": port_grads(ps, "walk"),
            "dense": port_grads(ps, "dense")}


@pytest.mark.parametrize("leaf", LEAVES)
def test_walk_gradients_match_dense_and_jax(grads, leaf):
    """Material, shared-vertex and frame gradients: the walk against the
    dense sweep and against JAX's pallas path; finite and nonzero."""
    want = grads["jax"][leaf]
    assert np.abs(np.asarray(want)).max() > 1e-6
    assert_close(grads["walk"][leaf], grads["dense"][leaf].numpy(), 1e-6,
                 f"{leaf}: walk vs dense")
    assert_close(grads["walk"][leaf], want, 1e-4, f"{leaf}: walk vs JAX")
    assert_close(grads["dense"][leaf], want, 1e-4, f"{leaf}: dense vs JAX")


def test_with_positions_matches_jax(small):
    """The re-gathered corners equal JAX's for moved vertices, and the
    gather's backward adds each corner's gradient into its shared
    vertex."""
    js, ps = small
    rs = np.random.default_rng(0)
    p = np.asarray(js.positions) + rs.normal(
        0.0, 0.05, js.positions.shape).astype(np.float32)
    want = jax_mesh.with_positions(js, jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    got = mesh.with_positions(ps, pt)
    for f in ("tri_v0", "tri_v1", "tri_v2", "positions"):
        np.testing.assert_array_equal(getattr(got, f).detach().numpy(),
                                      np.asarray(getattr(want, f)), f)
    w = [rs.normal(size=got.tri_v0.shape).astype(np.float32)
         for _ in range(3)]

    def jax_dot(q):
        s = jax_mesh.with_positions(js, q)
        return sum(jnp.sum(getattr(s, f) * x)
                   for f, x in zip(("tri_v0", "tri_v1", "tri_v2"), w))

    sum((getattr(got, f) * torch.tensor(x)).sum()
        for f, x in zip(("tri_v0", "tri_v1", "tri_v2"), w)).backward()
    np.testing.assert_allclose(pt.grad.numpy(),
                               np.asarray(jax.grad(jax_dot)(jnp.asarray(p))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["cube", "uv_sphere-6-8", "uv_sphere-40-60"])
def test_refit_accel_matches_jax_and_host(name):
    """``refit_accel`` on the uploaded geometry against JAX's
    ``refit_accel`` and the host build of ``upload``; after a vertex move,
    against JAX's refit of the same move."""
    meshes = {"cube": (jax_procgen.cube, procgen.cube),
              "uv_sphere-6-8": (lambda: jax_procgen.uv_sphere(6, 8),
                                lambda: procgen.uv_sphere(6, 8)),
              "uv_sphere-40-60": (lambda: jax_procgen.uv_sphere(40, 60),
                                  lambda: procgen.uv_sphere(40, 60))}[name]
    js = jax_mesh.upload(jax_flatten([meshes[0]()], pad_to=128))
    ps = mesh.upload(flatten_models([meshes[1]()], pad_to=128), device="cpu")
    p = np.asarray(js.positions) * np.float32(1.01)
    for jsc, psc, host in ((js, ps, ps), (
            jax_mesh.with_positions(js, jnp.asarray(p)),
            mesh.with_positions(ps, torch.tensor(p)), None)):
        want = jax_mesh.refit_accel(jsc)
        got = mesh.refit_accel(psc)
        assert got.stale_node_bounds and got.woop.shape == psc.woop.shape
        refs = [("JAX", {f: np.asarray(getattr(want, f)) for f in
                         ("woop", "cluster_min", "cluster_max")})]
        if host is not None:
            refs.append(("host", {f: getattr(host, f).numpy() for f in
                                  ("woop", "cluster_min", "cluster_max")}))
        for label, ref in refs:
            np.testing.assert_allclose(got.woop.numpy(), ref["woop"],
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"woop vs {label}")
            for f in ("cluster_min", "cluster_max"):
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              ref[f], f"{f} vs {label}")


def test_refit_accel_tracks_moved_vertices():
    """After a vertex move the walk needs refit tables: on them it finds
    the dense sweep's hits; on the stale tables (the uploaded boxes) it
    misses hits outside them.  On unmoved vertices the refit tables give
    the same frame as the uploaded ones, bit for bit."""
    ps = mesh.upload(flatten_models([procgen.uv_sphere(40, 60)], pad_to=128),
                     device="cpu")
    lights = model_scene_lights("cpu")
    u = torch.tensor(uniforms())

    def frame(scene, method="walk"):
        return pathtracer.trace_with_uniforms(
            mesh.mesh_hit_fn(scene, method=method), lights,
            CameraConfig(**CAM), RenderConfig(**CFG), u)

    assert torch.equal(frame(mesh.refit_accel(ps)), frame(ps))
    moved = mesh.with_positions(ps, ps.positions * 1.25)
    dense = frame(moved, "dense")
    assert torch.equal(frame(mesh.refit_accel(moved)), dense)
    assert not torch.equal(frame(moved), dense)


@pytest.fixture
def recorded(monkeypatch):
    """Every kernel wrapper's tensor arguments and outputs, by name."""
    calls = []
    for name in WRAPPERS:
        fn = getattr(traversal, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            out = _fn(*args, **kw)
            tensors = [x for x in list(args) + list(kw.values())
                       + list(out if isinstance(out, tuple) else (out,))
                       if isinstance(x, torch.Tensor)]
            calls.append((_name, tensors))
            return out

        monkeypatch.setattr(traversal, name, rec)
    return calls


@pytest.mark.parametrize("walk", list(WALKS))
def test_kernel_operands_carry_no_history(walk, recorded):
    """The stop-gradient contract of the walk: with origins, directions,
    vertices, frames and the ray bound requiring grad, no kernel operand
    or output and no candidate output of ``model_hit`` carries autograd
    history (on the CPU the plain versions would otherwise join the
    graph), the refine carries it, and the walk's gradients on a
    three-super model equal the dense sweep's."""
    ps = mesh.upload(flatten_models([procgen.uv_sphere(40, 60)], pad_to=128),
                     device="cpu")
    assert mesh.n_superclusters(ps) == 3
    rs = np.random.default_rng(3)
    o = torch.tensor(rs.normal(0.0, 0.3, (3, 700)).astype(np.float32))
    o[2] += 4.0
    d = torch.tensor(rs.normal(0.0, 0.2, (3, 700)).astype(np.float32))
    d[2] -= 1.0
    o.requires_grad_(True)
    d.requires_grad_(True)
    t_best = torch.full((700,), 10.0, requires_grad=True)
    s = mesh.with_positions(dataclasses.replace(
        ps, frames=ps.frames.clone().requires_grad_(True)),
        ps.positions.clone().requires_grad_(True))
    binned = WALKS[walk]
    for any_hit, refine in ((False, False), (True, False), (False, True)):
        t, i, u, v = traversal.model_hit(s, 0, o, d, t_best, tile=128,
                                         binned=binned, any_hit=any_hit,
                                         refine=refine)
        assert int((i >= 0).sum()) > 100
        assert not i.requires_grad
        assert all(x.requires_grad == refine for x in (t, u, v)), \
            (any_hit, refine)
    assert WALK_CULL[walk] in {name for name, _ in recorded}
    for name, tensors in recorded:
        assert not any(x.requires_grad or x.grad_fn is not None
                       for x in tensors), name
    assert_close(port_grads(ps, "walk", binned)["positions"],
                 port_grads(ps, "dense")["positions"].numpy(), 1e-6,
                 f"positions: {walk} walk vs dense")
