"""PyTorch port vs JAX package: the mesh silhouette searches and the box
exit of ``models/edge_aware_mesh.py`` (``_primary_winner``,
``silhouette_sdf`` at 0, 1 and 2 rings, ``silhouette_sdf_global``,
``_model_exit_t``).

Scene: ``procgen.uv_sphere(12, 18)`` (curved, so silhouettes cross
triangles at every angle) flattened with ``pad_to=1``, its primary rays
at 24x20 from (0, 0.5, 3) toward the origin (the seed-3 jitter), its
hit triangles and distances from the dense sweep.  Gradients are those of a
weighted sum of the finite distances (seed-4 weights) with respect to
the shared vertex buffer.  JAX runs under ``jax.disable_jit()``.

Tolerances: distances and box exits rtol 1e-4, atol 1e-5, the BIG
entries (no silhouette edge) equal; gradients rtol 1e-4, atol 1e-4 x
max |JAX|.

The sphere's triangles keep their own corners (``positions`` holds each
welded vertex once per triangle), and the ring search meets a shared
edge once from each side.  The two copies' distances can differ by an
ulp in one package and tie in the other (measured: 2.673593282699585
against 2.673593044281006 in JAX, a tie in the port, ray 455, rings 1),
which moves that ray's gradient between the two copies' corner rows.
The ring gradients are therefore compared per welded vertex (rows at
equal coordinates summed), where both copies land.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.camera import derive_viewport as jax_viewport
from srt_tpu.camera import generate_rays as jax_rays
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.models import edge_aware_mesh as jax_eam
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.models import edge_aware_mesh, mesh
from tests.test_torch_edge_aware import assert_grads, t
from tests.test_torch_traversal import port_scene_of

torch.set_num_threads(2)

CAM = dict(width=24, height=20, origin=(0.0, 0.5, 3.0),
           look_at=(0.0, 0.0, 0.0))
T_MIN = 1e-3
WINDOW = 0.05


@pytest.fixture(scope="module")
def sphere():
    """(JAX scene, port scene, JAX rays, port rays, weights)."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(12, 18)],
                                     pad_to=1))
    n = CAM["width"] * CAM["height"]
    jitter = np.random.default_rng(3).uniform(size=(2, n)).astype(np.float32)
    o, d = jax_rays(jax_viewport(JaxCamera(**CAM)), CAM["width"],
                    CAM["height"], jnp.asarray(jitter))
    w = np.random.default_rng(4).normal(size=n).astype(np.float32)
    return js, port_scene_of(js), (o, d), (t(o), t(d)), w


def jax_value_and_grad(fn, positions):
    """(value [N], d sum(w * finite value) / d positions) under
    ``jax.disable_jit()``; ``fn(positions)`` returns (weighted sum,
    value)."""
    with jax.disable_jit():
        (_, v), g = jax.value_and_grad(fn, has_aux=True)(positions)
    return np.asarray(v), np.asarray(g)


def finite_sum(v, w):
    return (torch.where(v < 1e30, v, torch.zeros_like(v)) * t(w)).sum()


def jax_finite_sum(v, w):
    return jnp.sum(jnp.where(v < 1e30, v, 0.0) * w)


def welded(grad, positions):
    """Gradient rows summed per welded vertex (coordinates equal to 1e-6:
    the sphere's seam repeats its vertices 1e-15 apart)."""
    _, inv = np.unique(np.round(np.asarray(positions), 6), axis=0,
                       return_inverse=True)
    out = np.zeros((inv.max() + 1, 3), np.float64)
    np.add.at(out, inv.ravel(), np.asarray(grad, np.float64))
    return out


def assert_values(got, want, name):
    got = got.detach().numpy()
    big = want > 1e30
    assert big.any() or name.startswith("exit"), name
    np.testing.assert_array_equal(got > 1e30, big, name)
    np.testing.assert_allclose(got[~big], want[~big], rtol=1e-4, atol=1e-5,
                               err_msg=name)


@pytest.fixture(scope="module")
def winners(sphere):
    """JAX's and the port's dense winners: equal hits, triangles and
    models, t within the image tolerance."""
    js, ps, (o, d), (po, pd), _ = sphere
    with jax.disable_jit():
        want = [np.asarray(x) for x in jax_eam._primary_winner(
            js, o, d, T_MIN, "dense")]
    got = edge_aware_mesh._primary_winner(ps, po, pd, T_MIN, "dense")
    return want, got


def test_primary_winner_matches_jax(winners):
    want, got = winners
    for k in (0, 2, 3):
        np.testing.assert_array_equal(got[k].numpy(), want[k], str(k))
    hit = want[0]
    assert 50 < hit.sum() < hit.size
    np.testing.assert_allclose(got[1].detach().numpy()[hit], want[1][hit],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rings", [0, 1, 2])
def test_silhouette_sdf_matches_jax(sphere, winners, rings):
    """Ray-to-silhouette-edge distances over the hit triangle and
    ``rings`` adjacency rings, and their vertex gradients."""
    js, ps, (o, d), (po, pd), w = sphere
    (_, _, jtri, _), (_, _, ptri, _) = winners

    def fn(pos):
        v = jax_eam.silhouette_sdf(js.replace(positions=pos), jtri, o, d,
                                   rings=rings)
        return jax_finite_sum(v, w), v

    want_v, want_g = jax_value_and_grad(fn, js.positions)
    pos = ps.positions.clone().requires_grad_(True)
    got = edge_aware_mesh.silhouette_sdf(
        dataclasses.replace(ps, positions=pos), ptri, po, pd, rings=rings)
    assert_values(got, want_v, f"rings {rings}")
    finite_sum(got, w).backward()
    assert_grads(torch.tensor(welded(pos.grad, js.positions)),
                 welded(want_g, js.positions), f"rings {rings}")


def test_silhouette_sdf_global_matches_jax(sphere, winners):
    """The global search over every deduplicated edge segment within a
    window of the hit distance, on unit directions."""
    js, ps, (o, d), (po, pd), w = sphere
    (_, jt, _, _), (_, pt, _, _) = winners
    dn = np.asarray(d) / np.linalg.norm(np.asarray(d), axis=0)
    t_hit = np.where(np.isfinite(np.asarray(jt)), np.asarray(jt) * np.linalg
                     .norm(np.asarray(d), axis=0), 0.0).astype(np.float32)
    window = np.full(t_hit.shape, WINDOW, np.float32)

    def fn(pos):
        v = jax_eam.silhouette_sdf_global(
            js.replace(positions=pos), 0, o, jnp.asarray(dn),
            jnp.asarray(t_hit), jnp.asarray(window))
        return jax_finite_sum(v, w), v

    want_v, want_g = jax_value_and_grad(fn, js.positions)
    pos = ps.positions.clone().requires_grad_(True)
    got = edge_aware_mesh.silhouette_sdf_global(
        dataclasses.replace(ps, positions=pos), 0, po, t(dn), t(t_hit),
        t(window))
    assert_values(got, want_v, "global")
    assert (want_v < 1e30).sum() > 20
    finite_sum(got, w).backward()
    assert_grads(pos.grad, want_g, "global")


def test_model_exit_t_matches_jax(sphere):
    """The far box parameter from the live per-corner arrays, and its
    gradient through ``with_positions`` (ties among the box's extreme
    vertices share it, as ``jnp.min``/``jnp.max`` do)."""
    js, ps, (o, d), (po, pd), w = sphere

    def fn(pos):
        s = jax_mesh.with_positions(js, pos)
        o_m, d_m = jax_mesh.transform_rays(s.frames[0], o, d)
        v = jax_eam._model_exit_t(s, 0, o_m, d_m)
        return jnp.sum(v * w), v

    want_v, want_g = jax_value_and_grad(fn, js.positions)
    pos = ps.positions.clone().requires_grad_(True)
    s = mesh.with_positions(ps, pos)
    o_m, d_m = mesh.transform_rays(s.frames[0], po, pd)
    got = edge_aware_mesh._model_exit_t(s, 0, o_m, d_m)
    assert_values(got, want_v, "exit")
    assert (want_v > 0).sum() > 50
    (got * t(w)).sum().backward()
    assert_grads(pos.grad, want_g, "exit")
