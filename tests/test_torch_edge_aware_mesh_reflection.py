"""PyTorch port vs JAX package: mesh silhouettes seen in a mesh mirror
(``models/edge_aware_mesh.trace_edge_aware_mesh_reflection``: bounce 1
through ``bounce_step(return_aux=True)``, the global silhouette search
on the reflected rays).

Scene: ``tests/test_mesh_reflection.py``'s (a near-mirror quad filling
the view, an emissive cube beside the camera seen only in it, one light;
28x24, vfov 28, ``max_depth=2``, ``morton_order=False``, the seed-29
uniforms), the dense sweep (the scene is flattened with ``pad_to=1``:
no walk tables).  The JAX scene's leaves reach the port through
``scene_from_arrays``; gradients are taken with respect to the shared
vertex buffer through ``with_positions``.  JAX runs under
``jax.disable_jit()``.

Gradients are compared as directional derivatives, JAX's by forward
mode (``jax.jvp``, about half the cost of a linearization here): along
the occluder's x-translation (JAX's own test) and along a seed-9 random
direction over every vertex, mirror and occluder.

Tolerances: images rtol 1e-4, atol 1e-5 on every pixel; directional
derivatives of the image mean rtol 1e-4, atol 1e-4 x the largest of
them; the pixels outside the reflected band equal the plain renderer's
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.models import edge_aware_mesh as jax_eam
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu_torch.models import edge_aware_mesh, mesh, pathtracer
from srt_tpu_torch.ops.rng import ArrayStream
from tests import test_mesh_reflection as jax_mr
from tests.test_torch_edge_aware import (assert_grads, assert_images,
                                         port_lights, port_of, t)
from tests.test_torch_traversal import port_scene_of

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    js, jl, u = jax_mr.setup()
    return js, jl, np.asarray(u), port_scene_of(js), port_lights(jl)


def directions(js):
    """[2, V, 3] tangents: the occluder's x-translation, a random one."""
    occ = np.asarray(jax_mr.occluder_vertex_mask(js), np.float32)[:, None]
    shift = occ * np.asarray([1.0, 0.0, 0.0], np.float32)
    rand = np.random.default_rng(9).normal(
        size=js.positions.shape).astype(np.float32)
    return np.stack([shift, rand])


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX's image and the derivatives of its mean along
    ``directions``."""
    js, jl, u, _, _ = setup

    def mean_img(positions):
        img = jax_eam.trace_edge_aware_mesh_reflection(
            jax_mesh.with_positions(js, positions), jl, jax_mr.CAM,
            jax_mr.CFG, JaxArrayStream(jnp.asarray(u)))
        return img, jnp.mean(img)

    derivs = []
    with jax.disable_jit():
        for tan in directions(js):
            (img, _), (_, dm) = jax.jvp(mean_img, (js.positions,),
                                        (jnp.asarray(tan),))
            derivs.append(float(dm))
    return np.asarray(img), np.asarray(derivs)


def port_image(scene, pl, u):
    return edge_aware_mesh.trace_edge_aware_mesh_reflection(
        scene, pl, port_of(jax_mr.CAM), port_of(jax_mr.CFG),
        ArrayStream(t(u)), method="dense")


def test_mesh_reflection_matches_jax(setup, jax_refs):
    """The image and d mean / d positions: the mirror's through the
    bounce geometry, the occluder's through its reflected silhouette and
    its radiance."""
    js, _, u, ps, pl = setup
    pos = ps.positions.clone().requires_grad_(True)
    img = port_image(mesh.with_positions(ps, pos), pl, u)
    want_img, want_d = jax_refs
    assert_images(img, want_img, "image")
    img.mean().backward()
    got_d = (pos.grad[None] * torch.tensor(directions(js))).sum((1, 2))
    assert_grads(got_d, want_d, "directional derivatives")
    assert abs(want_d[0]) > 1e-5


def test_mesh_reflection_equals_plain_away_from_the_band(setup):
    """Only the reflected silhouette band blends: every other pixel
    equals the plain renderer's bit for bit; depth 1 is refused."""
    _, _, u, ps, pl = setup
    plain = pathtracer.trace_with_uniforms(
        mesh.mesh_hit_fn(ps, method="dense"), pl, port_of(jax_mr.CAM),
        port_of(jax_mr.CFG), t(u))
    diff = (plain - port_image(ps, pl, u)).abs().amax(2)
    assert float((diff == 0).float().mean()) > 0.7
    assert int((diff > 0).sum()) > 5
    with pytest.raises(ValueError):
        edge_aware_mesh.trace_edge_aware_mesh_reflection(
            ps, pl, port_of(jax_mr.CAM),
            dataclasses.replace(port_of(jax_mr.CFG), max_depth=1),
            ArrayStream(t(u)), method="dense")
