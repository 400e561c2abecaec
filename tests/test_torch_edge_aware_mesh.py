"""PyTorch port vs JAX package: primary-visibility silhouettes of meshes
through the dense sweep (``models/edge_aware_mesh.trace_edge_aware_mesh``
and ``render_edge_aware_mesh``, ``method="dense"``).

Scene: ``tests/test_mesh_silhouette.py``'s, ``procgen.cube(size=2.0)``
flattened with ``pad_to=1``, the model scene's six lights, 24x20 from
(0, 1, 5) toward the origin, ``max_depth=2``, ``morton_order=False``,
the seed-13 uniforms through ``ArrayStream`` (``render_edge_aware_mesh``:
both draw from key 5).  JAX runs under ``jax.disable_jit()``, each
reference once per module.  The JAX scene's leaves reach the
port through ``scene_from_arrays``; gradients are taken with respect to
the shared vertex buffer through ``with_positions``.

Vertex gradients are compared as directional derivatives, JAX's by
forward mode (``jax.jvp``, about half the cost of a linearization):
along the cube's x-translation and its scaling about the origin (JAX's
own tests) and along a seed-9 random direction over every vertex.

Tolerances: images rtol 1e-4, atol 1e-5 on every pixel; directional
derivatives of the image mean rtol 1e-4, atol 1e-4 x the largest of
them.  The walk against JAX's Pallas route is in
``tests/test_torch_edge_aware_walk.py``, the silhouette searches in
``tests/test_torch_edge_aware_search.py``.
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
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import edge_aware_mesh, mesh, pathtracer
from srt_tpu_torch.ops import rng
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from srt_tpu_torch.scene import model_scene_lights
from tests.test_torch_edge_aware import assert_grads, assert_images, t
from tests.test_torch_traversal import port_scene_of

torch.set_num_threads(2)

CAM = dict(width=24, height=20, origin=(0.0, 1.0, 5.0),
           look_at=(0.0, 0.0, 0.0))
CFG = dict(max_depth=2, rr_bounces=0, morton_order=False)


@pytest.fixture(scope="module")
def cube():
    """(JAX scene, port scene, uniforms) of the unit-2 cube."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.cube(size=2.0)], pad_to=1))
    u = host_uniforms(13, CAM["width"] * CAM["height"], total_slots(6, 2))
    return js, port_scene_of(js), u


def directions(positions):
    """[3, V, 3] tangents: x-translation, scaling, a random one."""
    pos = np.asarray(positions)
    shift = np.broadcast_to(np.asarray([1.0, 0.0, 0.0], np.float32),
                            pos.shape)
    rand = np.random.default_rng(9).normal(size=pos.shape)
    return np.stack([shift, pos, rand]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs(cube):
    """JAX's image and its mean's derivatives along ``directions``."""
    js, _, u = cube

    def ea(positions):
        img = jax_eam.trace_edge_aware_mesh(
            jax_mesh.with_positions(js, positions), jax_lights(),
            JaxCamera(**CAM), JaxRenderConfig(**CFG),
            JaxArrayStream(jnp.asarray(u)), method="dense")
        return img, jnp.mean(img)

    derivs = []
    with jax.disable_jit():
        for tan in directions(js.positions):
            (img, _), (_, dm) = jax.jvp(ea, (js.positions,),
                                        (jnp.asarray(tan),))
            derivs.append(float(dm))
        render = jax_eam.render_edge_aware_mesh(
            js, jax_lights(), JaxCamera(**CAM), JaxRenderConfig(spp=2, **CFG),
            jax.random.key(5), method="dense")
    return {"trace": (np.asarray(img), np.asarray(derivs)),
            "render": np.asarray(render)}


def port_image(scene, u, **kw):
    return edge_aware_mesh.trace_edge_aware_mesh(
        scene, model_scene_lights("cpu"), CameraConfig(**CAM),
        RenderConfig(**CFG), ArrayStream(t(u)), **kw)


def test_trace_edge_aware_mesh_matches_jax(cube, jax_refs):
    """The dense sweep's image and d mean(image) / d positions (the
    silhouette term, the background continuation and the footprint's
    hit distance, which carries a gradient on this route)."""
    _, ps, u = cube
    pos = ps.positions.clone().requires_grad_(True)
    img = port_image(mesh.with_positions(ps, pos), u, method="dense")
    want_img, want_d = jax_refs["trace"]
    assert_images(img, want_img, "image")
    img.mean().backward()
    got_d = (pos.grad[None] * torch.tensor(directions(ps.positions))).sum(
        (1, 2))
    assert_grads(got_d, want_d, "directional derivatives")


def test_edge_aware_mesh_equals_plain_away_from_silhouettes(cube):
    """Only the silhouette band blends: the other pixels equal the plain
    renderer's bit for bit."""
    _, ps, u = cube
    plain = pathtracer.trace_with_uniforms(
        mesh.mesh_hit_fn(ps, method="dense"), model_scene_lights("cpu"),
        CameraConfig(**CAM), RenderConfig(**CFG), t(u))
    diff = (plain - port_image(ps, u, method="dense")).abs().amax(2)
    assert float((diff == 0).float().mean()) > 0.7
    assert int((diff > 0).sum()) > 5


def test_render_edge_aware_mesh_two_samples_matches_jax(cube, jax_refs):
    """``render_edge_aware_mesh`` with spp 2 from key 5 on the cube:
    JAX's image, the mean of the samples drawn from ``fold_in(key, s)``;
    spp 1 is sample 0 itself."""
    _, ps, _ = cube
    want = jax_refs["render"]
    lights = model_scene_lights("cpu")
    cam = CameraConfig(**CAM)
    key = rng.key(5, "cpu")
    cfg2 = RenderConfig(spp=2, **CFG)
    got = edge_aware_mesh.render_edge_aware_mesh(ps, lights, cam, cfg2, key,
                                                 method="dense")
    assert_images(got, want, "spp 2")
    n = cam.width * cam.height
    samples = [edge_aware_mesh.trace_edge_aware_mesh(
        ps, lights, cam, cfg2, rng.KeyStream(rng.fold_in(key, s), n),
        method="dense") for s in range(2)]
    assert torch.equal(got, torch.stack(samples).mean(0))
    one = edge_aware_mesh.render_edge_aware_mesh(
        ps, lights, cam, RenderConfig(**CFG), key, method="dense")
    assert torch.equal(one, samples[0])


def test_scene_without_adjacency_is_refused(cube):
    _, ps, u = cube
    with pytest.raises(ValueError):
        port_image(dataclasses.replace(ps, tri_adj=None), u, method="dense")
