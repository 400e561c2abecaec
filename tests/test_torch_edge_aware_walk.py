"""PyTorch port vs JAX package: the edge-aware mesh render through the
walk (``trace_edge_aware_mesh(method="walk")``: the kernels' plain
versions on CPU tensors) against JAX's ``method="pallas"``.

Scene: ``procgen.uv_sphere(6, 8)`` flattened with ``pad_to=128`` (one
cluster), the model scene's first light, 12x10 from (0, 0.5, 2.5) toward
the origin, ``max_depth=1``, ``morton_order=False``, the seed-7 uniforms
through ``ArrayStream``, ring search (1 ring).  JAX's Pallas kernels run
in interpret mode with the exact reciprocal of
``tests/test_torch_traversal.py``, under ``jax.disable_jit()`` as in
``tests/test_torch_mesh_gradients.py``; every Pallas call compiles its
kernel again, so one bounce keeps the reference short.  Gradients are
taken with respect to the shared vertex buffer through
``with_positions``.  The walk's winner distance is the kernels'
candidate t with no gradient, as JAX's ``pallas_model_hit(refine=
False)``; the dense sweep's carries one into the footprint, so walk and
dense gradients differ by design.  ``rubik_grid()`` (one super, three
clusters) checks the walk against the port's dense sweep.

Tolerances: images rtol 1e-4, atol 1e-5 on every pixel; gradients rtol
1e-4, atol 1e-4 x max |JAX|; walk against dense images on the Rubik grid
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import edge_aware_mesh as jax_eam
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import edge_aware_mesh, mesh
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.utils import procgen
from srt_tpu_torch.utils.flatten import flatten_models
from tests.test_torch_edge_aware import (assert_grads, assert_images,
                                         jax_image_and_grads, port_lights, t)
from tests.test_torch_traversal import _ExactReciprocalPallas, port_scene_of

torch.set_num_threads(2)

CAM = dict(width=12, height=10, origin=(0.0, 0.5, 2.5),
           look_at=(0.0, 0.0, 0.0))
CFG = dict(max_depth=1, rr_bounces=0, morton_order=False)


@pytest.fixture(scope="module")
def sphere():
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(6, 8)],
                                     pad_to=128))
    u = host_uniforms(7, CAM["width"] * CAM["height"], total_slots(1, 1))
    return js, port_scene_of(js), u


def one_light():
    """The model scene's first light alone (JAX's ``Lights``)."""
    lights = jax_lights()
    return lights.replace(position=lights.position[:1],
                          color=lights.color[:1],
                          intensity=lights.intensity[:1])


def compiled_launch(*args, **kw):
    """JAX's tiled-walk launcher, compiled even under
    ``jax.disable_jit()``: its jit then reuses one compiled kernel for
    every launch of a shape (kernel operands carry no gradient)."""
    with jax.disable_jit(False):
        return _LAUNCH(*args, **kw)


_LAUNCH = jax_tp._launch


@pytest.fixture(scope="module")
def jax_refs(sphere):
    """JAX's ``"pallas"`` image and gradient (interpret mode, exact
    reciprocal)."""
    js, _, u = sphere

    def ea(positions):
        return jax_eam.trace_edge_aware_mesh(
            jax_mesh.with_positions(js, positions), one_light(),
            JaxCamera(**CAM), JaxRenderConfig(**CFG),
            JaxArrayStream(jnp.asarray(u)), method="pallas")

    saved = jax_tp.pl, jax_tp._launch
    jax.clear_caches()
    jax_tp.pl = _ExactReciprocalPallas("pallas_exact_reciprocal")
    jax_tp._launch = compiled_launch
    try:
        return jax_image_and_grads(ea, (js.positions,))
    finally:
        jax_tp.pl, jax_tp._launch = saved
        jax.clear_caches()


def port_image(scene, u, method):
    return edge_aware_mesh.trace_edge_aware_mesh(
        scene, port_lights(one_light()), CameraConfig(**CAM),
        RenderConfig(**CFG), ArrayStream(t(u)), method=method)


def test_walk_matches_jax_pallas(sphere, jax_refs):
    """The walk's image and d mean(image) / d positions against JAX's
    Pallas route."""
    _, ps, u = sphere
    pos = ps.positions.clone().requires_grad_(True)
    img = port_image(mesh.with_positions(ps, pos), u, "walk")
    want_img, (want_g,) = jax_refs
    assert_images(img, want_img, "image")
    assert float(img.detach().std()) > 1e-3
    img.mean().backward()
    assert_grads(pos.grad, want_g, "d / d positions")


def test_walk_is_the_default_and_equals_dense_images():
    """The default method is the walk; on the Rubik grid (one super, three
    clusters) its edge-aware image equals the dense sweep's bit for bit,
    and its vertex gradient is finite and nonzero."""
    ps = mesh.upload(flatten_models([procgen.rubik_grid()], pad_to=128),
                     device="cpu")
    cam = CameraConfig(width=16, height=12, origin=(0.0, 5.0, 6.0),
                       look_at=(0.0, 0.0, 0.0))
    cfg = RenderConfig(max_depth=2, rr_bounces=0, morton_order=False)
    u = t(host_uniforms(8, 16 * 12, total_slots(6, 2)))
    lights = model_scene_lights("cpu")
    pos = ps.positions.clone().requires_grad_(True)
    walk = edge_aware_mesh.trace_edge_aware_mesh(
        mesh.with_positions(ps, pos), lights, cam, cfg, ArrayStream(u))
    dense = edge_aware_mesh.trace_edge_aware_mesh(
        ps, lights, cam, cfg, ArrayStream(u), method="dense")
    assert torch.equal(walk.detach(), dense)
    walk.mean().backward()
    assert bool(torch.isfinite(pos.grad).all())
    assert float(pos.grad.abs().max()) > 0.0
    with pytest.raises(ValueError):
        edge_aware_mesh._primary_winner(ps, t(np.zeros((3, 4), np.float32)),
                                        t(np.ones((3, 4), np.float32)), 1e-3,
                                        "octree")
