"""PyTorch port vs JAX package: silhouettes of spheres seen in a mirror
(``models/edge_aware.trace_edge_aware_reflection``).

Scene: the mirror scene of ``tests/test_visibility_gradients.py`` (a
mirror sphere in view, a matte sphere behind the camera seen only in it,
one light; ``max_depth=2``, the seed-41 uniforms) at 24x20 rather than
its 28x24.  Inputs, conversions and JAX's ``jax.disable_jit()`` as in
``tests/test_torch_edge_aware.py``.

Tolerances: images rtol 1e-4, atol 1e-5 on every pixel; gradients rtol
1e-4, atol 1e-4 x max |JAX|; without mirrors (the port alone, the shadow
scene at depth 2) the reflection trace equals the plain renderer within
JAX's own rtol 2e-5, atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.models import edge_aware as jax_ea
from srt_tpu.ops import rng as jax_rng
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu_torch.models import edge_aware, pathtracer
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from tests import test_visibility_gradients as jax_vis
from tests.test_torch_edge_aware import (assert_grads, assert_images,
                                         jax_image_and_grads, port_lights,
                                         port_of, port_spheres, t)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mirror():
    """The mirror scene at 24x20: JAX's, the port's, camera, config and
    the seed-41 uniforms."""
    js, jl, cam, cfg, _ = jax_vis._mirror_scene()
    cam = dataclasses.replace(cam, width=24, height=20)
    u = jax_rng.host_uniforms(41, 24 * 20, jax_rng.total_slots(jl.count, 2))
    return js, jl, cam, cfg, u, port_spheres(js), port_lights(jl)


@pytest.fixture(scope="module")
def jax_refs(mirror):
    js, jl, cam, cfg, u, _, _ = mirror

    def refl(center):
        return jax_ea.trace_edge_aware_reflection(
            js.replace(center=center), jl, cam, cfg,
            JaxArrayStream(jnp.asarray(u)))

    return jax_image_and_grads(refl, (js.center,))


def test_reflection_matches_jax(mirror, jax_refs):
    """``trace_edge_aware_reflection`` on the mirror scene: the image, and
    d mean / d centres (the matte sphere's comes from its reflected
    silhouette and shading alone)."""
    _, _, cam, cfg, u, ps, pl = mirror
    c = ps.center.clone().requires_grad_(True)
    img = edge_aware.trace_edge_aware_reflection(
        dataclasses.replace(ps, center=c), pl, port_of(cam), port_of(cfg),
        ArrayStream(t(u)))
    want_img, (want_g,) = jax_refs
    assert_images(img, want_img, "image")
    img.mean().backward()
    assert_grads(c.grad, want_g, "d / d center")
    assert float(c.grad[1].abs().max()) > 1e-5


def test_reflection_without_mirrors_equals_plain():
    """With no mirror material the reflection trace is the scan
    integrator: the shadow scene at depth 2 (JAX's own check)."""
    js, jl, cam, cfg, _ = jax_vis._shadow_scene()
    ps, pl = port_spheres(js), port_lights(jl)
    cfg2 = dataclasses.replace(port_of(cfg), max_depth=2)
    u = t(host_uniforms(31, cam.width * cam.height, total_slots(1, 2)))
    plain = pathtracer.trace_with_uniforms(pathtracer.spheres_hit_fn(ps), pl,
                                           port_of(cam), cfg2, u)
    got = edge_aware.trace_edge_aware_reflection(ps, pl, port_of(cam), cfg2,
                                                 ArrayStream(u))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        edge_aware.trace_edge_aware_reflection(ps, pl, port_of(cam),
                                               port_of(cfg), ArrayStream(u))
