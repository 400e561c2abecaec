"""PyTorch port vs JAX package: gradients through the sphere route.

The setup of ``tests/test_gradients.py``: the default sphere scene at
12x10, ``max_depth=2``, ``rr_bounces=0``, the seed-5 uniforms through one
injected array, so the image is a deterministic function of the
parameters.  The loss is the image mean; ``torch.autograd`` through the
port and ``jax.grad`` through the JAX package (under
``jax.disable_jit()``, every operation rounded as written, as
``tests/test_torch_spheres.py`` explains) must give the same gradient for
the albedo, roughness, light intensity, sphere centre and radius and the
camera origin and look-at point.  A second case turns Russian roulette
on (one bounce past ``max_depth``), which runs the survival clip.

Tolerance: rtol 1e-4 and atol 1e-4 x the largest |entry| of the JAX
gradient (both packages round each float32 operation, but reductions sum
in different orders; measured: at most 2.5e-5 relative on the centre).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu import scene as jax_scene
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu_torch import scene
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import pathtracer
from srt_tpu_torch.ops import safemath
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from tests.test_torch_spheres import sphere_arrays

torch.set_num_threads(2)

CAM = dict(width=12, height=10, origin=(0.0, 0.0, 0.0),
           look_at=(0.0, 0.0, -1.0))
LEAVES = ("albedo", "roughness", "intensity", "center", "radius", "origin",
          "look_at")
CONFIGS = {"no-rr": dict(max_depth=2, rr_bounces=0),
           "rr": dict(max_depth=1, rr_bounces=1)}


def assert_grads_match(port, want, name):
    """The stated tolerance: rtol 1e-4, atol 1e-4 x max |want|."""
    want = np.asarray(want)
    got = port.detach().numpy()
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=name)


def jax_grads(cfg_kw, uniforms):
    spheres, lights = jax_scene.default_sphere_scene(), \
        jax_scene.sphere_scene_lights()

    def loss(albedo, rough, intensity, center, radius, origin, look_at):
        s = spheres.replace(center=center, radius=radius,
                            materials=spheres.materials.replace(
                                albedo=albedo, roughness=rough))
        img = jax_pt.trace_image_sample(
            jax_pt.spheres_hit_fn(s), lights.replace(intensity=intensity),
            JaxCamera(**CAM), JaxRenderConfig(**cfg_kw),
            jax_pt.ArrayStream(jnp.asarray(uniforms)), origin=origin,
            look_at=look_at)
        return jnp.mean(img)

    args = (spheres.materials.albedo, spheres.materials.roughness,
            lights.intensity, spheres.center, spheres.radius,
            jnp.asarray(CAM["origin"], jnp.float32),
            jnp.asarray(CAM["look_at"], jnp.float32))
    with jax.disable_jit():
        g = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return dict(zip(LEAVES, (np.asarray(x) for x in g)))


def port_grads(cfg_kw, uniforms):
    """The port's gradients, from the JAX scene's leaves carried across by
    ``spheres_from_arrays``."""
    spheres = scene.spheres_from_arrays(
        sphere_arrays(jax_scene.default_sphere_scene()), "cpu")
    lights = scene.sphere_scene_lights("cpu")
    leaves = {
        "albedo": spheres.materials.albedo,
        "roughness": spheres.materials.roughness,
        "intensity": lights.intensity, "center": spheres.center,
        "radius": spheres.radius,
        "origin": torch.tensor(CAM["origin"], dtype=torch.float32),
        "look_at": torch.tensor(CAM["look_at"], dtype=torch.float32)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    s = dataclasses.replace(
        spheres, center=leaves["center"], radius=leaves["radius"],
        materials=dataclasses.replace(spheres.materials,
                                      albedo=leaves["albedo"],
                                      roughness=leaves["roughness"]))
    img = pathtracer.trace_image_sample(
        pathtracer.spheres_hit_fn(s),
        dataclasses.replace(lights, intensity=leaves["intensity"]),
        CameraConfig(**CAM), RenderConfig(**cfg_kw),
        ArrayStream(torch.tensor(uniforms)), origin=leaves["origin"],
        look_at=leaves["look_at"])
    img.mean().backward()
    return {k: v.grad for k, v in leaves.items()}


@pytest.fixture(scope="module", params=list(CONFIGS))
def grads(request):
    cfg_kw = CONFIGS[request.param]
    n_bounces = cfg_kw["max_depth"] + cfg_kw["rr_bounces"]
    u = host_uniforms(5, CAM["width"] * CAM["height"],
                      total_slots(2, n_bounces))
    return port_grads(cfg_kw, u), jax_grads(cfg_kw, u)


@pytest.mark.parametrize("leaf", LEAVES)
def test_sphere_gradients_match_jax(grads, leaf):
    port, want = grads
    assert_grads_match(port[leaf], want[leaf], leaf)
    assert np.abs(want[leaf]).max() > 1e-6, leaf


@pytest.mark.parametrize("fn,bounds", [
    ("maximum", (0.5,)), ("minimum", (0.5,)), ("clip", (0.5, 0.75)),
    ("clip", (0.25, 0.5))])
def test_bounds_split_the_gradient_at_a_tie_as_jax(fn, bounds):
    """``safemath.maximum``/``minimum``/``clip`` equal ``jnp``'s in value
    and gradient, ties included (half the gradient where x equals the
    bound; ``torch.clamp`` would pass all of it)."""
    x = np.array([0.1, 0.25, 0.5, 0.6, 0.75, 0.9], np.float32)
    want_v, want_g = jax.value_and_grad(
        lambda a: jnp.sum(getattr(jnp, fn)(a, *bounds) * jnp.arange(6.0)))(
            jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = getattr(safemath, fn)(xt, *bounds)
    total = (got * torch.arange(6.0)).sum()
    total.backward()
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(getattr(jnp, fn)(x, *bounds)))
    assert float(total.detach()) == float(want_v)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    assert 0.0 < float(xt.grad[2]) < 2.0  # the tie at 0.5 took half
