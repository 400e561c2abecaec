"""PyTorch port vs JAX package: primary-visibility silhouettes of spheres
(``models/edge_aware.trace_edge_aware``).

Scene: the default sphere scene of ``tests/test_visibility_gradients.py``
at 24x20 from the origin toward -z, ``max_depth=2``, the seed-9
uniforms.  Inputs, conversions and JAX's ``jax.disable_jit()`` as in
``tests/test_torch_edge_aware.py``.

Tolerances: images rtol 1e-4, atol 1e-5 on every pixel; gradients rtol
1e-4, atol 1e-4 x max |JAX|.  The port alone: the central difference at
the silhouette uses JAX's tolerance (``test_visibility_gradients.py``:
|g - fd| <= 0.1 x max(0.05, |fd|)).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.models import edge_aware as jax_ea
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu_torch.models import edge_aware, pathtracer
from srt_tpu_torch.ops.rng import ArrayStream
from tests import test_visibility_gradients as jax_vis
from tests.test_torch_edge_aware import (assert_grads, assert_images,
                                         jax_image_and_grads, port_lights,
                                         port_of, port_spheres, t)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def default():
    """The default sphere scene: JAX's and the port's, the uniforms."""
    js, jl, u = jax_vis.setup()
    return js, jl, np.asarray(u), port_spheres(js), port_lights(jl)


@pytest.fixture(scope="module")
def jax_refs(default):
    js, jl, u, _, _ = default

    def ea(center, radius):
        return jax_ea.trace_edge_aware(
            js.replace(center=center, radius=radius), jl, jax_vis.CAM,
            jax_vis.CFG, JaxArrayStream(jnp.asarray(u)))

    return {"default": jax_image_and_grads(ea, (js.center, js.radius))}


def default_image(ps, pl, u):
    return edge_aware.trace_edge_aware(ps, pl, port_of(jax_vis.CAM),
                                       port_of(jax_vis.CFG), ArrayStream(t(u)))


def test_trace_edge_aware_image_matches_jax(default, jax_refs):
    _, _, u, ps, pl = default
    assert_images(default_image(ps, pl, u), jax_refs["default"][0], "image")


@pytest.mark.parametrize("leaf", ["center", "radius"])
def test_trace_edge_aware_gradients_match_jax(default, jax_refs, leaf):
    """d mean(image) / d (centres, radii), the silhouette term included."""
    _, _, u, ps, pl = default
    leaves = {"center": ps.center.clone().requires_grad_(True),
              "radius": ps.radius.clone().requires_grad_(True)}
    default_image(dataclasses.replace(ps, **leaves), pl, u).mean().backward()
    assert_grads(leaves[leaf].grad,
                 jax_refs["default"][1][("center", "radius").index(leaf)],
                 leaf)


def test_edge_aware_equals_plain_away_from_silhouettes(default):
    """Only the silhouette band blends: the other pixels equal the plain
    renderer's bit for bit."""
    _, _, u, ps, pl = default
    plain = pathtracer.trace_with_uniforms(
        pathtracer.spheres_hit_fn(ps), pl, port_of(jax_vis.CAM),
        port_of(jax_vis.CFG), t(u))
    diff = (plain - default_image(ps, pl, u)).abs().amax(2)
    assert float((diff == 0).float().mean()) > 0.7
    assert int((diff > 0).sum()) > 10


def test_radius_gradient_matches_central_difference(default):
    """The port alone: d mean / d radius of sphere 3 against a central
    difference over the whole image (no mask), at JAX's tolerance."""
    _, _, u, ps, pl = default

    def loss(dr):
        r = ps.radius + torch.nn.functional.one_hot(
            torch.tensor(3), ps.radius.shape[0]).float() * dr
        return default_image(dataclasses.replace(ps, radius=r), pl, u).mean()

    dr = torch.zeros((), requires_grad=True)
    loss(dr).backward()
    g = float(dr.grad)
    eps = 2e-3
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps)))
              - float(loss(torch.tensor(-eps)))) / (2 * eps)
    assert np.isfinite(g)
    assert abs(g - fd) <= 0.1 * max(0.05, abs(fd)), f"analytic {g} vs fd {fd}"
