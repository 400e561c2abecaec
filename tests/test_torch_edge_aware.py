"""PyTorch port vs JAX package: the integrator's edge-aware hooks
(``bounce_step(shadow_fn=, return_aux=)``, ``trace_wavefront(shadow_fn=)``),
the sphere soft shadows and ``render_edge_aware``
(``models/edge_aware.py``).

Scene: the shadow scene of ``tests/test_visibility_gradients.py`` (a
ground sphere, an occluder seen only through its shadow, one light;
24x20, ``max_depth=1``, the seed-31 uniforms), with JAX's soft-shadow
band 0.25.  The same uniforms reach both packages through
``ArrayStream`` (``render_edge_aware``: both draw from key 3); the JAX
scene's leaves reach the port through ``spheres_from_arrays`` /
``lights_from_arrays``.  JAX runs under ``jax.disable_jit()`` (every
operation rounded as written, as ``tests/test_torch_spheres.py``
explains), each reference once per module.  The default scene and the
mirror reflections are in ``tests/test_torch_edge_aware_spheres.py``.

Tolerances: images rtol 1e-4, atol 1e-5 on every pixel; gradients rtol
1e-4, atol 1e-4 x max |JAX| (those of ``tests/test_torch_gradients.py``);
carries and aux of one bounce rtol 1e-4, atol 1e-5 (the port takes the
sphere root in float64, which moves hits on the radius-100 ground sphere
by up to 1.3e-5 relative), masks and stats exactly.
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
from srt_tpu.models import edge_aware as jax_ea
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu_torch import scene
from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import edge_aware, pathtracer
from srt_tpu_torch.ops import rng, safemath
from srt_tpu_torch.ops.rng import ArrayStream
from tests import test_visibility_gradients as jax_vis
from tests.test_torch_spheres import sphere_arrays

torch.set_num_threads(2)

SOFT_BAND = 0.25


def t(x):
    return torch.tensor(np.asarray(x))


def port_of(config):
    """The port's counterpart of a JAX camera or render config."""
    cls = CameraConfig if isinstance(config, JaxCamera) else RenderConfig
    return cls(**dataclasses.asdict(config))


def port_spheres(js):
    return scene.spheres_from_arrays(sphere_arrays(js), "cpu")


def port_lights(jl):
    return scene.lights_from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in ("position", "color",
                                                 "intensity")}, "cpu")


def assert_images(got, want, name):
    """Images: rtol 1e-4, atol 1e-5 on every pixel."""
    got = got.detach().numpy()
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5,
                               err_msg=name)


def assert_grads(got, want, name):
    """Gradients: rtol 1e-4, atol 1e-4 x max |JAX|; JAX's nonzero."""
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-6, name
    got = got.detach().numpy()
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=name)


def jax_image_and_grads(fn, args):
    """(image, gradients of its mean w.r.t. ``args``) of the JAX ``fn``,
    one linearization under ``jax.disable_jit()``."""
    with jax.disable_jit():
        img, vjp = jax.vjp(fn, *args)
        grads = vjp(jnp.ones_like(img) / img.size)
    return np.asarray(img), [np.asarray(g) for g in grads]


def primary_rays(cam, uniforms):
    """The port's primary rays from the first two uniform slots."""
    jitter = t(uniforms[:, 0:2].T)
    return generate_rays(derive_viewport(port_of(cam), device="cpu"),
                         cam.width, cam.height, jitter)


@pytest.fixture(scope="module")
def shadow():
    """The shadow scene: JAX's, the port's, camera, config, uniforms."""
    js, jl, cam, cfg, u = jax_vis._shadow_scene()
    return js, jl, cam, cfg, np.asarray(u), port_spheres(js), port_lights(jl)


@pytest.fixture(scope="module")
def jax_refs(shadow):
    """Every JAX reference of this module, computed once."""
    js, jl, cam, cfg, u, _, _ = shadow

    def soft(center):
        return jax_ea.trace_edge_aware(
            js.replace(center=center), jl, cam, cfg,
            JaxArrayStream(jnp.asarray(u)), soft_shadow_band=SOFT_BAND)

    refs = {"soft": jax_image_and_grads(soft, (js.center,))}
    o, d = jax_rays(jax_viewport(cam), cam.width, cam.height,
                    jnp.asarray(u[:, 0:2].T))
    n = cam.width * cam.height
    hit = jax_pt.spheres_hit_fn(js)
    shadow_fn = jax_ea.soft_shadow_fn(js, SOFT_BAND)
    with jax.disable_jit():
        refs["wavefront"] = jax_pt.trace_wavefront(
            hit, jl, o, d, JaxArrayStream(jnp.asarray(u[:, 2:])), cfg,
            return_stats=True, shadow_fn=shadow_fn)
        init = (o, d, jnp.ones((3, n)), jnp.zeros((3, n)),
                jnp.ones(n, bool), jnp.arange(n, dtype=jnp.int32))
        for name, fn in (("step", None), ("step_soft", shadow_fn)):
            refs[name] = jax_pt.bounce_step(
                hit, jl, cfg, init, 0, jnp.asarray(u[:, 2:].T), sort=False,
                shadow_fn=fn, return_aux=True)
        refs["render"] = np.asarray(jax_ea.render_edge_aware(
            js, jl, cam, dataclasses.replace(cfg, spp=2),
            jax.random.key(3)))
    return refs


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_bounce_step_aux_matches_jax(shadow, jax_refs, soft):
    """One bounce of the shadow scene's primaries with ``return_aux``: the
    carry, the stats (with ``shadow_fn`` every active hit counts as a
    shadow query) and the aux (lobe choice, roughness, hit, t) equal
    JAX's; the carry equals the one of the call without ``return_aux``."""
    _, _, cam, cfg, u, ps, pl = shadow
    j_carry, j_st, j_aux = jax_refs["step_soft" if soft else "step"]
    o, d = primary_rays(cam, u)
    cfg_p = port_of(cfg)
    fn = edge_aware.soft_shadow_fn(ps, SOFT_BAND) if soft else None
    carry = pathtracer.initial_carry(o, d, cfg_p, False)
    hit = pathtracer.spheres_hit_fn(ps)
    u_b = t(u[:, 2:].T)
    out, st, aux = pathtracer.bounce_step(hit, pl, cfg_p, carry, 0, u_b,
                                          sort=False, shadow_fn=fn,
                                          return_aux=True)
    np.testing.assert_array_equal(st.numpy(), np.asarray(j_st))
    if soft:
        assert int(st[1]) == int(aux["hit"].sum())
    for k, (a, b) in enumerate(zip(out, j_carry)):
        if a.dtype in (torch.bool, torch.int64):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), str(k))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5, err_msg=str(k))
    assert sorted(aux) == sorted(j_aux) == ["hit", "rough", "t", "take_spec"]
    for k in ("hit", "take_spec"):
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(j_aux[k]), k)
    for k in ("rough", "t"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(j_aux[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    plain, _ = pathtracer.bounce_step(hit, pl, cfg_p, carry, 0, u_b,
                                      sort=False, shadow_fn=fn)
    assert all(torch.equal(a, b) for a, b in zip(plain, out))


def test_return_aux_requires_unsorted_order(shadow):
    """``return_aux`` reports the slice's input order: ``sort=True``
    raises."""
    _, _, cam, cfg, u, ps, pl = shadow
    o, d = primary_rays(cam, u)
    cfg = port_of(cfg)
    with pytest.raises(ValueError):
        pathtracer.bounce_step(pathtracer.spheres_hit_fn(ps), pl, cfg,
                               pathtracer.initial_carry(o, d, cfg, False), 0,
                               t(u[:, 2:].T), sort=True, return_aux=True)


def test_trace_wavefront_soft_shadow_matches_jax(shadow, jax_refs):
    """``trace_wavefront(shadow_fn=soft_shadow_fn(...))`` on the shadow
    scene: the same radiance and stats as JAX's, and a penumbra band that
    differs from the binary shadow."""
    _, _, cam, cfg, u, ps, pl = shadow
    o, d = primary_rays(cam, u)
    hit = pathtracer.spheres_hit_fn(ps)
    got, st = pathtracer.trace_wavefront(
        hit, pl, o, d, ArrayStream(t(u[:, 2:])), port_of(cfg),
        return_stats=True, shadow_fn=edge_aware.soft_shadow_fn(ps, SOFT_BAND))
    want, j_st = jax_refs["wavefront"]
    np.testing.assert_array_equal(st.numpy(), np.asarray(j_st))
    assert_images(got, want, "soft shadow radiance")
    hard = pathtracer.trace_wavefront(hit, pl, o, d, ArrayStream(t(u[:, 2:])),
                                      port_of(cfg))
    diff = (hard - got).abs().amax(0)
    assert int((diff > 0).sum()) > 10 and float((diff == 0).float().mean()) > 0.5


def test_trace_edge_aware_soft_shadow_matches_jax(shadow, jax_refs):
    """``trace_edge_aware(soft_shadow_band=0.25)``: the image, and d
    mean(image) / d centres (the occluder is seen only through its
    shadow, so its whole gradient is the shadow-boundary term)."""
    _, _, cam, cfg, u, ps, pl = shadow
    c = ps.center.clone().requires_grad_(True)
    img = edge_aware.trace_edge_aware(
        dataclasses.replace(ps, center=c), pl, port_of(cam), port_of(cfg),
        ArrayStream(t(u)), soft_shadow_band=SOFT_BAND)
    want_img, (want_g,) = jax_refs["soft"]
    assert_images(img, want_img, "image")
    img.mean().backward()
    assert_grads(c.grad, want_g, "d / d center")
    assert float(c.grad[1].abs().max()) > 0.01


def test_render_edge_aware_two_samples_matches_jax(shadow, jax_refs):
    """``render_edge_aware`` with spp 2 from key 3: JAX's image (the
    threefry numbers are JAX's bit for bit), the mean of the samples
    drawn from ``fold_in(key, s)``."""
    _, _, cam, cfg, _, ps, pl = shadow
    cam_p = port_of(cam)
    cfg2 = dataclasses.replace(port_of(cfg), spp=2)
    key = rng.key(3, "cpu")
    got = edge_aware.render_edge_aware(ps, pl, cam_p, cfg2, key)
    assert_images(got, jax_refs["render"], "spp 2")
    n = cam.width * cam.height
    samples = [edge_aware.trace_edge_aware(
        ps, pl, cam_p, cfg2, rng.KeyStream(rng.fold_in(key, s), n))
        for s in range(2)]
    assert torch.equal(got, torch.stack(samples).mean(0))
    one = edge_aware.render_edge_aware(ps, pl, cam_p, port_of(cfg), key)
    assert torch.equal(one, samples[0])


def test_absolute_has_jax_gradient_at_zero():
    """``safemath.absolute`` equals ``jnp.abs`` in value and gradient,
    zeros of both signs included (+1 at 0; ``torch.abs`` gives 0 there)."""
    x = np.array([-1.5, -0.0, 0.0, 2.0], np.float32)
    want_v, want_g = jax.value_and_grad(
        lambda a: jnp.sum(jnp.abs(a) * jnp.arange(1.0, 5.0)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = safemath.absolute(xt)
    (got * torch.arange(1.0, 5.0)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.abs(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    assert float(want_g[2]) == 3.0
