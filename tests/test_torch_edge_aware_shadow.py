"""PyTorch port vs JAX package: soft shadows of mesh occluders
(``models/edge_aware_shadow.mesh_soft_shadow_fn``) through the
integrator's ``shadow_fn`` hook.

Scene: ``tests/test_mesh_shadow_boundary.py``'s (a ground box and a unit
cube out of the camera's view between it and one light; 24x20,
``max_depth=1``, the seed-33 uniforms, the dense sweep), with JAX's band
0.3.  The multiplier is taken on the primary hits' segments toward the
light; the trace as that test's ``_trace`` makes it.  The JAX scene's
leaves reach the port through ``scene_from_arrays``; gradients are taken
with respect to the shared vertex buffer through ``with_positions``.
JAX runs under ``jax.disable_jit()``, each reference once per module.

Tolerances: multipliers and images rtol 1e-4, atol 1e-5 on every entry;
gradients rtol 1e-4, atol 1e-4 x max |JAX|.  ``ray_tile`` > 0 (chunks
of 100 rays, the last one padded as JAX pads it) against ``ray_tile=0``:
equal multipliers and gradients within rtol 1e-6, atol 1e-7 x max (the
chunks' [N, E] products may round differently by size).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.models import edge_aware_shadow as jax_eas
from srt_tpu.models import mesh as jax_mesh
from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.models import edge_aware_shadow, mesh, pathtracer
from srt_tpu_torch.ops.rng import ArrayStream
from tests import test_mesh_shadow_boundary as jax_sb
from tests.test_torch_edge_aware import (assert_grads, assert_images,
                                         jax_image_and_grads, port_lights,
                                         port_of, t)
from tests.test_torch_traversal import port_scene_of

torch.set_num_threads(2)

BAND = 0.3


@pytest.fixture(scope="module")
def setup():
    js, jl, cam, cfg, u, _ = jax_sb._scene()
    u = np.asarray(u)
    ps = port_scene_of(js)
    pl = port_lights(jl)
    # The primary hits and their segments toward the light.
    with jax.disable_jit():
        from srt_tpu.camera import derive_viewport as jax_viewport
        from srt_tpu.camera import generate_rays as jax_rays
        o, d = jax_rays(jax_viewport(cam), cam.width, cam.height,
                        jnp.asarray(u[:, 0:2].T))
        rec = jax_mesh.mesh_hit_fn(js, method="dense")(o, d, cfg.t_min,
                                                       jnp.inf)
    p = np.asarray(rec.p)
    active = np.asarray(rec.hit)
    l_pos = np.repeat(np.asarray(jl.position).T, p.shape[1], axis=1)
    w = np.random.default_rng(6).normal(size=p.shape[1]).astype(np.float32)
    return js, jl, cam, cfg, u, ps, pl, (p, l_pos, active, w)


@pytest.fixture(scope="module")
def jax_refs(setup):
    js, jl, cam, cfg, u, _, _, (p, l_pos, active, w) = setup

    def mult(positions):
        s = jax_mesh.with_positions(js, positions)
        m = jax_eas.mesh_soft_shadow_fn(s, BAND)(
            jax_mesh.mesh_hit_fn(s, method="dense"), jnp.asarray(p),
            jnp.asarray(l_pos), cfg.t_min, jnp.asarray(active))
        return m

    def trace(positions):
        s = jax_mesh.with_positions(js, positions)
        return jax_sb._trace(s, jl, cam, cfg, jnp.asarray(u),
                             jax_eas.mesh_soft_shadow_fn(s, BAND))

    with jax.disable_jit():
        m, vjp = jax.vjp(mult, js.positions)
        g = vjp(jnp.asarray(w))[0]
    return {"mult": (np.asarray(m), np.asarray(g)),
            "trace": jax_image_and_grads(trace, (js.positions,))}


def port_mult(ps, cfg, segs, positions, ray_tile=0):
    p, l_pos, active, _ = segs
    s = mesh.with_positions(ps, positions)
    return edge_aware_shadow.mesh_soft_shadow_fn(s, BAND, ray_tile=ray_tile)(
        mesh.mesh_hit_fn(s, method="dense"), t(p), t(l_pos), cfg.t_min,
        t(active))


def test_soft_shadow_multiplier_matches_jax(setup, jax_refs):
    """The multiplier on the primary hits' light segments and its vertex
    gradient (the occluder's silhouette edges)."""
    js, _, _, cfg, _, ps, _, segs = setup
    pos = ps.positions.clone().requires_grad_(True)
    got = port_mult(ps, cfg, segs, pos)
    want_m, want_g = jax_refs["mult"]
    assert_images(got, want_m, "multiplier")
    band = (got > 0) & (got < 1)
    assert int(band.sum()) > 5 and int((got == 0).sum()) > 5
    (got * t(segs[3])).sum().backward()
    assert_grads(pos.grad, want_g, "d / d positions")


def test_ray_tiles_equal_one_pass(setup):
    """``ray_tile=100`` (five chunks of 480 rays, the last padded) against
    one pass: the same multipliers and gradients."""
    _, _, _, cfg, _, ps, _, segs = setup
    outs = []
    for ray_tile in (0, 100):
        pos = ps.positions.clone().requires_grad_(True)
        m = port_mult(ps, cfg, segs, pos, ray_tile)
        (m * t(segs[3])).sum().backward()
        outs.append((m.detach().numpy(), pos.grad.numpy()))
    (m0, g0), (m1, g1) = outs
    np.testing.assert_allclose(m1, m0, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g1, g0, rtol=1e-6, atol=1e-7 * np.abs(g0).max())
    assert np.abs(g0).max() > 0.0


def test_soft_shadow_trace_matches_jax(setup, jax_refs):
    """``trace_wavefront(shadow_fn=mesh_soft_shadow_fn(...))``: the image
    and d mean / d positions, whose occluder part is the shadow-boundary
    term alone (the occluder is out of view)."""
    _, _, cam, cfg, u, ps, pl, _ = setup
    pos = ps.positions.clone().requires_grad_(True)
    s = mesh.with_positions(ps, pos)
    o, d = generate_rays(derive_viewport(port_of(cam), device="cpu"),
                         cam.width, cam.height, t(u[:, 0:2].T))
    img = pathtracer.trace_wavefront(
        mesh.mesh_hit_fn(s, method="dense"), pl, o, d,
        ArrayStream(t(u[:, 2:])), port_of(cfg),
        shadow_fn=edge_aware_shadow.mesh_soft_shadow_fn(s, BAND))
    want_img, (want_g,) = jax_refs["trace"]
    assert_images(img, want_img, "image")
    img.mean().backward()
    assert_grads(pos.grad, want_g, "d / d positions")
    occluder = ps.positions[:, 1] > 0.0
    assert float(pos.grad[occluder].abs().max()) > 1e-6


def test_model_edges_deduplicate_shared_edges(setup):
    """Each shared edge once (owner: the lower triangle id), boundary
    edges with e_tb = -1; the cube models are closed: 18 edges each."""
    js, _, _, _, _, ps, _, _ = setup
    for b in range(ps.num_models):
        got = edge_aware_shadow.model_edges(ps, b)
        want = jax_eas.model_edges(js, b)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, np.asarray(y))
        assert len(got[0]) == 18 and (got[3] >= 0).all()
    with pytest.raises(AttributeError):
        edge_aware_shadow.model_edges(dataclasses.replace(ps, tri_adj=None),
                                      0)
