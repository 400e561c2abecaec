"""PyTorch port vs JAX package: sharded gradients (the all-reduce of
replicated-scene gradients, ``srt_tpu_torch.parallel``).

The counterparts of ``tests/test_parallel.py``'s gradient tests, on one
gloo world of 8 CPU ranks (``tests/test_torch_parallel_ranks.py``):
``sharded_loss_and_grad`` of the default sphere scene (8x8, 2 bounces, key
7, target 0) on (1, 1), (8, 1) and (4, 2) meshes, and the mesh train
step's ``(mat_diffuse, positions)`` gradients (``uv_sphere(6, 8)``, the
dense sweep, 8x8, key 3) on (1, 1) and (8, 1).  The (1, 1) mesh is the
unsharded render, on rank 0.

Tolerances.  Port sharded against port unsharded: JAX's own, rtol 5e-4 /
atol 1e-5 (1e-6 on the mesh); every rank of a mesh holds the same
gradient.  Port against JAX: JAX's unsharded loss and gradient under
``jax.disable_jit()`` (``trace_wavefront`` over
``jax.random.uniform(fold_in(key, s), (n, d))``, what ``render_sharded``
computes on a (1, 1) mesh) at ``tests/test_torch_gradients.py``'s
tolerance, rtol 1e-4 / atol 1e-4 x max.  JAX's own (8, 1) and (4, 2)
gradients equal its (1, 1) gradients to 1.6e-6 relative on this setup,
so the comparison covers JAX's sharded values too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.camera import derive_viewport as jax_viewport
from srt_tpu.camera import generate_rays as jax_generate_rays
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu.ops.rng import total_slots as jax_total_slots
from srt_tpu.scene import default_sphere_scene as jax_spheres
from srt_tpu.scene import model_scene_lights as jax_model_lights
from srt_tpu.scene import sphere_scene_lights as jax_sphere_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from tests.test_torch_parallel_ranks import (GRAD_CAM, GRAD_CFG,
                                             MESH_GRAD_CAM, grads_rank,
                                             run_world)

torch.set_num_threads(2)

SPHERE_FIELDS = (".center", ".radius", ".materials.albedo",
                 ".materials.specular", ".materials.roughness",
                 ".materials.metalness")
SHARDED = ((8, 1), (4, 2))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of ``grads_rank`` on a world of 8."""
    return run_world(grads_rank, 8, tmp_path_factory.mktemp("grads8"))


def jax_loss_fn(make_scene_hit, lights, cam_kw, key):
    """JAX's unsharded L2 loss of one sample: ``trace_wavefront`` over
    ``jax.random.uniform(fold_in(key, 0), (n, d))``."""
    cam, cfg = JaxCamera(**cam_kw), JaxRenderConfig(**GRAD_CFG)
    n = cam.width * cam.height
    d = jax_total_slots(lights.count, cfg.max_depth + cfg.rr_bounces)

    def loss(*params):
        u = jax.random.uniform(jax.random.fold_in(key, 0), (n, d),
                               dtype=jnp.float32)
        o, di = jax_generate_rays(jax_viewport(cam), cam.width, cam.height,
                                  u[:, 0:2].T)
        stream = JaxArrayStream(u)
        stream.take(2)
        img = jax_pt.trace_wavefront(make_scene_hit(*params), lights, o, di,
                                     stream, cfg)
        return jnp.mean(img ** 2)
    return loss


@pytest.fixture(scope="module")
def jax_sphere():
    """(loss, {field path: gradient}) of JAX's unsharded sphere loss."""
    spheres = jax_spheres()

    def hit(center, radius, albedo, specular, roughness, metalness):
        return jax_pt.spheres_hit_fn(spheres.replace(
            center=center, radius=radius, materials=spheres.materials.replace(
                albedo=albedo, specular=specular, roughness=roughness,
                metalness=metalness)))

    m = spheres.materials
    args = (spheres.center, spheres.radius, m.albedo, m.specular,
            m.roughness, m.metalness)
    with jax.disable_jit():
        loss, g = jax.value_and_grad(
            jax_loss_fn(hit, jax_sphere_lights(), GRAD_CAM,
                        jax.random.key(7)),
            argnums=tuple(range(len(args))))(*args)
    return float(loss), dict(zip(SPHERE_FIELDS, (np.asarray(x) for x in g)))


@pytest.fixture(scope="module")
def jax_mesh_grads():
    """(loss, d/d mat_diffuse, d/d positions) of JAX's unsharded mesh
    train-step loss."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(6, 8,
                                                            radius=1.0)],
                                     pad_to=1))

    def hit(diffuse, positions):
        return jax_mesh.mesh_hit_fn(jax_mesh.with_positions(
            js.replace(mat_diffuse=diffuse), positions), method="dense")

    with jax.disable_jit():
        loss, g = jax.value_and_grad(
            jax_loss_fn(hit, jax_model_lights(), MESH_GRAD_CAM,
                        jax.random.key(3)),
            argnums=(0, 1))(js.mat_diffuse, js.positions)
    return float(loss), np.asarray(g[0]), np.asarray(g[1])


def assert_port_matches_jax(got, want, name):
    """rtol 1e-4, atol 1e-4 x max |want|."""
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=name)


def sharded_results(world, kind, shape):
    """Every rank's result on a mesh of ``shape`` (ranks 0.. in order)."""
    outs = [w[(kind, shape)] for w in world if (kind, shape) in w]
    assert len(outs) == shape[0] * shape[1]
    return outs


@pytest.mark.parametrize("shape", SHARDED, ids=["8x1", "4x2"])
@pytest.mark.parametrize("field", SPHERE_FIELDS)
def test_sphere_grads_match_unsharded_and_jax(world, jax_sphere, shape,
                                              field):
    """Each float field's gradient on every rank of the sharded mesh
    equals the (1, 1) gradient at JAX's tolerance, and the (1, 1)
    gradient equals JAX's."""
    ref = sharded_results(world, "sphere", (1, 1))[0][1]
    for r, (_, g, _) in enumerate(sharded_results(world, "sphere", shape)):
        np.testing.assert_allclose(g[field], ref[field], rtol=5e-4,
                                   atol=1e-5, err_msg=f"rank {r}")
    assert_port_matches_jax(ref[field], jax_sphere[1][field], field)


@pytest.mark.parametrize("shape", ((1, 1),) + SHARDED,
                         ids=["1x1", "8x1", "4x2"])
def test_sphere_loss_and_grad_tree(world, jax_sphere, shape):
    """The loss on every rank equals JAX's (rtol 1e-5, JAX's own); the
    gradient scene holds None for the bool field (JAX's float0), and
    every float field's gradient is finite, one of them nonzero."""
    for loss, g, use_spec_none in sharded_results(world, "sphere", shape):
        np.testing.assert_allclose(loss, jax_sphere[0], rtol=1e-5)
        assert use_spec_none
        assert sorted(g) == sorted(SPHERE_FIELDS)
        assert all(np.isfinite(x).all() for x in g.values())
        assert max(np.abs(x).max() for x in g.values()) > 0.0


@pytest.mark.parametrize("leaf", ["mat_diffuse", "positions"])
def test_sharded_mesh_train_step_grads(world, jax_mesh_grads, leaf):
    """The mesh train step: (8, 1) against (1, 1) at JAX's tolerance
    (rtol 5e-4, atol 1e-6) on every rank, and (1, 1) against JAX's; the
    losses equal (rtol 1e-5)."""
    k = {"mat_diffuse": 1, "positions": 2}[leaf]
    ref = sharded_results(world, "mesh", (1, 1))[0]
    for r, out in enumerate(sharded_results(world, "mesh", (8, 1))):
        np.testing.assert_allclose(out[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(out[k], ref[k], rtol=5e-4, atol=1e-6,
                                   err_msg=f"rank {r}")
    np.testing.assert_allclose(ref[0], jax_mesh_grads[0], rtol=1e-5)
    assert_port_matches_jax(ref[k], jax_mesh_grads[k], leaf)
    assert np.abs(ref[k]).max() > 1e-7
