"""PyTorch port vs JAX package: sharded forward passes
(``srt_tpu_torch.parallel`` against ``srt_tpu.parallel``).

The counterparts of ``tests/test_parallel.py``'s forward tests, on one
gloo world of 8 CPU ranks (``tests/test_torch_parallel_ranks.py``): the
sphere trace and the dense mesh trace on an (8, 1) mesh, the render on a
(4, 2) mesh, and the walk on a (2, 1) mesh of ranks 0 and 1 (JAX builds
it from 8 devices too; the other ranks are refused).

Two tolerances.  Port sharded against port unsharded: JAX's own, rtol
1e-5 / atol 1e-6; the sphere and dense routes are also equal bit for bit
(every rank traces its columns with the unsharded arithmetic), the walk
is held at the tolerance only.  Port against JAX: the image criterion of
``tests/test_torch_spheres.py`` (>= 99.5% of pixels within rtol 1e-4 /
atol 1e-5), against JAX's sharded output for the (4, 2) render and the
dense trace.  JAX compiles the ``shard_map`` body, which contracts
multiply-adds; on the sphere trace that moves 2 of 256 pixels by 2e-3
relative, so there JAX's sharded trace is held to its unsharded trace
at its own tolerance and the port to JAX's unsharded trace under
``jax.disable_jit()``.  The walk is held to JAX's unsharded dense trace
(JAX's own test holds its sharded Pallas route to that trace).
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
from srt_tpu.parallel import device_mesh as jax_device_mesh
from srt_tpu.parallel import trace_sharded as jax_trace_sharded
from srt_tpu.parallel.render_sharded import render_sharded as jax_render
from srt_tpu.scene import default_sphere_scene as jax_spheres
from srt_tpu.scene import model_scene_lights as jax_model_lights
from srt_tpu.scene import sphere_scene_lights as jax_sphere_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import pathtracer
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import (default_sphere_scene, model_scene_lights,
                                 sphere_scene_lights)
from tests.test_torch_parallel_ranks import (
    MESH_CAM, MESH_CFG, RENDER_2D_CAM, RENDER_2D_CFG, SPHERE_CAM, SPHERE_CFG,
    WALK_CFG, dense_hit, forward_rank, mesh_scene, run_world,
    uniforms_for, unsharded_render)
from tests.test_torch_spheres import assert_images_match

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of ``forward_rank`` on a world of 8."""
    return run_world(forward_rank, 8, tmp_path_factory.mktemp("world8"))


def assert_sharded_equal(outs, ref, exact=True):
    """Every rank's [3, N] radiance against the unsharded [N, 3]."""
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out.T.numpy(), ref, rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {r}")
        if exact:
            assert np.array_equal(out.T.numpy(), ref), f"rank {r}"


def jax_sharded(make_hit_fn, scene, lights, cam, cfg, uniforms, mesh):
    u = jnp.asarray(uniforms.numpy())
    o, d = jax_generate_rays(jax_viewport(JaxCamera(**cam)), cam["width"],
                             cam["height"], u[:, 0:2].T)
    return np.asarray(jax_trace_sharded(make_hit_fn, scene, lights, o, d, u,
                                        JaxRenderConfig(**cfg), mesh)).T


def as_image(flat, cam):
    """[N, 3] -> [H, W, 3]."""
    return np.asarray(flat).reshape(cam["height"], cam["width"], 3)


def test_trace_sharded_matches_single_device(world):
    """Spheres, (8, 1): every rank's gathered radiance equals the
    unsharded trace bit for bit.  Against JAX: JAX's sharded trace equals
    its unsharded trace at its own tolerance, and the port equals JAX's
    unsharded trace under ``jax.disable_jit()`` by the image criterion.
    (The compiled trace contracts multiply-adds: on this setup 2 of 256
    pixels move by 2e-3 relative between JAX compiled and JAX under
    ``disable_jit``, beyond the criterion at 256 pixels.)"""
    lights = sphere_scene_lights("cpu")
    u = uniforms_for(3, SPHERE_CAM, SPHERE_CFG, lights)
    ref = pathtracer.trace_with_uniforms(
        pathtracer.spheres_hit_fn(default_sphere_scene("cpu")), lights,
        CameraConfig(**SPHERE_CAM), RenderConfig(**SPHERE_CFG),
        u).reshape(-1, 3).numpy()
    assert_sharded_equal([w["sphere"] for w in world], ref)
    sharded = jax_sharded(jax_pt.spheres_hit_fn, jax_spheres(),
                          jax_sphere_lights(), SPHERE_CAM, SPHERE_CFG, u,
                          jax_device_mesh(8, 1))

    def jax_trace():
        return np.asarray(jax_pt.trace_with_uniforms(
            jax_pt.spheres_hit_fn(jax_spheres()), jax_sphere_lights(),
            JaxCamera(**SPHERE_CAM), JaxRenderConfig(**SPHERE_CFG),
            jnp.asarray(u.numpy()))).reshape(-1, 3)

    np.testing.assert_allclose(sharded, jax_trace(), rtol=1e-5, atol=1e-6)
    with jax.disable_jit():
        want = jax_trace()
    assert_images_match(torch.tensor(as_image(ref, SPHERE_CAM)),
                        as_image(want, SPHERE_CAM))


def test_trace_sharded_refuses_rays_that_do_not_split(world):
    """100 rays on 8 rays shards raise ``ValueError`` on every rank, as
    ``shard_map`` refuses them."""
    assert all(w.get("uneven_refused") for w in world)


def test_render_sharded_2d_mesh(world):
    """The (4, 2) mesh: rank (r, s) at rays coordinate r; every rank holds
    the image of the unsharded render bit for bit, and JAX's
    ``render_sharded`` under jit on its (4, 2) mesh for key 0 (equal
    uniforms, bit for bit) by the image criterion."""
    assert [w["coord42"] for w in world] == [
        (r, s) for r in range(4) for s in range(2)]
    ref = unsharded_render(pathtracer.spheres_hit_fn,
                           default_sphere_scene("cpu"),
                           sphere_scene_lights("cpu"), RENDER_2D_CAM,
                           RENDER_2D_CFG, rng.key(0, "cpu"))
    for r, w in enumerate(world):
        assert tuple(w["render2d"].shape) == (8, 16, 3)
        assert torch.equal(w["render2d"], ref), f"rank {r}"
    mesh = jax_device_mesh(4, 2)
    lights = jax_sphere_lights()
    want = jax.jit(lambda s, k: jax_render(
        jax_pt.spheres_hit_fn, s, lights, JaxCamera(**RENDER_2D_CAM),
        JaxRenderConfig(**RENDER_2D_CFG), k, mesh))(jax_spheres(),
                                                   jax.random.key(0))
    assert_images_match(ref, want)


def test_sharded_mesh_render_matches_single_device(world):
    """``uv_sphere(6, 8)`` through the dense sweep, (8, 1): bit for bit
    against the unsharded trace, and JAX's sharded trace by the image
    criterion."""
    lights = model_scene_lights("cpu")
    u = uniforms_for(11, MESH_CAM, MESH_CFG, lights)
    ref = pathtracer.trace_with_uniforms(
        dense_hit(mesh_scene()), lights, CameraConfig(**MESH_CAM),
        RenderConfig(**MESH_CFG), u).reshape(-1, 3).numpy()
    assert_sharded_equal([w["dense"] for w in world], ref)
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(6, 8,
                                                            radius=1.0)],
                                     pad_to=1))
    want = jax_sharded(lambda s: jax_mesh.mesh_hit_fn(s, method="dense"), js,
                       jax_model_lights(), MESH_CAM, MESH_CFG, u,
                       jax_device_mesh(8, 1))
    assert_images_match(torch.tensor(as_image(ref, MESH_CAM)),
                        as_image(want, MESH_CAM))


def test_sharded_walk_matches_single_device(world):
    """The walk (the kernels' plain versions on the CPU) on ranks 0 and 1
    of a (2, 1) mesh against the unsharded dense trace at JAX's
    tolerance, and against JAX's unsharded dense trace by the image
    criterion (JAX's own test holds its sharded pallas route to that
    trace)."""
    lights = model_scene_lights("cpu")
    u = uniforms_for(11, MESH_CAM, WALK_CFG, lights)
    ref = pathtracer.trace_with_uniforms(
        dense_hit(mesh_scene(128)), lights, CameraConfig(**MESH_CAM),
        RenderConfig(**WALK_CFG), u).reshape(-1, 3).numpy()
    assert_sharded_equal([w["walk"] for w in world[:2]], ref, exact=False)
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(6, 8,
                                                            radius=1.0)],
                                     pad_to=128))
    want = jax_pt.trace_with_uniforms(
        jax_mesh.mesh_hit_fn(js, method="dense"), jax_model_lights(),
        JaxCamera(**MESH_CAM), JaxRenderConfig(**WALK_CFG),
        jnp.asarray(u.numpy()))
    assert_images_match(torch.tensor(as_image(ref, MESH_CAM)), want)


def test_ranks_outside_the_mesh_are_refused(world):
    """Ranks 2-7 are outside the (2, 1) mesh: ``trace_sharded`` raises
    ``ValueError`` there and traces nothing."""
    for r, w in enumerate(world):
        assert ("walk" in w) == (r < 2) and w.get("walk_refused") == (
            True if r >= 2 else None), f"rank {r}"
