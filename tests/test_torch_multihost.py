"""PyTorch port vs JAX package: multi-process tiles and image assembly
(``srt_tpu_torch.parallel.multihost`` against ``srt_tpu.parallel.multihost``).

``render_multihost`` of the default sphere scene (16x8, 2 + 1 bounces,
key 5), as ``tests/test_parallel.py`` renders it: in this process (a
world of 1, which ``device_mesh`` starts on an in-process store) against
the full-image trace of the same uniforms and against JAX's
single-process ``render_multihost``; and on a gloo world of 2 CPU ranks
(``tests/test_torch_parallel_ranks.py``), where each rank traces its tile
and both assemble the same image.  Tolerances: port against port, JAX's
own (rtol 1e-6 / atol 1e-7); port against JAX, the image criterion of
``tests/test_torch_spheres.py``, with JAX under ``jax.disable_jit()``.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.parallel import device_mesh as jax_device_mesh
from srt_tpu.parallel.multihost import render_multihost as jax_multihost
from srt_tpu.scene import default_sphere_scene as jax_spheres
from srt_tpu.scene import sphere_scene_lights as jax_sphere_lights
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import pathtracer
from srt_tpu_torch.ops import rng
from srt_tpu_torch.parallel import device_mesh
from srt_tpu_torch.parallel.mesh import init_distributed, local_shard_bounds
from srt_tpu_torch.parallel.multihost import (assemble_image,
                                              render_multihost)
from srt_tpu_torch.parallel.render_sharded import _draw_uniforms
from srt_tpu_torch.scene import default_sphere_scene, sphere_scene_lights
from tests.test_torch_parallel_ranks import (MULTIHOST_CAM, MULTIHOST_CFG,
                                             multihost_rank, rays_of,
                                             run_world)
from tests.test_torch_spheres import assert_images_match

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def one_process():
    """(image, the mesh's bounds) of ``render_multihost`` in this process;
    the world of 1 it starts is ended afterwards."""
    assert not dist.is_initialized()
    try:
        m = device_mesh(device="cpu")
        assert (dist.get_world_size(), m.get_coordinate()) == (1, (0, 0))
        img = render_multihost(
            pathtracer.spheres_hit_fn, default_sphere_scene("cpu"),
            sphere_scene_lights("cpu"), CameraConfig(**MULTIHOST_CAM),
            RenderConfig(**MULTIHOST_CFG), rng.key(5, "cpu"), m)
        init_distributed(device="cpu")  # a group exists: a no-op
        yield img, local_shard_bounds(128, m), m
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(multihost_rank, 2, tmp_path_factory.mktemp("world2"))


def full_trace():
    """The full-image trace of ``_draw_uniforms(key(5))`` (one sample, the
    key not folded, as JAX's multihost reference)."""
    lights = sphere_scene_lights("cpu")
    cfg = RenderConfig(**MULTIHOST_CFG)
    u = _draw_uniforms(rng.key(5, "cpu"), 128, lights.count,
                       cfg.max_depth + cfg.rr_bounces)
    o, d = rays_of(MULTIHOST_CAM, u)
    stream = rng.ArrayStream(u)
    stream.take(2)
    return pathtracer.trace_wavefront(
        pathtracer.spheres_hit_fn(default_sphere_scene("cpu")), lights, o, d,
        stream, cfg).T.reshape(8, 16, 3).numpy()


def test_multihost_render_single_process_matches_full_trace(one_process):
    """One process owns every row and its tile is the image: equal to the
    full-image trace of the same uniforms, and to JAX's single-process
    ``render_multihost`` by the image criterion."""
    img, bounds, _ = one_process
    assert bounds == (0, 128) and img.shape == (8, 16, 3)
    ref = full_trace()
    np.testing.assert_allclose(img, ref, rtol=1e-6, atol=1e-7)
    with jax.disable_jit():
        want = jax_multihost(jax_pt.spheres_hit_fn, jax_spheres(),
                             jax_sphere_lights(), JaxCamera(**MULTIHOST_CAM),
                             JaxRenderConfig(**MULTIHOST_CFG),
                             jax.random.key(5), jax_device_mesh(8, 1))
    assert_images_match(torch.tensor(img), want)


def test_assemble_image_in_a_world_of_one_needs_the_whole_image(one_process):
    """A world of 1 refuses a tile that is not the whole image."""
    _, _, m = one_process
    with pytest.raises(ValueError):
        assemble_image(torch.zeros(3, 64), (0, 64),
                       CameraConfig(**MULTIHOST_CAM), m)


def test_two_processes_assemble_the_same_image(world2):
    """A gloo world of 2: every rank assembles the image of the
    full-image trace (rtol 1e-6, atol 1e-7), bit for bit on both ranks."""
    ref = full_trace()
    for r, w in enumerate(world2):
        np.testing.assert_allclose(w["image"], ref, rtol=1e-6, atol=1e-7,
                                   err_msg=f"rank {r}")
        assert np.array_equal(w["image"], world2[0]["image"])


def test_local_shard_bounds_per_rank(world2):
    """Rank r of the (2, 1) mesh owns rows [64 r, 64 r + 64) of 128, seen
    from either rank."""
    assert [w["bounds"] for w in world2] == [(0, 64), (64, 128)]
    assert all(w["bounds_of"] == [(0, 64), (64, 128)] for w in world2)


def test_init_distributed_twice_is_a_no_op(world2):
    """In a running world, ``init_distributed`` (with and without a
    coordinator) leaves the group as it was."""
    assert all(w["same_world"] for w in world2)
