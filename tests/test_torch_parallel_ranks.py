"""The ranks of the port's sharded-rendering tests, and the tests of the
world launcher that need no JAX reference.

The sharded tests (``tests/test_torch_parallel.py``,
``test_torch_parallel_grads.py``, ``test_torch_multihost.py``) start
worlds of gloo ranks on the CPU with ``parallel.launch.spawn_world``: a
``FileStore`` under the test's temporary directory (so pytest-xdist
workers never clash on a port), the ``spawn`` start method (the test
process runs JAX's thread pools), one torch thread a rank and a time
limit on the rendezvous, every collective and the join.  A spawned rank
imports the module of its function, so the rank functions live here,
in a module that imports no JAX: each rank asserts that no ``jax``,
``optax`` or ``srt_tpu`` module is loaded.  The JAX references run in
the test process, on conftest's 8 virtual CPU devices.

Each setup is the one of the same-named test in ``tests/test_parallel.py``.
"""

import dataclasses
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.ops import rng
from srt_tpu_torch.ops.rng import host_uniforms, total_slots
from srt_tpu_torch.parallel import (device_mesh, render_sharded,
                                    sharded_loss_and_grad, trace_sharded)
from srt_tpu_torch.parallel.launch import spawn_world
from srt_tpu_torch.parallel.mesh import (_bounds_from_slices,
                                         init_distributed, local_shard_bounds)
from srt_tpu_torch.parallel.multihost import render_multihost
from srt_tpu_torch.parallel.render_sharded import _draw_uniforms
from srt_tpu_torch.scene import (default_sphere_scene, model_scene_lights,
                                 sphere_scene_lights)
from srt_tpu_torch.utils import procgen
from srt_tpu_torch.utils.flatten import flatten_models

# Seconds a test world may take, rendezvous to join (about 5 s on an idle
# 8-core CPU; the limit leaves room for a loaded test run).
WORLD_TIMEOUT = 300.0

# Setups of tests/test_parallel.py.
SPHERE_CAM = dict(width=16, height=16)
SPHERE_CFG = dict(max_depth=3, rr_bounces=1)
RENDER_2D_CAM = dict(width=16, height=8)
RENDER_2D_CFG = dict(max_depth=2, rr_bounces=1, spp=2)
MESH_CAM = dict(width=16, height=8, origin=(0.0, 0.5, 4.0),
                look_at=(0.0, 0.0, 0.0))
MESH_CFG = dict(max_depth=2, rr_bounces=1)
WALK_CFG = dict(max_depth=2, rr_bounces=0)
GRAD_CAM = dict(width=8, height=8)
GRAD_CFG = dict(max_depth=2, rr_bounces=0)
MESH_GRAD_CAM = dict(width=8, height=8, origin=(0.0, 0.5, 4.0),
                     look_at=(0.0, 0.0, 0.0))
MULTIHOST_CAM = dict(width=16, height=8)
MULTIHOST_CFG = dict(max_depth=2, rr_bounces=1)


def assert_no_jax():
    bad = [m for m in sys.modules
           if m in ("jax", "optax", "srt_tpu")
           or m.startswith(("jax.", "optax.", "srt_tpu."))]
    assert not bad, bad


def run_world(fn, world, tmp_dir, args=(), timeout=WORLD_TIMEOUT):
    """``fn`` on a gloo world of ``world`` CPU ranks."""
    return spawn_world(fn, world, args, workdir=str(tmp_dir), device="cpu",
                       timeout=timeout, threads=1)


def uniforms_for(seed, cam, cfg, lights):
    n = cam["width"] * cam["height"]
    return torch.tensor(host_uniforms(
        seed, n, total_slots(lights.count,
                             cfg["max_depth"] + cfg["rr_bounces"])))


def rays_of(cam, uniforms):
    vp = derive_viewport(CameraConfig(**cam), device="cpu")
    return generate_rays(vp, cam["width"], cam["height"], uniforms[:, 0:2].T)


def mesh_scene(pad_to=1):
    return mesh.upload(flatten_models([procgen.uv_sphere(6, 8, radius=1.0)],
                                      pad_to=pad_to), device="cpu")


def walk_hit(s):
    return mesh.mesh_hit_fn(s, method="walk", kernel_tile=128)


def dense_hit(s):
    return mesh.mesh_hit_fn(s, method="dense")


def unsharded_render(make_hit_fn, scene, lights, cam, cfg, key):
    """What ``render_sharded`` computes, in one process with no group:
    ``trace_wavefront`` over ``_draw_uniforms(fold_in(key, s))``."""
    cam, cfg = CameraConfig(**cam), RenderConfig(**cfg)
    n = cam.width * cam.height
    acc = torch.zeros((3, n))
    for s in range(cfg.spp):
        u = _draw_uniforms(rng.fold_in(key, s), n, lights.count,
                           cfg.max_depth + cfg.rr_bounces)
        o, d = rays_of(dataclasses.asdict(cam), u)
        stream = rng.ArrayStream(u)
        stream.take(2)
        acc = acc + pathtracer.trace_wavefront(make_hit_fn(scene), lights, o,
                                               d, stream, cfg)
    return (acc / cfg.spp).T.reshape(cam.height, cam.width, 3)


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------

def forward_rank(rank, world):
    """The forward passes of tests/test_parallel.py on a world of 8: the
    sphere trace and the dense mesh trace on (8, 1), the render on (4, 2),
    the walk on the (2, 1) mesh of ranks 0 and 1 (the others must be
    refused), and 100 rays on 8 shards (refused)."""
    assert_no_jax()
    out = {}
    spheres, lights = default_sphere_scene("cpu"), sphere_scene_lights("cpu")
    m81 = device_mesh(8, 1, device="cpu")
    u = uniforms_for(3, SPHERE_CAM, SPHERE_CFG, lights)
    o, d = rays_of(SPHERE_CAM, u)
    out["sphere"] = trace_sharded(pathtracer.spheres_hit_fn, spheres, lights,
                                  o, d, u, RenderConfig(**SPHERE_CFG), m81)
    try:
        trace_sharded(pathtracer.spheres_hit_fn, spheres, lights, o[:, :100],
                      d[:, :100], u[:100], RenderConfig(**SPHERE_CFG), m81)
    except ValueError:
        out["uneven_refused"] = True

    m_lights = model_scene_lights("cpu")
    u = uniforms_for(11, MESH_CAM, MESH_CFG, m_lights)
    o, d = rays_of(MESH_CAM, u)
    out["dense"] = trace_sharded(dense_hit, mesh_scene(), m_lights, o, d, u,
                                 RenderConfig(**MESH_CFG), m81)

    m42 = device_mesh(4, 2, device="cpu")
    out["coord42"] = m42.get_coordinate()
    out["render2d"] = render_sharded(
        pathtracer.spheres_hit_fn, spheres, lights,
        CameraConfig(**RENDER_2D_CAM), RenderConfig(**RENDER_2D_CFG),
        rng.key(0, "cpu"), m42)

    m21 = device_mesh(2, 1, device="cpu")
    u = uniforms_for(11, MESH_CAM, WALK_CFG, m_lights)
    o, d = rays_of(MESH_CAM, u)
    try:
        out["walk"] = trace_sharded(walk_hit, mesh_scene(128), m_lights, o, d,
                                    u, RenderConfig(**WALK_CFG), m21)
    except ValueError:
        out["walk_refused"] = True
    return out


def scene_grads(grads):
    """{field path: numpy gradient} of a gradient scene's non-None
    tensors."""
    from srt_tpu_torch.optim import _leaves_with_paths
    return {p: g.numpy() for p, g in _leaves_with_paths(grads)}


def grads_rank(rank, world):
    """Sphere gradients of ``sharded_loss_and_grad`` on (1, 1), (8, 1) and
    (4, 2); the mesh train step's on (1, 1) and (8, 1).  A rank outside a
    mesh skips it."""
    assert_no_jax()
    out = {}
    spheres, lights = default_sphere_scene("cpu"), sphere_scene_lights("cpu")
    cam, cfg = CameraConfig(**GRAD_CAM), RenderConfig(**GRAD_CFG)
    for shape in ((1, 1), (8, 1), (4, 2)):
        m = device_mesh(*shape, device="cpu")
        if m.get_coordinate() is None:
            continue
        f = sharded_loss_and_grad(pathtracer.spheres_hit_fn, lights, cam,
                                  cfg, m)
        loss, g = f(spheres, torch.zeros(8, 8, 3), rng.key(7, "cpu"))
        out[("sphere", shape)] = (float(loss), scene_grads(g),
                                  g.materials.use_spec is None)

    scene = mesh_scene()
    m_lights = model_scene_lights("cpu")
    cam = CameraConfig(**MESH_GRAD_CAM)
    for shape in ((1, 1), (8, 1)):
        m = device_mesh(*shape, device="cpu")
        if m.get_coordinate() is None:
            continue
        diffuse = scene.mat_diffuse.clone().requires_grad_(True)
        positions = scene.positions.clone().requires_grad_(True)
        s = mesh.with_positions(
            dataclasses.replace(scene, mat_diffuse=diffuse), positions)
        img = render_sharded(dense_hit, s, m_lights, cam, cfg,
                             rng.key(3, "cpu"), m)
        loss = (img ** 2).mean()
        loss.backward()
        out[("mesh", shape)] = (float(loss.detach()), diffuse.grad.numpy(),
                                positions.grad.numpy())
    return out


def multihost_rank(rank, world):
    """``render_multihost`` of the sphere scene on a (world, 1) mesh after
    a second ``init_distributed`` (a no-op), with each rank's bounds."""
    assert_no_jax()
    before = (dist.get_rank(), dist.get_world_size())
    init_distributed(device="cpu")
    init_distributed("localhost:1", world, rank, device="cpu")
    m = device_mesh(device="cpu")
    img = render_multihost(
        pathtracer.spheres_hit_fn, default_sphere_scene("cpu"),
        sphere_scene_lights("cpu"), CameraConfig(**MULTIHOST_CAM),
        RenderConfig(**MULTIHOST_CFG), rng.key(5, "cpu"), m)
    return dict(image=img, same_world=before == (dist.get_rank(),
                                                 dist.get_world_size()),
                bounds=local_shard_bounds(128, m),
                bounds_of=[local_shard_bounds(128, m, r)
                           for r in range(world)])


def failing_rank(rank, world):
    assert_no_jax()
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def hanging_rank(rank, world):
    time.sleep(600)


# ---------------------------------------------------------------------------
# Tests that need no JAX reference
# ---------------------------------------------------------------------------

def test_bounds_from_slices_cases_of_jax():
    """``_bounds_from_slices``, carried over verbatim: JAX's cases
    (tests/test_parallel.py:229-236), against JAX's function."""
    from srt_tpu.parallel.mesh import _bounds_from_slices as jax_bounds
    for slices in ([slice(16, 24), slice(24, 32)], [slice(0, 8)], [],
                   [slice(None, 8), slice(8, None)]):
        assert _bounds_from_slices(slices, 64) == jax_bounds(slices, 64)
    assert _bounds_from_slices([slice(16, 24), slice(24, 32)], 64) == (16, 32)
    assert _bounds_from_slices([slice(0, 8)], 64) == (0, 8)
    for f in (_bounds_from_slices, jax_bounds):
        with pytest.raises(ValueError):
            f([slice(0, 8), slice(16, 24)], 64)


def test_init_distributed_without_a_launcher_is_a_no_op():
    """One process with no launcher environment and no coordinator joins
    no group, called twice; several processes without one raise."""
    init_distributed(device="cpu")
    init_distributed(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        init_distributed(num_processes=2, device="cpu")


def test_spawn_world_reports_a_failed_rank(tmp_path):
    """A rank that raises ends the world: the others (blocked in a
    barrier) are killed, and the call raises with the rank's traceback."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_world(failing_rank, 2, tmp_path)
    assert time.monotonic() - t0 < WORLD_TIMEOUT


def test_spawn_world_kills_a_hung_world(tmp_path):
    """A world that outlives its limit is killed and raises."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_world(hanging_rank, 2, tmp_path, timeout=10.0)
    assert time.monotonic() - t0 < 60.0
