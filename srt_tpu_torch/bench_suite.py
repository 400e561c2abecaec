"""Benchmark suite of the port: ``bench_suite.py``'s eleven configs.

Each config prints the JSON lines (``metric``, ``value``, ``unit``,
``vs_baseline``) that the JAX package's suite prints for it, with the
same text and units, except that the traversal JAX names ``pallas`` on
the TPU and ``dense`` on its CPU is ``walk`` here: the port's default on
every device (the kernels on the card, their plain versions on the CPU).
config7 keeps the dense sweep with ``pad_to=1``, as JAX's does.

  1. spheres 256x256, 2 bounces: forward vs the numpy oracle
     (``models/reference_cpu.py``)
  2. spheres 512x512, 16 spp, 4 bounces: forward Mrays/s and a gradient
  3. the Rubik grid 512x512: forward and backward wall time
  4. the headline mesh (101,760 triangles): the render plan's Mrays/s
  5. spheres through ``render_sharded`` at 1, 2, 4, 8 shards
  6. the headline mesh's material and vertex gradient
  7. a 1,728-triangle mesh through ``render_sharded``, dense sweep
  8. 502,600 triangles, above the stream threshold (streamed walks)
  9. the headline mesh textured (mip atlas, ray cones)
  10. inverse rendering: edge-aware Rubik (a), path-space headline (b)
  11. next-event estimation toward emissive meshes

Usage: ``python3 -m srt_tpu_torch.bench_suite [--device DEV]
[configs...]`` (default: all, in JAX's order).  The device defaults to
the card; ``--device cpu`` runs the plain versions.  The card takes JAX's
TPU sizes; the CPU, or ``SRT_SUITE_SMALL=1``, JAX's small ones.  A config
that raises prints ``configN FAILED``, the others still run, and the exit
code is 1.

Times are host clocks around work that ends in
``torch.cuda.synchronize()``; there is no compile, so a config's one warm
call is all its warm-up.  Keys are ``rng.key(seed)``, JAX's
``jax.random.key(seed)`` bit for bit.  The Rubik scenes are
``procgen.rubik_grid()``: the reference's Rubik OBJ is not in the
repository, and JAX's suite falls back to the same grid without it.
The scene and loss functions below (``config5_case``, ``config7_case``,
``mesh_loss``, ``config9_map``, ``config9_scene``, ``config9_run``,
``config11_scene``, ``config11_frame``) are also what ``chip_smoke.py``
drives.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh, pathtracer, reference_cpu
from srt_tpu_torch.ops import rng, traversal
from srt_tpu_torch.scene import (Lights, default_sphere_scene,
                                 model_scene_lights, sphere_scene_lights)
from srt_tpu_torch.utils import procgen
from srt_tpu_torch.utils.flatten import flatten_models

HEADLINE_CAMERA = dict(origin=(0.0, 1.0, 5.0), look_at=(0.0, 0.0, 0.0))
RUBIK_CAMERA = dict(origin=(0.0, 20.0, 20.0), look_at=(0.0, 1.0, -1.0))
CONFIG11_CAMERA = dict(origin=(0.0, 3.0, 2.5), look_at=(0.0, 0.6, 0.0))
# config9's procedural diffuse map (texels a side) and its mip levels.
CONFIG9_MAP, CONFIG9_MIPS = 512, 6
# The longest a multi-card scaling world may run, spawn to join (s).
SHARD_WORLD_TIMEOUT = 600.0


def emit(**kw):
    print(json.dumps(kw), flush=True)


def _full(dev: torch.device) -> bool:
    """JAX's TPU sizes on the card, its small sizes on the CPU or under
    ``SRT_SUITE_SMALL``."""
    return dev.type == "cuda" and not os.environ.get("SRT_SUITE_SMALL")


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn, *args, reps=5):
    """One warm call, then the mean wall seconds of ``reps`` calls (host
    clock, synchronized before and after); returns (last output, s)."""
    out = fn(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(dev)
    return out, (time.perf_counter() - t0) / reps


def _check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _grads(fn, leaves, *args):
    """Gradients of the scalar ``fn(leaves, *args)`` with respect to fresh
    leaf copies of ``leaves``."""
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    return torch.autograd.grad(fn(leaves, *args), leaves)


def _headline_scene(dev, rows, cols):
    mesh_data = procgen.uv_sphere(rows, cols, radius=2.0)
    return mesh.upload(flatten_models([mesh_data], pad_to=128), dev), \
        mesh_data


def _rubik_scene(dev):
    mesh_data = procgen.rubik_grid()
    return mesh.upload(flatten_models([mesh_data], pad_to=128), dev), \
        mesh_data


def mesh_loss(scene, lights, cam, cfg, method="walk", ray_tile=0):
    """config6's loss: the image mean of ``render(mesh_hit_fn(
    with_positions(scene with mat_diffuse, positions)))``, as
    ``image(params, key) -> [H, W, 3]`` and ``loss(params, key)`` with
    ``params = (mat_diffuse, positions)``."""

    def image(params, key):
        diffuse, positions = params
        s = mesh.with_positions(
            dataclasses.replace(scene, mat_diffuse=diffuse), positions)
        return pathtracer.render(
            mesh.mesh_hit_fn(s, method=method, ray_tile=ray_tile), lights,
            cam, cfg, key)

    return image, lambda params, key: image(params, key).mean()


def config1_oracle_parity(dev):
    size = 256 if _full(dev) else 64
    cam = CameraConfig(width=size, height=size)
    cfg = RenderConfig(max_depth=2, rr_bounces=0)
    spheres = default_sphere_scene(dev)
    lights = sphere_scene_lights(dev)
    n = cam.width * cam.height
    n_slots = rng.total_slots(lights.count, 2)
    uniforms = rng.host_uniforms(1, n, n_slots)

    img = pathtracer.trace_with_uniforms(
        pathtracer.spheres_hit_fn(spheres), lights, cam, cfg,
        torch.from_numpy(uniforms).to(dev)).cpu().numpy()
    m = spheres.materials
    sc = reference_cpu.OracleScene(*(x.cpu().numpy() for x in (
        spheres.center, spheres.radius, m.albedo, m.specular, m.roughness,
        m.metalness, m.use_spec, lights.position, lights.color,
        lights.intensity)))
    ref = reference_cpu.render_image(sc, cam.width, cam.height, cam.origin,
                                     cam.look_at, uniforms, max_depth=2,
                                     rr_bounces=0)
    err = float(np.max(np.abs(img - ref)))
    emit(metric=f"config1 spheres {size}x{size} fwd max|err| vs CPU oracle",
         value=err, unit="radiance", vs_baseline=float(err < 2e-3))


def config2_spheres_diff(dev):
    full = _full(dev)
    size = 512 if full else 128
    spp = 16 if full else 2
    cam = CameraConfig(width=size, height=size)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=spp)
    spheres = default_sphere_scene(dev)
    lights = sphere_scene_lights(dev)
    key = rng.key(0, dev)

    def fwd(s, k):
        return pathtracer.render_spheres(s, lights, cam, cfg, k)

    _, dt = _timed(dev, fwd, spheres, key)
    rays = size * size * spp * cfg.max_depth * 2
    emit(metric=f"config2 spheres {size}x{size} {spp}spp fwd", value=round(
        rays / dt / 1e6, 2), unit="Mrays/s upper bound", vs_baseline=None)

    def loss(leaves, k):
        mats = dataclasses.replace(spheres.materials, albedo=leaves[0])
        return fwd(dataclasses.replace(spheres, materials=mats), k).mean()

    g, dtg = _timed(dev, _grads, loss, [spheres.materials.albedo], key,
                    reps=3)
    finite = bool(torch.isfinite(g[0]).all())
    emit(metric="config2 material-grad bwd wall", value=round(dtg, 4),
         unit="s", vs_baseline=float(finite))


def config3_rubik_fwd_bwd(dev):
    scene, mesh_data = _rubik_scene(dev)
    size = 512 if _full(dev) else 128
    cam = CameraConfig(width=size, height=size, **RUBIK_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    lights = model_scene_lights(dev)
    key = rng.key(0, dev)

    def fwd(s, k):
        return pathtracer.render(mesh.mesh_hit_fn(s, method="walk",
                                                  ray_tile=8192),
                                 lights, cam, cfg, k)

    _, dt = _timed(dev, fwd, scene, key)
    emit(metric=f"config3 Rubik {mesh_data.num_triangles}tri {size}x{size} "
                f"fwd (walk)", value=round(dt, 4), unit="s/frame",
         vs_baseline=None)

    def loss(leaves, k):
        return fwd(dataclasses.replace(scene, mat_diffuse=leaves[0]),
                   k).mean()

    g, dtg = _timed(dev, _grads, loss, [scene.mat_diffuse], key, reps=3)
    emit(metric="config3 Rubik material-grad bwd wall", value=round(dtg, 4),
         unit="s", vs_baseline=float(bool(torch.isfinite(g[0]).all())))


def config4_highpoly(dev):
    """The headline scene through the public API only: make_render_plan
    picks the walk schedule, the compacted wavefront and toggles
    itself."""
    from srt_tpu_torch.models.fastpath import make_render_plan

    full = _full(dev)
    scene, mesh_data = _headline_scene(dev, *((160, 320) if full
                                              else (40, 60)))
    size = 1024 if full else 128
    cam = CameraConfig(width=size, height=size, **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    plan = make_render_plan(scene, model_scene_lights(dev), cam, cfg)

    (color, stats, overflow), dt = _timed(dev, plan.render, rng.key(0, dev),
                                          reps=3)
    _check(int(overflow) == 0, "compact schedule overflowed")
    rays = int(stats.sum())
    emit(metric=f"config4 {mesh_data.num_triangles}tri {size}x{size} fwd "
                f"(library fastpath)", value=round(rays / dt / 1e6, 2),
         unit="Mrays/s", vs_baseline=round(rays / dt / 1e6 / 100.0, 3))


def config5_case(dev, size):
    """config5: the default sphere scene, size x size, spp 2, 3 bounces:
    (hit fn maker, scene, lights, cam, cfg) for ``render_sharded``."""
    return (pathtracer.spheres_hit_fn, default_sphere_scene(dev),
            sphere_scene_lights(dev), CameraConfig(width=size, height=size),
            RenderConfig(max_depth=3, rr_bounces=0, spp=2))


def config7_case(dev, size):
    """config7: ``uv_sphere(24, 36)``, ``pad_to=1``, the dense sweep,
    (0, 1, 5) toward the origin, size x size, spp 2, 2 + 1 bounces: (hit
    fn maker, scene, lights, cam, cfg) for ``render_sharded``."""
    scene = mesh.upload(flatten_models([procgen.uv_sphere(24, 36)],
                                       pad_to=1), dev)
    return ((lambda s: mesh.mesh_hit_fn(s, method="dense")), scene,
            model_scene_lights(dev),
            CameraConfig(width=size, height=size, **HEADLINE_CAMERA),
            RenderConfig(max_depth=2, rr_bounces=1, spp=2))


def _paths_per_s(dev, case, dmesh):
    """Paths a second of ``render_sharded`` of ``case`` over ``dmesh``
    (``_timed``'s mean of 5 after a warm call)."""
    from srt_tpu_torch.parallel import render_sharded
    make_hit, scene, lights, cam, cfg = case
    _, dt = _timed(dev, lambda k: render_sharded(make_hit, scene, lights,
                                                 cam, cfg, k, dmesh),
                   rng.key(0, dev))
    return cam.width * cam.height * cfg.spp / dt


def _shard_rank(rank, world, make_case, size, device=None):
    """One rank of a scaling world: ``make_case``'s case on this rank's
    device (None: its own card), rendered over all ``world`` ranks;
    returns its paths a second."""
    from srt_tpu_torch.parallel import device_mesh
    from srt_tpu_torch.parallel.mesh import rank_device
    dev = rank_device(device)
    return _paths_per_s(dev, make_case(dev, size),
                        device_mesh(world, 1, device=device))


def _scaling(dev, make_case, size):
    """Paths a second at 1, 2, 4 and 8 shards, up to the cards present
    (one on the CPU): one shard in this process (a world of 1), more as
    one NCCL rank a card (``spawn_world``).  Returns {shards: paths/s}."""
    import torch.distributed as dist

    from srt_tpu_torch.parallel import device_mesh
    from srt_tpu_torch.parallel.launch import spawn_world
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    results = {}
    for s in (1, 2, 4, 8):
        if s > n_dev:
            break
        if s == 1:
            created = not dist.is_initialized()
            dmesh = device_mesh(1, 1, device=None if dev.type == "cuda"
                                else dev)
            try:
                results[s] = _paths_per_s(dev, make_case(dev, size), dmesh)
            finally:
                if created:
                    dist.destroy_process_group()
        else:
            with tempfile.TemporaryDirectory() as tmp:
                results[s] = spawn_world(_shard_rank, s, (make_case, size),
                                         workdir=tmp,
                                         timeout=SHARD_WORLD_TIMEOUT)[0]
    return results


def _emit_scaling(label, dev, results):
    base = results[1]
    for s, rate in results.items():
        emit(metric=f"{label} {s} shards ({dev.type})",
             value=round(rate / 1e6, 3), unit="Mpaths/s",
             vs_baseline=round(rate / (base * s), 3))


def config5_scaling(dev):
    _emit_scaling("config5 scaling", dev, _scaling(
        dev, config5_case, 256 if _full(dev) else 128))


def config6_mesh_bwd(dev):
    """Backward pass on the high-poly walk scene: the gradient of an image
    loss with respect to materials and shared vertex positions."""
    full = _full(dev)
    scene, mesh_data = _headline_scene(dev, *((160, 320) if full
                                              else (12, 18)))
    size = 256 if full else 32
    cam = CameraConfig(width=size, height=size, **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=2, rr_bounces=0, spp=1, sort_bounces=True)
    _, loss = mesh_loss(scene, model_scene_lights(dev), cam, cfg)
    params = (scene.mat_diffuse, scene.positions)
    key = rng.key(0, dev)

    with torch.no_grad():
        _, dtf = _timed(dev, loss, params, key, reps=3)
    g, dtg = _timed(dev, _grads, loss, params, key, reps=3)
    finite = all(bool(torch.isfinite(x).all()) for x in g)
    nonzero = float(sum(float(x.abs().sum()) for x in g))
    emit(metric=f"config6 {mesh_data.num_triangles}tri {size}x{size} "
                f"mat+vertex-grad bwd wall (walk)",
         value=round(dtg, 4), unit="s",
         vs_baseline=float(finite and nonzero > 0.0))
    emit(metric="config6 bwd/fwd wall ratio (walk)",
         value=round(dtg / max(dtf, 1e-9), 2), unit="x",
         vs_baseline=float(finite))


def config7_mesh_scaling(dev):
    _emit_scaling("config7 mesh scaling", dev, _scaling(
        dev, config7_case, 128 if _full(dev) else 64))


def _random_rays(n, seed, spread=4.0, target=(0, 0, 0)):
    """[3, n] origins and directions from numpy's ``default_rng(seed)``
    (``tests/test_mesh.py``'s ``random_rays``)."""
    gen = np.random.default_rng(seed)
    origins = gen.uniform(-spread, spread, (n, 3)).astype(np.float32)
    origins += np.sign(origins) * 2.0  # keep origins outside the model
    dirs = np.asarray(target, np.float32)[None] - origins
    dirs += gen.normal(0, 0.3, (n, 3)).astype(np.float32)
    return (torch.from_numpy(origins.T.copy()),
            torch.from_numpy(dirs.T.copy()))


def config8_streamed_large_scene(dev):
    """A scene above the stream threshold: ~500k triangles take the
    streamed walks (B2s, B4s).  The card: forward Mrays/s; the CPU: a
    small smoke with streaming forced on, so the path stays covered."""
    full = _full(dev)
    rows, cols, size = (360, 700, 512) if full else (12, 18, 32)
    scene, mesh_data = _headline_scene(dev, rows, cols)
    if not full:
        o, d = (x.to(dev) for x in _random_rays(512, seed=5))
        t_max = torch.full((512,), float("inf"), device=dev)
        _, idx, _, _ = traversal.model_hit(scene, 0, o, d, t_max,
                                           stream=True)
        td, _, _, _ = mesh._dense_model_hit(scene, 0, o, d, t_max)
        agree = float(((idx != -1) == torch.isfinite(td)).float().mean())
        emit(metric=f"config8 streamed {mesh_data.num_triangles}tri "
                    f"hit agreement vs dense (smoke, stream forced)",
             value=agree, unit="fraction", vs_baseline=float(agree > 0.995))
        return
    from srt_tpu_torch.models.fastpath import make_render_plan
    _check(scene.woop.shape[0] > traversal.STREAM_THRESHOLD_CLUSTERS,
           "scene must exceed the stream threshold")
    cam = CameraConfig(width=size, height=size, **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=2, rr_bounces=0, spp=1)
    plan = make_render_plan(scene, model_scene_lights(dev), cam, cfg)

    (color, stats, overflow), dt = _timed(dev, plan.render, rng.key(0, dev),
                                          reps=3)
    _check(int(overflow) == 0, "compact schedule overflowed")
    rays = int(stats.sum())
    finite = bool(torch.isfinite(color).all())
    emit(metric=f"config8 streamed {mesh_data.num_triangles}tri "
                f"{size}x{size} fwd (HBM-streamed Woop, library fastpath)",
         value=round(rays / dt / 1e6, 2), unit="Mrays/s",
         vs_baseline=float(finite))


def config9_map():
    """config9's procedural diffuse map: a checker of 16 squares a side
    times two gradients, ``CONFIG9_MAP`` texels square."""
    yy, xx = np.mgrid[0:CONFIG9_MAP, 0:CONFIG9_MAP].astype(
        np.float32) / CONFIG9_MAP
    checker = (np.floor(xx * 16) + np.floor(yy * 16)) % 2
    return np.stack([0.2 + 0.6 * checker, 0.3 + 0.5 * yy, 0.8 - 0.5 * xx],
                    axis=-1).astype(np.float32)


def config9_scene(flat, dev, quad_pack=True):
    """config9's textured upload of ``flat``: the map's mip atlas
    (``CONFIG9_MIPS`` levels), ``mip_lod_scale`` = 512 / (2 pi 2) texels
    per world unit, every material textured with texture 0 (set after the
    upload)."""
    from srt_tpu_torch.utils.atlas import pack_atlas
    at = pack_atlas([config9_map()], mip_levels=CONFIG9_MIPS)
    s = mesh.upload(flat, dev, atlas=at.image, atlas_rects=at.rects,
                    atlas_mip_rects=at.mip_rects,
                    mip_lod_scale=512.0 / (2.0 * np.pi * 2.0),
                    quad_pack=quad_pack)
    return dataclasses.replace(
        s, mat_use_texture=torch.ones_like(s.mat_use_texture),
        mat_tex_index=torch.zeros_like(s.mat_tex_index))


def config9_run(scene, lights, size):
    """config9's frame: primaries from the stream's first two slots, then
    ``trace_wavefront`` through ``mesh_hit_fn(scene, method="walk",
    ray_tile=4096)``, 4 bounces, bounce re-sort, ray cones.  Returns
    (``run(key) -> (radiance [3, N], stats [4, 2])``, the hit fn)."""
    cam = CameraConfig(width=size, height=size, **HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1, sort_bounces=True,
                       ray_cones=True)
    hit = mesh.mesh_hit_fn(scene, method="walk", ray_tile=4096)
    n = size * size

    def run(key):
        stream = rng.KeyStream(key, n)
        vp = derive_viewport(cam, device=key.device)
        o, d = generate_rays(vp, size, size, stream.take(2))
        return pathtracer.trace_wavefront(hit, lights, o, d, stream, cfg,
                                          return_stats=True)

    return run, hit


def config9_textured_headline(dev):
    """Texture fetch in the measured path: the headline scene with a
    procedural diffuse map through the mip atlas and ray-cone LOD.
    Reports textured Mrays/s; vs_baseline is the textured / untextured
    throughput ratio."""
    full = _full(dev)
    mesh_data = procgen.uv_sphere(*((160, 320) if full else (40, 60)),
                                  radius=2.0)
    flat = flatten_models([mesh_data], pad_to=128)
    size = 1024 if full else 128
    lights = model_scene_lights(dev)
    key = rng.key(0, dev)
    run_tex, _ = config9_run(config9_scene(flat, dev), lights, size)
    run_plain, _ = config9_run(mesh.upload(flat, dev), lights, size)

    (color_t, stats), dt_tex = _timed(dev, run_tex, key, reps=3)
    _, dt_plain = _timed(dev, run_plain, key, reps=3)
    rays = int(stats.sum())
    finite = bool(torch.isfinite(color_t).all())
    mrays = rays / dt_tex / 1e6
    emit(metric=f"config9 textured {mesh_data.num_triangles}tri "
                f"{size}x{size} fwd (walk, mip atlas + ray cones; "
                f"finite={finite})",
         value=round(mrays, 2), unit="Mrays/s",
         vs_baseline=round(dt_plain / dt_tex, 3))


def _timed_run(render_fn, params0, target, key, lr, steps):
    """Steady-state s/step of ``run_inverse_rendering`` (fixed noise):
    per-step wall times from the callback (each step reads its loss back,
    so the card has finished it), step 0 dropped."""
    from srt_tpu_torch.optim import run_inverse_rendering
    stamps = [time.perf_counter()]
    res = run_inverse_rendering(
        render_fn, params0, target, key, steps=steps, learning_rate=lr,
        fixed_noise=True, log_every=0,
        callback=lambda i, p, loss: stamps.append(time.perf_counter()))
    ok = bool(np.isfinite(res.losses).all()
              and min(res.losses) <= res.losses[0])
    return ok, float(np.diff(stamps)[1:].mean())


def config10_inverse_rendering(dev):
    """Inverse-rendering step time: (a) Rubik-scale vertex recovery
    through the edge-aware mesh renderer (ring search); (b) headline
    vertex + material recovery through the path-space walk."""
    from srt_tpu_torch.models.edge_aware_mesh import render_edge_aware_mesh

    full = _full(dev)
    lights = model_scene_lights(dev)
    steps = 6 if full else 3

    # (a) edge-aware vertex recovery, Rubik scale.
    scene, _ = _rubik_scene(dev)
    size = 256 if full else 32
    cam = CameraConfig(width=size, height=size, **RUBIK_CAMERA)
    cfg = RenderConfig(max_depth=2, rr_bounces=0, morton_order=False)

    def render_ea(positions, key):
        return render_edge_aware_mesh(mesh.with_positions(scene, positions),
                                      lights, cam, cfg, key, method="walk",
                                      search="ring", rings=1)

    key7 = rng.key(7, dev)
    with torch.no_grad():
        target = render_ea(scene.positions, key7)
    ok, dt = _timed_run(render_ea, scene.positions * 1.002, target, key7,
                        2e-3, steps)
    emit(metric=f"config10a inverse-render edge-aware Rubik "
                f"{size}x{size} (walk, ring search)",
         value=round(dt, 3), unit="s/step", vs_baseline=float(ok))

    # (b) path-space vertex + material recovery, the headline mesh; the
    # walk needs its tables, so pad_to=128 on every device.
    hi_scene, _ = _headline_scene(dev, *((160, 320) if full else (12, 18)))
    size_b = 256 if full else 32
    cam_b = CameraConfig(width=size_b, height=size_b, **HEADLINE_CAMERA)
    cfg_b = RenderConfig(max_depth=2, rr_bounces=0, sort_bounces=True)
    render_ps, _ = mesh_loss(hi_scene, lights, cam_b, cfg_b)
    key3 = rng.key(3, dev)
    params0 = (hi_scene.mat_diffuse * 0.9, hi_scene.positions * 1.001)
    with torch.no_grad():
        target_b = render_ps((hi_scene.mat_diffuse, hi_scene.positions),
                             key3)
    ok_b, dt_b = _timed_run(render_ps, params0, target_b, key3, 1e-3, steps)
    emit(metric=f"config10b inverse-render path-space "
                f"{hi_scene.num_triangles}tri {size_b}x{size_b} "
                f"mat+vertex (walk)",
         value=round(dt_b, 3), unit="s/step", vs_baseline=float(ok_b))


def config11_scene(dev):
    """config11's scene on ``dev``: the lamp cube (size 0.3, Ke (40, 32,
    24)) beside and above the receiver cube, flattened with ``pad_to=128``
    (one supercluster), and its one dim point light."""
    from srt_tpu_torch.utils.obj_loader import MaterialDef
    lamp = procgen.cube(size=0.3, center=(0.9, 1.8, 0.6),
                        material=MaterialDef(diffuse=(0.0, 0.0, 0.0),
                                             specular=(0.0, 0.0, 0.0),
                                             emissive=(40.0, 32.0, 24.0)))
    recv = procgen.cube(size=2.2, center=(0.0, -0.4, 0.0),
                        material=MaterialDef(diffuse=(0.7, 0.7, 0.7),
                                             specular=(0.2, 0.2, 0.2)))
    scene = mesh.upload(flatten_models([recv, lamp], pad_to=128), dev)
    dim = Lights(position=torch.tensor([[0.0, 500.0, 0.0]], device=dev),
                 color=torch.tensor([[1.0, 1.0, 1.0]], device=dev),
                 intensity=torch.tensor([1e-6], device=dev))
    return scene, dim


def config11_frame(hit, dim, em, size, nee):
    """config11's frame through ``hit``: ``trace_image_compact`` at the
    full-width schedule (n, n, n), 3 bounces, bounce re-sort, the
    all-specular shortcut, NEE toward ``em`` when ``nee``; ``frame(key)
    -> (image, stats, overflow)``."""
    from srt_tpu_torch.models.wavefront_compact import trace_image_compact
    cam = CameraConfig(width=size, height=size, **CONFIG11_CAMERA)
    cfg = RenderConfig(max_depth=3, rr_bounces=0, nee=nee, sort_bounces=True,
                       uniform_use_spec=True)
    n = size * size
    return lambda key: trace_image_compact(
        hit, dim, cam, cfg, rng.KeyStream(key, n), (n, n, n),
        return_stats=True, emitters=em if nee else None)


def config11_nee_emitters(dev):
    """Next-event estimation toward Ke emitters: the NEE frame's time
    against the hit-only frame's on the same scene, integrator and hit
    fn (``make_render_plan`` would mix integrators), and the noise drop:
    relative luminance std over K frames on the emitter-lit pixels."""
    from srt_tpu_torch.models.emitters import scene_emitters

    full = _full(dev)
    size = 512 if full else 64
    k_frames = 16 if full else 4
    scene, dim = config11_scene(dev)
    keys = rng.split(rng.key(11, dev), k_frames)
    hit = mesh.mesh_hit_fn(scene, method="walk")
    em = scene_emitters(scene)
    out = {}
    for nee in (False, True):
        f = config11_frame(hit, dim, em, size, nee)
        f(keys[0])
        _sync(dev)
        frames = []
        t0 = time.perf_counter()
        for k in keys:
            img, _, ovf = f(k)
            _check(int(ovf) == 0, "compact schedule overflowed")
            frames.append(img.cpu().numpy())
        dt = (time.perf_counter() - t0) / k_frames
        out[nee] = (dt, np.stack(frames))

    lum = out[False][1].sum(-1)
    lit = lum.mean(0) > np.percentile(lum.mean(0), 80)
    rel_std = {nee: float(out[nee][1].sum(-1).std(0)[lit].mean()
                          / max(out[nee][1].sum(-1).mean(), 1e-9))
               for nee in (False, True)}
    _check(bool(np.isfinite(out[True][1]).all()), "non-finite NEE frame")
    emit(metric=f"config11 NEE emissive {size}x{size} frame wall "
                f"(nee on vs off)",
         value=round(out[True][0] * 1e3, 1), unit="ms",
         vs_baseline=round(out[True][0] / max(out[False][0], 1e-9), 3))
    emit(metric="config11 NEE emitter-lit relative std (lower=better)",
         value=round(rel_std[True], 4), unit="rel std",
         vs_baseline=round(rel_std[True] / max(rel_std[False], 1e-9), 3))


ALL = {
    "1": config1_oracle_parity,
    "2": config2_spheres_diff,
    "3": config3_rubik_fwd_bwd,
    "4": config4_highpoly,
    "5": config5_scaling,
    "6": config6_mesh_bwd,
    "7": config7_mesh_scaling,
    "8": config8_streamed_large_scene,
    "9": config9_textured_headline,
    "10": config10_inverse_rendering,
    "11": config11_nee_emitters,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", help="config numbers (default: "
                                               "all)")
    ap.add_argument("--device", help="default: the card")
    args = ap.parse_args(argv)
    try:
        dev = resolve(args.device)
    except RuntimeError as e:
        print(f"bench_suite: {e}", file=sys.stderr)
        return 2
    picks = args.configs or sorted(ALL)
    failed = []
    for p in picks:
        try:
            ALL[p](dev)
        except Exception as e:  # keep the suite going; report the failure
            traceback.print_exc()
            emit(metric=f"config{p} FAILED", value=0.0, unit=str(e)[:200],
                 vs_baseline=0.0)
            failed.append(p)
    if failed:
        # A regression in any config must not look like a green suite.
        print(f"bench_suite: {len(failed)} config(s) FAILED: "
              f"{', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
