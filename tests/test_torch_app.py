"""PyTorch port vs JAX package: the app layer.

Tonemapping, image files, the ``FPSCamera``, ``trace_image_compact`` at a
moved pose, render-state validation, the profiling helpers and
``RenderSession`` (``srt_tpu_torch/app.py`` against ``srt_tpu/app.py``),
on the same inputs in both packages, on the CPU.

Tolerances.  The accumulation buffer of ``tonemap.accumulate`` is held
bit for bit and its display at atol 1e-6 (``jnp.power`` and
``torch.pow`` may differ by an ulp).  Sessions on the sphere scene run
the scan integrator in both packages, JAX's under ``jax.disable_jit()``
(compiled, XLA contracts multiply-adds; ``tests/test_torch_spheres.py``):
their accumulation buffers agree within rtol 1e-4 / atol 1e-5.  Mesh
sessions differ in configuration on the CPU: JAX's takes the dense sweep
without the bounce sort (``srt_tpu/app.py:89``, ``:104``), the port's the
walk with the sort, so they are held to the repo's parity gate: >= 99.5%
of pixels within rtol 1e-4 / atol 1e-5 (an ulp can flip a lobe or
roulette choice), and equal width schedules; JAX's mesh frames run
compiled, as its session ships them (the gate covers contracted
multiply-adds).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu import app as jax_app
from srt_tpu import camera as jax_camera
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.models import wavefront_compact as jax_wc
from srt_tpu.ops import tonemap as jax_tonemap
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu.scene import default_sphere_scene as jax_spheres
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.scene import sphere_scene_lights as jax_sphere_lights
from srt_tpu.utils import image as jax_image
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils import profiling as jax_profiling
from srt_tpu.utils import validate as jax_validate
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch import app
from srt_tpu_torch.camera import FPSCamera
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import fastpath, mesh, pathtracer
from srt_tpu_torch.models import wavefront_compact as wc
from srt_tpu_torch.ops import rng, tonemap
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from srt_tpu_torch.scene import (default_sphere_scene, lights_from_arrays,
                                 sphere_scene_lights)
from srt_tpu_torch.utils import image, profiling, validate
from tests.test_torch_spheres import assert_images_match
from tests.test_torch_traversal import port_scene_of

torch.set_num_threads(2)


def seeded(shape, seed, nan_every=0):
    """Float32 radiance-like values in [-0.1, 4) from a numpy seed, every
    ``nan_every``-th value NaN."""
    x = np.random.default_rng(seed).uniform(-0.1, 4.0, shape)
    x = x.astype(np.float32).reshape(-1)
    if nan_every:
        x[::nan_every] = np.nan
    return x.reshape(shape)


def test_tonemap_matches_jax():
    """Three accumulation steps of seeded frames with NaN texels (flagged
    green), then ``resolve``: buffers bit for bit, displays at atol 1e-6."""
    acc_j = jnp.zeros((6, 5, 3), jnp.float32)
    acc_p = torch.zeros((6, 5, 3))
    for k in range(3):
        frame = seeded((6, 5, 3), k, nan_every=7 + k)
        acc_j, disp_j = jax_tonemap.accumulate(acc_j, jnp.asarray(frame),
                                               jnp.int32(k))
        acc_p, disp_p = tonemap.accumulate(acc_p, torch.tensor(frame), k)
        assert np.array_equal(acc_p.numpy(), np.asarray(acc_j))
        np.testing.assert_allclose(disp_p.numpy(), np.asarray(disp_j),
                                   rtol=0, atol=1e-6)
    flagged = tonemap.flag_nans(torch.tensor(seeded((6, 5, 3), 0, 7)))
    assert torch.equal(flagged.reshape(-1, 3)[0], torch.tensor([0.0, 1, 0]))
    for frames in (0, 1, 3):
        np.testing.assert_allclose(
            tonemap.resolve(acc_p, frames).numpy(),
            np.asarray(jax_tonemap.resolve(acc_j, frames)), rtol=0,
            atol=1e-6)
    x = seeded((1000,), 9) * 0.01
    np.testing.assert_allclose(
        tonemap.linear_to_srgb(torch.tensor(x)).numpy(),
        np.asarray(jax_tonemap.linear_to_srgb(jnp.asarray(x))), rtol=0,
        atol=1e-6)


def test_image_files_match_jax(tmp_path):
    """``write_ppm`` writes JAX's bytes (from a tensor too), ``read_ppm``
    reads them back; ``write_png`` answers as JAX's does (False without
    PIL)."""
    img = np.clip(seeded((7, 9, 3), 3) / 4.0, 0.0, 1.0)
    assert np.array_equal(image.to_uint8(torch.tensor(img)),
                          jax_image.to_uint8(img))
    for flip in (True, False):
        ours, ref = tmp_path / f"p{flip}.ppm", tmp_path / f"j{flip}.ppm"
        image.write_ppm(str(ours), torch.tensor(img), flip_vertical=flip)
        jax_image.write_ppm(str(ref), img, flip_vertical=flip)
        assert ours.read_bytes() == ref.read_bytes()
        assert np.array_equal(image.read_ppm(str(ours)),
                              jax_image.read_ppm(str(ref)))
    assert image.write_png(str(tmp_path / "p.png"), img) == \
        jax_image.write_png(str(tmp_path / "j.png"), img)


def test_fps_camera_matches_jax():
    """The same verbs on both packages' cameras give equal poses, bases
    and configs (the same float64 ``math``)."""
    ours, ref = FPSCamera(position=(0.5, 1.0, 3.0)), \
        jax_camera.FPSCamera(position=(0.5, 1.0, 3.0))
    verbs = [("move", (0.5, 0.0, 0.0)), ("rotate", (30.0, -12.0)),
             ("move", (0.2, -0.3, 0.7)), ("rotate", (0.0, 120.0)),
             ("move", (1.0, 1.0, 1.0)), ("rotate", (-200.0, -300.0)),
             ("reset", (True,)), ("rotate", (45.0, 10.0)), ("reset", ())]
    for verb, args in verbs:
        getattr(ours, verb)(*args)
        getattr(ref, verb)(*args)
        assert (ours.position, ours.yaw, ours.pitch) == \
            (ref.position, ref.yaw, ref.pitch)
        assert ours.basis() == ref.basis()
        assert ours.look_at() == ref.look_at()
        assert -89.0 <= ours.pitch <= 89.0
    cfg = ours.config(CameraConfig(width=8, height=6))
    jcfg = ref.config(JaxCamera(width=8, height=6))
    assert (cfg.origin, cfg.look_at, cfg.width) == \
        (jcfg.origin, jcfg.look_at, jcfg.width)


def test_validate_and_heal_match_jax():
    """``tests/test_optim_app.py::test_render_state_validation_and_
    healing`` on the port, the reports equal to JAX's, and a skewed
    camera basis."""
    frame = np.full((4, 4, 3), 0.5, np.float32)
    accum = np.ones((4, 4, 3), np.float32)
    bad = accum.copy()
    bad[1, 2, 0] = np.nan
    bad[0, 0, 1] = -1.0
    for acc in (accum, bad):
        rep = validate.validate_render_state(torch.tensor(frame),
                                             torch.tensor(acc))
        ref = jax_validate.validate_render_state(jnp.asarray(frame),
                                                 jnp.asarray(acc))
        assert dataclasses.asdict(rep) == dataclasses.asdict(ref)
        assert str(rep) == str(ref)
    assert not rep.ok and rep.nonfinite_accum == 1 and rep.negative_accum == 1
    healed, n = validate.heal_accumulation(torch.tensor(bad))
    ref_healed, ref_n = jax_validate.heal_accumulation(jnp.asarray(bad))
    assert n == ref_n == 2 and isinstance(n, int)
    assert np.array_equal(healed.numpy(), np.asarray(ref_healed))
    assert healed.device.type == "cpu"

    class Skewed:
        def basis(self):
            return (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.1, 0.0, 1.0)

    rep = validate.validate_render_state(frame, accum, Skewed())
    assert not rep.ok and rep.camera_skew == pytest.approx(
        jax_validate.camera_skew((1, 0, 0), (0.1, 0, 1), (0, 1, 0)))
    assert validate.validate_render_state(frame, accum, FPSCamera()).ok


def test_profiling_helpers(tmp_path):
    """``RaysPerSecondMeter`` counts as JAX's does; ``profile_trace``
    writes a Chrome trace (and nothing without a directory)."""
    stats = np.array([[100, 40], [60, 10]], np.int32)
    ours, ref = profiling.RaysPerSecondMeter(), \
        jax_profiling.RaysPerSecondMeter()
    ours.add(torch.tensor(stats), 0.5, spp=2)
    ref.add(jnp.asarray(stats), 0.5, spp=2)
    assert (ours.rays, ours.seconds, ours.mrays_per_s) == \
        (ref.rays, ref.seconds, ref.mrays_per_s) == (420, 0.5, 420 / 0.5e6)
    assert profiling.RaysPerSecondMeter().mrays_per_s == 0.0
    with profiling.profile_trace(None):
        pass
    with profiling.profile_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# -- the sphere session (scan integrator) -----------------------------------

SPHERE_CAM = dict(width=16, height=12, origin=(0.0, 1.0, 4.0))
SPHERE_CFG = dict(max_depth=2, rr_bounces=0)


def test_render_session_accumulates_and_resets():
    """``tests/test_optim_app.py::test_render_session_accumulates_and_
    resets`` on the port, and its accumulation against JAX's after 3
    frames, then after a move and 1 frame."""
    session = app.RenderSession(
        pathtracer.spheres_hit_fn(default_sphere_scene("cpu")),
        sphere_scene_lights("cpu"), CameraConfig(**SPHERE_CAM),
        RenderConfig(**SPHERE_CFG))
    with jax.disable_jit():
        ref = jax_app.RenderSession(
            jax_pt.spheres_hit_fn(jax_spheres()), jax_sphere_lights(),
            JaxCamera(**SPHERE_CAM), JaxRenderConfig(**SPHERE_CFG))
        img1 = session.step()
        assert isinstance(img1, np.ndarray) and img1.shape == (12, 16, 3)
        assert session.frames_accumulated == 1
        session.run(2)
        ref.run(3)
        assert session.frames_accumulated == ref.frames_accumulated == 3
        np.testing.assert_allclose(session._accum.numpy(),
                                   np.asarray(ref._accum), rtol=1e-4,
                                   atol=1e-5)
        snap = session.snapshot()
        assert np.isfinite(snap).all() and 0.0 <= snap.min() <= \
            snap.max() <= 1.0
        np.testing.assert_allclose(snap, ref.snapshot(), rtol=1e-4,
                                   atol=1e-5)

        # A camera move clears the accumulation (resetAccumBuffer).
        session.move(forward=0.5)
        ref.move(forward=0.5)
        assert session.frames_accumulated == 0
        assert not session._accum.any()
        img2 = session.step()
        ref.step()
    assert img2.shape == (12, 16, 3)
    assert session.camera.position == ref.camera.position
    np.testing.assert_allclose(session._accum.numpy(), np.asarray(ref._accum),
                               rtol=1e-4, atol=1e-5)
    # The moved frame is the scan integrator's frame at the new pose,
    # from the fourth frame's key.
    want = pathtracer.trace_image_sample(
        session._closest_hit, session._lights, session.camera.config(
            CameraConfig(**SPHERE_CAM)),
        session.cfg, rng.KeyStream(rng.fold_in(rng.key(0, "cpu"), 3), 192))
    assert torch.equal(session._accum, want)

    # Reset pose ('R' key analog).
    session.reset_camera()
    assert session.camera.position == (0.0, 1.0, 4.0)
    assert session.frames_accumulated == 0


def test_session_metrics_and_validation_hook():
    """``tests/test_optim_app.py::test_session_metrics_and_validation_
    hook`` on the port; then an injected NaN texel is healed (count 1),
    and ``fetch=False`` returns the display tensor."""
    logs = []
    session = app.RenderSession(
        pathtracer.spheres_hit_fn(default_sphere_scene("cpu")),
        sphere_scene_lights("cpu"), CameraConfig(width=16, height=12),
        RenderConfig(**SPHERE_CFG), validate_every=2, log_fn=logs.append)
    session.run(4)
    assert session.metrics["frames"] == 4
    assert session.metrics["avg_frame_ms"] > 0
    assert len(logs) == 4 and logs[-1]["frame"] == 4
    assert session.metrics["last_report"] is not None
    assert session.metrics["last_report"].ok
    assert session.metrics["healed_texels"] == 0

    session._accum[3, 5, 1] = float("nan")
    disp = session.step(fetch=False)          # frame 5: not validated
    assert isinstance(disp, torch.Tensor) and disp.shape == (12, 16, 3)
    session.step()                            # frame 6: validated, healed
    assert session.metrics["healed_texels"] == 1
    assert not session.metrics["last_report"].ok
    assert bool(torch.isfinite(session._accum).all())
    assert logs[-1] == {"frame": 6, "ms": logs[-1]["ms"], "accumulated": 6,
                        "healed_texels": 1}


# -- mesh sessions -----------------------------------------------------------

MESH_CFG = dict(max_depth=2, rr_bounces=0)


@pytest.fixture(scope="module")
def big_scene():
    """uv_sphere(80, 120, radius 2): 149 clusters, 10 superclusters,
    above the session's fast-path threshold of 8."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(80, 120, 2.0)],
                                     pad_to=128))
    jl = jax_lights()
    pl = lights_from_arrays({k: np.asarray(getattr(jl, k))
                             for k in ("position", "color", "intensity")},
                            "cpu")
    ps = port_scene_of(js)
    assert mesh.n_superclusters(ps) == 10
    return js, ps, jl, pl


def sessions(big_scene, cam, seed=0):
    js, ps, jl, pl = big_scene
    ours = app.RenderSession(None, pl, CameraConfig(**cam),
                             RenderConfig(**MESH_CFG), seed=seed, scene=ps,
                             fast=True)
    ref = jax_app.RenderSession(None, jl, JaxCamera(**cam),
                                JaxRenderConfig(**MESH_CFG), seed=seed,
                                scene=js, fast=True)
    return ours, ref


def assert_accum_match(ours, ref):
    assert ours.frames_accumulated == ref.frames_accumulated
    assert_images_match(ours._accum, ref._accum)


def test_fast_session_matches_jax(big_scene):
    """The fast session (walk schedule, compact driver) on a mesh of 10
    superclusters against JAX's: the same width schedule; after 2 frames,
    and after a move and 1 frame, the parity gate; the moved frame equal
    bit for bit to a render plan built at the moved pose and rendering
    the same folded key."""
    cam = dict(width=24, height=16, origin=(0.0, 1.0, 5.0))
    ours, ref = sessions(big_scene, cam)
    assert ours._fast and ref._fast
    assert ours.schedule == ref._schedule == (384, 384)
    ours.run(2)
    ref.run(2)
    assert_accum_match(ours, ref)
    ours.move(forward=0.5, strafe=0.25)
    ref.move(forward=0.5, strafe=0.25)
    ours.step()
    ref.step()
    assert_accum_match(ours, ref)
    assert ours.schedule == ref._schedule == (384, 384)
    _, ps, _, pl = big_scene
    plan = fastpath.make_render_plan(
        ps, pl, ours.camera.config(CameraConfig(**cam)),
        RenderConfig(**MESH_CFG), key=rng.key(0, "cpu"))
    img, _, overflow = plan.render(rng.fold_in(rng.key(0, "cpu"), 2))
    assert int(overflow) == 0 and torch.equal(ours._accum, img)


def test_fast_session_overflow_retrace(big_scene, monkeypatch):
    """A session probed facing away from the sphere (all sky: the
    minimum schedule), then turned to face it: the next frame overflows,
    is traced again at full width, and the schedule stays widened, in
    both packages; the frame equals the full-width frame at that pose bit
    for bit and JAX's within the parity gate.  Schedules round to 128
    here (both packages' ``discover_schedule``, patched), so that a 24x16
    frame can overflow; the sessions' default granule is 4,096."""
    monkeypatch.setattr(app, "discover_schedule", functools.partial(
        wc.discover_schedule, min_width=128, granule=128))
    monkeypatch.setattr(jax_wc, "discover_schedule", functools.partial(
        jax_wc.discover_schedule, min_width=128, granule=128))
    cam = dict(width=24, height=16, origin=(0.0, 1.0, -5.0),
               look_at=(0.0, 1.0, -6.0))
    ours, ref = sessions(big_scene, cam, seed=3)
    assert ours.schedule == ref._schedule == (384, 128)
    ours.rotate(180.0, 0.0)
    ref.rotate(180.0, 0.0)
    calls = []
    real = app.trace_image_compact
    monkeypatch.setattr(app, "trace_image_compact",
                        lambda *a, **k: calls.append(a[5]) or real(*a, **k))
    ours.step()
    ref.step()
    assert calls == [(384, 128), (384, 384)]
    assert ours.schedule == ref._schedule == (384, 384)
    assert_accum_match(ours, ref)
    _, ps, _, pl = big_scene
    want, stats, overflow = real(
        ours._hit_fns, pl, CameraConfig(**cam), ours._fast_cfg,
        rng.KeyStream(rng.fold_in(rng.key(3, "cpu"), 0), 384), (384, 384),
        origin=ours.camera.position, look_at=ours.camera.look_at(),
        return_stats=True)
    assert int(overflow) == 0 and int(stats[1, 0]) > 128
    assert torch.equal(ours._accum, want)
    calls.clear()
    ours.step()
    assert calls == [(384, 384)]


def test_small_scene_session_takes_the_scan(monkeypatch):
    """``fast=True`` on ``rubik_grid()`` (one supercluster): both
    packages fall back to the scan integrator over the scene's own hit
    fn (JAX's dense sweep on the CPU, the port's walk) and ignore the
    ``closest_hit`` passed; accumulations within the parity gate."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.rubik_grid()], pad_to=128))
    ps = port_scene_of(js)
    jl = jax_lights()
    pl = lights_from_arrays({k: np.asarray(getattr(jl, k))
                             for k in ("position", "color", "intensity")},
                            "cpu")
    cam = dict(width=24, height=16, origin=(1.0, 2.5, 6.0))
    sentinel = object()
    ours = app.RenderSession(sentinel, pl, CameraConfig(**cam),
                             RenderConfig(**MESH_CFG), scene=ps, fast=True)
    ref = jax_app.RenderSession(sentinel, jl, JaxCamera(**cam),
                                JaxRenderConfig(**MESH_CFG), scene=js,
                                fast=True)
    assert not ours._fast and not ref._fast and ours.schedule is None
    for s in (ours, ref):
        s.rotate(-10.0, -20.0)
        s.run(2)
    assert_accum_match(ours, ref)
    assert float(ours._accum.std()) > 0.01


def test_trace_image_compact_at_a_moved_pose():
    """``trace_image_compact(origin=, look_at=)`` against JAX's on the
    dense sweep of ``uv_sphere(12, 18)`` from one injected uniform array,
    at a pose other than the camera config's: equal stats and overflow
    (a schedule that slices after the first bounce), the parity gate, and
    the override equal to a config at that pose."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(12, 18)],
                                     pad_to=128))
    ps = port_scene_of(js)
    jl = jax_lights()
    pl = lights_from_arrays({k: np.asarray(getattr(jl, k))
                             for k in ("position", "color", "intensity")},
                            "cpu")
    cam = dict(width=20, height=16)
    pose = dict(origin=(0.4, 1.2, 3.0), look_at=(0.1, -0.2, 0.0))
    kw = dict(max_depth=3, rr_bounces=0)
    n = 320
    sched = (n, 192, 128)
    u = host_uniforms(5, n, total_slots(pl.count, 3))
    j_img, j_st, j_ov = jax.jit(lambda u: jax_wc.trace_image_compact(
        jax_mesh.mesh_hit_fn(js, method="dense"), jl, JaxCamera(**cam),
        JaxRenderConfig(**kw), JaxArrayStream(u), sched,
        return_stats=True, **pose))(jnp.asarray(u))
    hit = mesh.mesh_hit_fn(ps, method="dense")
    p_img, p_st, p_ov = wc.trace_image_compact(
        hit, pl, CameraConfig(**cam), RenderConfig(**kw),
        ArrayStream(torch.tensor(u)), sched, return_stats=True, **pose)
    assert int(p_ov) == int(j_ov) == 0
    assert np.array_equal(p_st.numpy(), np.asarray(j_st))
    assert int(p_st[0, 1]) > 0 and float(p_img.mean()) > 0.01
    assert_images_match(p_img, j_img)
    # The positional order is JAX's: schedule, origin, look_at.
    at_config = wc.trace_image_compact(
        hit, pl, CameraConfig(**cam, **pose), RenderConfig(**kw),
        ArrayStream(torch.tensor(u)), sched)
    positional = wc.trace_image_compact(
        hit, pl, CameraConfig(**cam), RenderConfig(**kw),
        ArrayStream(torch.tensor(u)), sched, pose["origin"],
        pose["look_at"])
    assert torch.equal(at_config, p_img) and torch.equal(positional, p_img)
    assert not math.isclose(float(p_img.mean()), float(
        wc.trace_image_compact(hit, pl, CameraConfig(**cam),
                               RenderConfig(**kw),
                               ArrayStream(torch.tensor(u)), sched).mean()))
