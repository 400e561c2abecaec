"""PyTorch port vs JAX package: one bounce, the whole compacted render
slice, and the port's own render plan on the CPU.

Both packages get the same scene tables (converted from JAX), the same
camera and the same injected uniforms (numpy seed, ``ArrayStream``); the
Pallas kernels run in interpret mode with an exact reciprocal
(``tests/test_torch_traversal.py``, fixture ``exact_reciprocal``)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import fastpath as jax_fastpath
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.models.wavefront_compact import \
    trace_image_compact as jax_trace_image_compact
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import fastpath, mesh, pathtracer
from srt_tpu_torch.models.wavefront_compact import trace_image_compact
from srt_tpu_torch.ops import rng, traversal
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from srt_tpu_torch.scene import lights_from_arrays
from tests.test_torch_traversal import exact_reciprocal  # noqa: F401
from tests.test_torch_traversal import port_scene_of

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = dict(width=32, height=32, origin=(0.0, 1.0, 5.0),
           look_at=(0.0, 0.0, 0.0))
WALKS = "tiled@128,pg2:32:4,pg2:16:4"
WALKS_SHADOW = "pg2:32:4,pg2:16:4"


@pytest.fixture(scope="module")
def setup(exact_reciprocal):
    """uv_sphere(40, 60) (3 superclusters) over a ground cube (a second
    model of one cluster): bounces hit the ground, the sphere shadows it."""
    js = jax_mesh.upload(jax_flatten(
        [jax_procgen.uv_sphere(40, 60),
         jax_procgen.cube(size=8.0, center=(0.0, -5.0, 0.0))], pad_to=128))
    jl = jax_lights()
    pl = lights_from_arrays({k: np.asarray(getattr(jl, k))
                             for k in ("position", "color", "intensity")},
                            "cpu")
    return js, port_scene_of(js), jl, pl


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("bounce,max_depth", [(0, 3), (2, 3), (1, 1)],
                         ids=["primary", "sorted-shadows", "roulette"])
def test_bounce_step_matches_jax(setup, bounce, max_depth):
    """One bounce on identical carries and uniforms: primary rays of a
    32x32 camera; bounce 2 takes the sorted shadow batch and the 6-D sort
    key, max_depth 1 puts bounce 1 under Russian roulette."""
    js, ps, jl, pl = setup
    n = CAM["width"] * CAM["height"]
    rng = np.random.default_rng(4)
    jitter = rng.uniform(size=(2, n)).astype(np.float32)
    from srt_tpu.camera import derive_viewport, generate_rays
    o, d = generate_rays(derive_viewport(JaxCamera(**CAM)), 32, 32,
                         jnp.asarray(jitter))
    u = rng.uniform(size=(2 * 6 + 6, n)).astype(np.float32)
    kw = dict(max_depth=max_depth, rr_bounces=2, sort_shadows_from=1)
    j_hit = jax_mesh.mesh_hit_fn(js, method="pallas", kernel_tile=128,
                                 binned_anyhit="pg2:32:4")
    j_carry, j_st = jax_pt.bounce_step(
        j_hit, jl, JaxRenderConfig(**kw), (
            o, d, jnp.ones((3, n)), jnp.zeros((3, n)), jnp.ones(n, bool),
            jnp.arange(n, dtype=jnp.int32)), bounce, jnp.asarray(u),
        sort=True)
    p_hit = mesh.mesh_hit_fn(ps, method="walk", kernel_tile=128,
                             binned_anyhit="pg2:32:4")
    p_carry, p_st = pathtracer.bounce_step(
        p_hit, pl, RenderConfig(**kw), (
            t(o), t(d), torch.ones((3, n)), torch.zeros((3, n)),
            torch.ones(n, dtype=torch.bool), torch.arange(n)), bounce,
        t(u), sort=True)
    np.testing.assert_array_equal(p_st.numpy(), np.asarray(j_st))
    assert int(p_st[0]) == n and int(p_st[1]) > 0
    # Compare in pixel order (the sort keys may differ by a float ulp).
    j_ord = np.argsort(np.asarray(j_carry[5]))
    p_ord = torch.argsort(p_carry[5]).numpy()
    for a, b in zip(p_carry[:4], j_carry[:4]):
        np.testing.assert_allclose(a.numpy()[:, p_ord],
                                   np.asarray(b)[:, j_ord], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(p_carry[4].numpy()[p_ord],
                                  np.asarray(j_carry[4])[j_ord])
    # Live rays first, as the compact driver relies on.
    alive = p_carry[4].numpy()
    assert not alive[np.argmin(alive):].any()


def test_slice_matches_jax(setup):
    """The render slice: the walk schedule's hit fns + the compacted
    wavefront driver, three bounces.  Stats must be equal; pixels allclose
    on >= 99.5% of the image (an ulp can flip a lobe or roulette choice;
    JAX's own scan and compact drivers differ by ulps)."""
    js, ps, jl, pl = setup
    n = CAM["width"] * CAM["height"]
    kw = dict(max_depth=3, rr_bounces=0, spp=1, sort_bounces=True,
              sort_shadows_from=1)
    u = host_uniforms(0, n, total_slots(6, 3))
    j_fns = jax_fastpath.build_hit_fns(
        js, jax_fastpath.parse_walks(WALKS, 3),
        jax_fastpath.parse_walks(WALKS_SHADOW, 3))
    j_img, j_st, j_ov = jax_trace_image_compact(
        j_fns, jl, JaxCamera(**CAM), JaxRenderConfig(**kw),
        JaxArrayStream(jnp.asarray(u)), (n, n, n), return_stats=True)
    p_fns = fastpath.build_hit_fns(ps, fastpath.parse_walks(WALKS, 3),
                                   fastpath.parse_walks(WALKS_SHADOW, 3))
    p_img, p_st, p_ov = trace_image_compact(
        p_fns, pl, CameraConfig(**CAM), RenderConfig(**kw),
        ArrayStream(torch.tensor(u)), (n, n, n), return_stats=True)
    assert int(j_ov) == int(p_ov) == 0
    np.testing.assert_array_equal(p_st.numpy(), np.asarray(j_st))
    a, b = p_img.numpy(), np.asarray(j_img)
    assert a.shape == b.shape == (32, 32, 3)
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.995, \
        f"outlier pixels {np.argwhere(~close).tolist()}"
    assert a.mean() > 0.01


@pytest.fixture(scope="module")
def port_scene():
    from srt_tpu_torch.utils.flatten import flatten_models
    from srt_tpu_torch.utils.procgen import uv_sphere
    return mesh.upload(flatten_models([uv_sphere(24, 36, radius=2.0)],
                                      pad_to=128), device="cpu")


@pytest.mark.parametrize("spp", [1, 2])
def test_render_plan_walk_matches_dense(port_scene, spp):
    """The port's plan on the CPU (plain kernel versions) against its
    independent dense traversal; no kernel is launched."""
    from srt_tpu_torch.scene import model_scene_lights
    cam = CameraConfig(**CAM)
    cfg = RenderConfig(max_depth=3, rr_bounces=0, spp=spp)
    traversal.reset_launch_counts()
    imgs = {}
    for method in ("walk", "dense"):
        plan = fastpath.make_render_plan(port_scene, model_scene_lights("cpu"),
                                         cam, cfg, method=method)
        img, stats, overflow = plan.render(rng.key(2, "cpu"))
        assert int(overflow) == 0 and stats.shape == (3, 2)
        assert bool(torch.isfinite(img).all()) and int(stats.sum()) > 0
        imgs[method] = img
    assert all(v == 0 for v in traversal.launch_counts.values())
    diff = (imgs["walk"] - imgs["dense"]).abs().amax(-1)
    assert float((diff > 1e-5).float().mean()) < 0.005


def port_lamp_plan():
    """A render plan with NEE on ``tests/test_nee.py``'s lamp scene
    (pad_to=128: the walk), 16x16, 3 bounces."""
    from srt_tpu_torch.scene import Lights
    from srt_tpu_torch.utils import procgen
    from srt_tpu_torch.utils.flatten import flatten_models
    from srt_tpu_torch.utils.obj_loader import MaterialDef
    lamp = procgen.cube(size=0.3, center=(0.9, 1.8, 0.6),
                        material=MaterialDef(diffuse=(0.0, 0.0, 0.0),
                                             specular=(0.0, 0.0, 0.0),
                                             emissive=(40.0, 32.0, 24.0)))
    recv = procgen.cube(size=2.2, center=(0.0, -0.4, 0.0),
                        material=MaterialDef(diffuse=(0.7, 0.7, 0.7),
                                             specular=(0.2, 0.2, 0.2)))
    scene = mesh.upload(flatten_models([recv, lamp], pad_to=128), "cpu")
    dim = Lights(position=torch.tensor([[0.0, 500.0, 0.0]]),
                 color=torch.tensor([[1.0, 1.0, 1.0]]),
                 intensity=torch.tensor([1e-6]))
    return fastpath.make_render_plan(
        scene, dim, CameraConfig(width=16, height=16, origin=(0.0, 3.0, 2.5),
                                 look_at=(0.0, 0.6, 0.0)),
        RenderConfig(max_depth=3, rr_bounces=0, nee=True))


def test_walk_parsing_and_validation(port_scene):
    from srt_tpu_torch.scene import model_scene_lights
    assert fastpath.parse_walk("tiled@256") == (False, 256)
    assert fastpath.parse_walk("pg2:32:4") == ("pg2:32:4", 0)
    with pytest.raises(ValueError):
        fastpath.parse_walk("warp")
    assert len(fastpath.parse_walks("tiled,pg2:16:4", 4)) == 4
    with pytest.raises(ValueError, match="does not divide"):
        fastpath.make_render_plan(port_scene, model_scene_lights("cpu"),
                                  CameraConfig(**CAM),
                                  RenderConfig(max_depth=2, rr_bounces=0),
                                  walks="tiled@256,pg2:96:4")
    # cfg.nee: the plan builds the scene's emitter tables and renders
    # with them (none here: the sphere does not emit, so the frame equals
    # the plan's without NEE).
    plans = [fastpath.make_render_plan(
        port_scene, model_scene_lights("cpu"), CameraConfig(**CAM),
        RenderConfig(max_depth=2, rr_bounces=0, nee=nee))
        for nee in (False, True)]
    assert plans[1].cfg.nee and plans[1].emitters is None
    frames = [p.render(rng.key(3, "cpu")) for p in plans]
    assert int(frames[1][2]) == 0
    assert torch.equal(frames[0][0], frames[1][0])
    lamp = port_lamp_plan()
    assert lamp.emitters is not None and lamp.emitters.v0.shape == (12, 3)
    img, stats, overflow = lamp.render(rng.key(4, "cpu"))
    assert int(overflow) == 0 and bool(torch.isfinite(img).all())
    assert img.shape == (16, 16, 3) and float(img.mean()) > 0.01
    w, ws = fastpath.default_walks(port_scene, 4)
    assert len(w) == len(ws) == 4


def test_port_imports_no_jax():
    """Every port module, the trainer (``optim``), the atlas host code,
    texture sampling, the emitter tables and the app layer (``app``,
    checkpoints, tonemapping, validation, profiling, image files), the
    sharded renders (``parallel``) and the entry points (the numpy oracle,
    ``bench``, ``bench_suite``, the tools) and every measurement tool
    (``tools.*``) among them, imports without JAX, optax or the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import srt_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    srt_tpu_torch.__path__, 'srt_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 35, mods\n"
        "for m in ('optim', 'utils.atlas', 'ops.texture',\n"
        "          'models.emitters', 'app', 'utils.checkpoint',\n"
        "          'ops.tonemap', 'utils.validate', 'utils.profiling',\n"
        "          'utils.image', 'parallel.mesh', 'parallel.render_sharded',\n"
        "          'parallel.multihost', 'models.reference_cpu', 'bench',\n"
        "          'bench_suite', 'tools.render_demo',\n"
        "          'tools.interactive_session'):\n"
        "    assert 'srt_tpu_torch.' + m in mods, mods\n"
        "for m in ('common', 'micro_occ', 'wavefronts', 'eval_counts',\n"
        "          'profile_bounces', 'profile_breakdown', 'profile_bench',\n"
        "          'profile_frame', 'profile_scan', 'profile_fastpath',\n"
        "          'profile_trace', 'parse_trace', 'parity_smoke',\n"
        "          'micro_bounce_real', 'micro_pg2_split', 'micro_pgwalk',\n"
        "          'micro_gather', 'micro_soa', 'micro_layout',\n"
        "          'micro_binned', 'micro_footprint', 'micro_sortkeys',\n"
        "          'multihost_2proc'):\n"
        "    assert 'srt_tpu_torch.tools.' + m in mods, mods\n"
        "bad = [m for m in sys.modules\n"
        "       if m in ('jax', 'optax', 'srt_tpu')\n"
        "       or m.startswith(('jax.', 'optax.', 'srt_tpu.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
