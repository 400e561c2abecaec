"""PyTorch port vs JAX package: the scan integrator on mesh scenes, the
mesh hit function's ``flip_normals`` and ``ray_tile`` options, the
one-bounce wavefront API and the Rubik stand-in mesh.

Inputs are made with numpy from a seed and go through both packages on
the CPU; JAX traces with ``method="dense"`` and renders under
``jax.disable_jit()`` (every operation rounded as written, as the port's
eager torch rounds it; ``tests/test_torch_spheres.py`` says why).  The
port runs its walk (the kernels' plain versions on the CPU) and its dense
sweep.
"""

import dataclasses
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.models import wavefront as jax_wavefront
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh, pathtracer, wavefront
from srt_tpu_torch.ops import traversal
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.utils import procgen
from srt_tpu_torch.utils.flatten import flatten_models
from tests.test_torch_spheres import assert_images_match

torch.set_num_threads(2)

CAM = dict(width=32, height=32, origin=(0.0, 1.0, 5.0),
           look_at=(0.0, 0.0, 0.0))


@pytest.fixture(scope="module")
def scenes():
    """uv_sphere(24, 36, radius=2.0): 1,656 triangles, 13 clusters, one
    supercluster (kernel tile 512), in both packages."""
    js = jax_mesh.upload(jax_flatten(
        [jax_procgen.uv_sphere(24, 36, radius=2.0)], pad_to=128))
    ps = mesh.upload(flatten_models([procgen.uv_sphere(24, 36, radius=2.0)],
                                    pad_to=128), device="cpu")
    return js, ps


@pytest.mark.parametrize("method", ["walk", "dense"])
def test_mesh_scan_matches_jax(scenes, method, monkeypatch):
    """config6's forward pass at 32x32: two bounces, bounce re-sort on,
    and ``sort_shadows_from=1`` set on both sides.  JAX's scan traces the
    bounce index, so it never sorts a shadow batch; the port's scan must
    not either (its sorted-shadow function raises here), and the images
    match: equal stats, the image criterion."""
    js, ps = scenes
    kw = dict(max_depth=2, rr_bounces=0, sort_bounces=True,
              sort_shadows_from=1)
    u = host_uniforms(2, 1024, total_slots(6, 2))
    with jax.disable_jit():
        j_img, j_st = jax_pt.trace_image_sample(
            jax_mesh.mesh_hit_fn(js, method="dense"), jax_lights(),
            JaxCamera(**CAM), JaxRenderConfig(**kw),
            jax_pt.ArrayStream(jnp.asarray(u)), return_stats=True)

    def no_sorted_shadows(*args, **kw):
        raise AssertionError("the scan route sorted a shadow batch")

    monkeypatch.setattr(pathtracer, "_occluded_sorted", no_sorted_shadows)
    traversal.reset_launch_counts()
    p_img, p_st = pathtracer.trace_image_sample(
        mesh.mesh_hit_fn(ps, method=method), model_scene_lights("cpu"),
        CameraConfig(**CAM), RenderConfig(**kw),
        ArrayStream(torch.tensor(u)), return_stats=True)
    assert all(v == 0 for v in traversal.launch_counts.values())
    np.testing.assert_array_equal(p_st.numpy(),
                                  np.asarray(j_st).astype(np.int32))
    assert int(p_st[0, 1]) > 0
    a = assert_images_match(p_img, j_img)
    assert np.isfinite(a).all() and a.mean() > 0.01


@pytest.mark.parametrize("method,ray_tile", [("walk", 300), ("dense", 300)])
def test_ray_tile_is_bit_identical(scenes, method, ray_tile, monkeypatch):
    """Tracing in chunks of ``ray_tile`` rays (a short last chunk) gives
    the same image, bit for bit, as one batch; closest and any-hit
    queries both go through the chunks.  The walk ignores ``ray_tile``,
    as JAX's does (its kernels tile rays themselves): one walk a query,
    whatever the chunk."""
    _, ps = scenes
    cfg = RenderConfig(max_depth=2, rr_bounces=0, sort_bounces=True)
    u = torch.tensor(host_uniforms(4, 1024, total_slots(6, 2)))
    imgs = [pathtracer.trace_with_uniforms(
        mesh.mesh_hit_fn(ps, method=method, ray_tile=rt),
        model_scene_lights("cpu"), CameraConfig(**CAM), cfg, u)
        for rt in (0, ray_tile)]
    assert torch.equal(imgs[0], imgs[1])
    assert float(imgs[0].mean()) > 0.01
    o = torch.randn(3, 700, generator=torch.Generator().manual_seed(1)) * 0.5
    o[2] += 5.0
    d = -o
    for any_hit in (False, True):
        whole = mesh.mesh_hit_fn(ps, method=method)(o, d, 1e-3, float("inf"),
                                                    any_hit=any_hit)
        tiled = mesh.mesh_hit_fn(ps, method=method, ray_tile=ray_tile)(
            o, d, 1e-3, float("inf"), any_hit=any_hit)
        for f in ("hit", "t", "p", "normal", "emitted", "tri"):
            a, b = getattr(whole, f), getattr(tiled, f)
            assert (a is None and b is None) or torch.equal(a, b), f
        assert torch.equal(whole.mat.albedo, tiled.mat.albedo)
    if method == "walk":
        walks = []
        real = traversal.model_hit

        def counted(*args, **kw):
            walks.append(args[2].shape[1])
            return real(*args, **kw)

        monkeypatch.setattr(traversal, "model_hit", counted)
        mesh.mesh_hit_fn(ps, method="walk", ray_tile=ray_tile)(
            o, d, 1e-3, float("inf"))
        assert walks == [700]


def hit_rays(n, seed):
    """Rays toward the sphere from outside (front faces) and from inside
    it (back faces), a few of them missing."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32)
    o *= (6.0 / np.linalg.norm(o, axis=0))[None, :]
    o[:, : n // 4] *= 0.1                                 # inside
    target = rng.uniform(-2.2, 2.2, size=(3, n)).astype(np.float32)
    return o, (target - o).astype(np.float32)


@pytest.mark.parametrize("flip", [True, False], ids=["flip", "no-flip"])
@pytest.mark.parametrize("method", ["walk", "dense"])
def test_flip_normals_matches_jax(scenes, method, flip):
    """``flip_normals=False`` keeps the interpolated normal (pointing out
    of the sphere for rays from inside); True turns it to face the ray."""
    js, ps = scenes
    o, d = hit_rays(512, 3)
    want = jax_mesh.mesh_hit_fn(js, method="dense", flip_normals=flip)(
        jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.inf)
    got = mesh.mesh_hit_fn(ps, method=method, flip_normals=flip)(
        torch.tensor(o), torch.tensor(d), 1e-3, float("inf"))
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert 0 < hit.sum() < hit.size
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5)
    n_got, n_want = got.normal.numpy(), np.asarray(want.normal)
    np.testing.assert_allclose(n_got, n_want, atol=1e-5)
    facing = (n_got * d).sum(0)[hit] < 0.0
    if flip:
        assert facing.all()
    else:
        # Front faces from outside, back faces from inside.
        assert 0 < facing.sum() < facing.size


@pytest.mark.parametrize("method", ["walk", "dense"])
def test_wavefront_api_matches_jax(scenes, method):
    """``intersect_rays``, ``hit_ids`` and ``intersect_full`` on [N, 3]
    rays against JAX's dense sweep; a finite ``t_max`` cuts some hits."""
    js, ps = scenes
    o, d = hit_rays(600, 5)
    o, d = o.T.copy(), d.T.copy()
    t_max = np.full(600, np.inf, np.float32)
    t_max[::2] = 4.0
    for kw in ({}, {"t_max": t_max}):
        j_idx, j_t = (np.asarray(x) for x in jax_wavefront.intersect_rays(
            js, o, d, **kw))
        p_idx, p_t = wavefront.intersect_rays(ps, o, d, method=method, **kw)
        h_idx, h_t = wavefront.hit_ids(ps, o, d, method=method, **kw)
        assert torch.equal(p_idx, h_idx) and p_idx.dtype == torch.int32
        hit = j_idx >= 0
        np.testing.assert_array_equal(p_idx.numpy() >= 0, hit)
        np.testing.assert_array_equal(p_idx.numpy(), j_idx)
        np.testing.assert_allclose(p_t.numpy()[hit], j_t[hit], rtol=1e-5)
        assert np.isinf(p_t.numpy()[~hit]).all()
        np.testing.assert_array_equal(
            h_t.numpy()[~hit], np.broadcast_to(kw.get("t_max", np.inf),
                                               (600,))[~hit])
    assert 0 < hit.sum() < hit.size
    want = jax_wavefront.intersect_full(js, o, d)
    got = wavefront.intersect_full(ps, o, d, method=method)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=1e-5)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal),
                               atol=1e-5)
    np.testing.assert_allclose(got.mat.albedo.numpy(),
                               np.asarray(want.mat.albedo), atol=1e-7)


def test_rubik_grid_and_write_obj_match_jax(tmp_path):
    """``rubik_grid`` equal field for field; ``write_obj`` writes the same
    OBJ and MTL bytes as JAX's for it and for a UV sphere."""
    a, b = procgen.rubik_grid(), jax_procgen.rubik_grid()
    assert a.num_triangles == b.num_triangles == 324
    for f in ("positions", "uvs", "tri_vidx", "tri_mat"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name
    assert [dataclasses.asdict(m) for m in a.materials] == [
        dataclasses.asdict(m) for m in b.materials]
    for mesh_p, mesh_j in ((a, b), (procgen.uv_sphere(5, 7),
                                    jax_procgen.uv_sphere(5, 7))):
        (tmp_path / "p").mkdir(exist_ok=True)
        (tmp_path / "j").mkdir(exist_ok=True)
        procgen.write_obj(str(tmp_path / "p" / "m.obj"), mesh_p)
        jax_procgen.write_obj(str(tmp_path / "j" / "m.obj"), mesh_j)
        mtl = mesh_p.name + ".mtl"
        for f in ("m.obj", mtl):
            assert filecmp.cmp(tmp_path / "p" / f, tmp_path / "j" / f,
                               shallow=False), f
