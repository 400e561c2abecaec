"""PyTorch port vs JAX package: textures — the atlas host code, atlas
sampling, the mip LOD and ray cones, textured hit records and textured
renders through both integrators, and the atlas gradient.

Inputs are made with numpy from a seed and go through both packages on
the CPU.  JAX runs under ``jax.disable_jit()`` wherever values are
compared (every operation rounded as written, as the port's eager torch
rounds it; ``tests/test_torch_spheres.py`` says why).

Tolerances: the host tables bit for bit; ``sample_atlas`` bit for bit
(measured: equal); the mip LOD rtol 1e-6 (``log2`` may differ by an
ulp); hit records and materials rtol 1e-5 / atol 1e-6 (the albedo of
hit records atol 1e-5: the walk's and JAX's refines round the UV apart
by an ulp, and a fetch multiplies that by the texel slope); images the
port's image criterion (``assert_images_match``: >= 99.5% of pixels
within rtol 1e-4 / atol 1e-5) with equal stats; the walk against the
dense sweep rtol 1e-5 / atol 1e-6 (JAX's own
``test_textured_render_parity_dense_vs_pallas``); the atlas gradient
rtol 1e-4 / atol 1e-4 x max |JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.models.wavefront_compact import \
    trace_image_compact as jax_trace_image_compact
from srt_tpu.ops import texture as jax_texture
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import atlas as jax_atlas
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu.utils.obj_loader import MaterialDef as JaxMaterialDef
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.models.wavefront_compact import trace_image_compact
from srt_tpu_torch.ops import texture
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.utils import atlas, procgen
from srt_tpu_torch.utils.flatten import flatten_models
from srt_tpu_torch.utils.obj_loader import MaterialDef
from tests.test_torch_host import assert_scene_equal, jax_scene_arrays
from tests.test_torch_spheres import assert_images_match

torch.set_num_threads(2)

CAM = dict(width=24, height=16, origin=(0.0, 0.5, 5.0),
           look_at=(0.0, 0.0, 0.0))


def t(x):
    return torch.tensor(np.asarray(x))


def seeded_images(seed):
    """Three textures of odd and even sizes (odd dimensions exercise the
    mip chain's floor halving)."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s).astype(np.float32)
            for s in ((13, 20, 3), (8, 8, 3), (33, 17, 3))]


def checker_image(size=64, squares=8):
    """config9's map at a small size: checker x gradient."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    checker = (np.floor(xx * squares) + np.floor(yy * squares)) % 2
    return np.stack([0.2 + 0.6 * checker, 0.3 + 0.5 * yy, 0.8 - 0.5 * xx],
                    axis=-1).astype(np.float32)


def assert_atlas_equal(a, b):
    for f in ("image", "rects", "mip_rects"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("levels", [1, 3, 6])
def test_pack_atlas_and_quad_table_match_jax(levels):
    """``pack_atlas`` (6 levels: chains that bottom out early repeat their
    last level), ``build_mip_chain`` and ``build_quad_table``, bit for
    bit."""
    imgs = seeded_images(levels)
    want = jax_atlas.pack_atlas(imgs, mip_levels=levels)
    got = atlas.pack_atlas(imgs, mip_levels=levels)
    assert_atlas_equal(got, want)
    assert got.num_levels == want.num_levels and got.num_textures == 3
    for im in imgs:
        for a, b in zip(atlas.build_mip_chain(im, levels),
                        jax_atlas.build_mip_chain(im, levels)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    q = atlas.build_quad_table(got.image, got.rects, got.mip_rects)
    assert np.array_equal(q, jax_atlas.build_quad_table(
        want.image, want.rects, want.mip_rects))
    empty = atlas.pack_atlas([])
    assert_atlas_equal(empty, jax_atlas.pack_atlas([]))


def test_build_atlas_for_materials_matches_jax(tmp_path):
    """PNG files written with PIL: a shared texture path, an untextured
    material and a missing file (index -1, as without a decoder)."""
    from PIL import Image
    rng = np.random.default_rng(5)
    paths = []
    for k, size in enumerate(((6, 10), (16, 16))):
        p = str(tmp_path / f"tex{k}.png")
        Image.fromarray(rng.integers(0, 256, size=size + (3,),
                                     dtype=np.uint8)).save(p)
        paths.append(p)
    specs = [(True, paths[0]), (False, None), (True, paths[1]),
             (True, paths[0]), (True, str(tmp_path / "missing.png"))]
    for levels in (1, 3):
        want, want_idx = jax_atlas.build_atlas_for_materials(
            [JaxMaterialDef(use_texture=u, texture_path=p)
             for u, p in specs], mip_levels=levels)
        got, got_idx = atlas.build_atlas_for_materials(
            [MaterialDef(use_texture=u, texture_path=p) for u, p in specs],
            mip_levels=levels)
        assert np.array_equal(got_idx, want_idx)
        assert list(got_idx) == [0, -1, 1, 0, -1]
        assert_atlas_equal(got, want)
    assert atlas.build_atlas_for_materials([MaterialDef()]) == (
        None, np.full(1, -1, np.int32))


HALF_TEXELS = 49


def sample_inputs(n, seed):
    """UVs in [-2.5, 3.5) (negative values and values above 1), a block
    of 7 x 7 exact half-texel points of texture 1 (8x8: u * 8 - 0.5 =
    j + 0.5, reached from below 0 in u and above 1 in v, so the floor
    modulo runs first; the nearest fetch rounds half to even), texture
    indices out of the table (clamped) and LODs beyond the chain
    (clamped)."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2.5, 3.5, size=(n, 2)).astype(np.float32)
    ti = rng.integers(-1, 4, size=n).astype(np.int32)
    k = np.arange(HALF_TEXELS)
    uv[:HALF_TEXELS, 0] = (k % 7 + 1.0) / 8.0 - 1.0
    uv[:HALF_TEXELS, 1] = (k // 7 + 1.0) / 8.0 + 1.0
    ti[:HALF_TEXELS] = 1
    lod = rng.uniform(-1.0, 5.0, size=n).astype(np.float32)
    return uv, ti, lod


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "quad", "trilinear",
                                  "trilinear-quad"])
def test_sample_atlas_matches_jax(mode):
    """Every fetch mode against JAX's, bit for bit."""
    at = jax_atlas.pack_atlas(seeded_images(0), mip_levels=4)
    uv, ti, lod = sample_inputs(2048, 1)
    quad = jax_atlas.build_quad_table(at.image, at.rects, at.mip_rects)
    jk, pk = {}, {}
    if mode == "nearest":
        jk["bilinear"] = pk["bilinear"] = False
    if mode.endswith("quad"):
        jk["quad"], pk["quad"] = jnp.asarray(quad), t(quad)
    if mode.startswith("trilinear"):
        jk.update(mip_rects=jnp.asarray(at.mip_rects), lod=jnp.asarray(lod))
        pk.update(mip_rects=t(at.mip_rects), lod=t(lod))
    with jax.disable_jit():
        want = np.asarray(jax_texture.sample_atlas(
            jnp.asarray(at.image), jnp.asarray(at.rects), jnp.asarray(ti),
            jnp.asarray(uv), **jk))
    got = texture.sample_atlas(t(at.image), t(at.rects), t(ti), t(uv),
                               **pk).numpy()
    np.testing.assert_array_equal(got, want)
    if mode == "nearest":
        # Half-texel points round half to even: j + 0.5 -> the even one
        # of j and j + 1.
        x0, y0 = at.rects[1, :2]
        k = np.arange(HALF_TEXELS)
        jx, jy = k % 7, k // 7
        np.testing.assert_array_equal(
            got[:HALF_TEXELS],
            at.image[y0 + jy + jy % 2, x0 + jx + jx % 2])


def textured_flat(pg, flatten, rows=8, cols=12, radius=1.0, pad_to=1):
    flat = flatten([pg.uv_sphere(rows, cols, radius=radius)], pad_to=pad_to)
    flat.mat_use_texture[:] = True
    flat.mat_tex_index[:] = 0
    return flat


@pytest.fixture(scope="module")
def tex_scenes():
    """uv_sphere(12, 16, radius=1.5), one cluster, config9's checker map
    at 64x64 with 4 mip levels, mip_lod_scale 10, every material textured:
    the JAX scene, the port's upload and the port's conversion of the JAX
    scene."""
    at = atlas.pack_atlas([checker_image()], mip_levels=4)
    kw = dict(atlas=at.image, atlas_rects=at.rects,
              atlas_mip_rects=at.mip_rects, mip_lod_scale=10.0)
    js = jax_mesh.upload(textured_flat(jax_procgen, jax_flatten, 12, 16, 1.5,
                                       128), **kw)
    ps = mesh.upload(textured_flat(procgen, flatten_models, 12, 16, 1.5,
                                   128), "cpu", **kw)
    d, static = jax_scene_arrays(js)
    return js, ps, d, static, kw


def test_textured_upload_and_conversion_match_jax(tex_scenes):
    """The port's upload gives the JAX tables bit for bit, the atlas, its
    rects, mip rects and quad table included; ``scene_from_arrays`` of
    the JAX scene round-trips them; ``quad_pack=False`` leaves no quad
    table, as in JAX."""
    js, ps, d, static, kw = tex_scenes
    assert d["atlas_quad"] is not None and d["atlas_quad"].shape[1] == 12
    assert_scene_equal(ps, d, static)
    assert_scene_equal(mesh.scene_from_arrays(d, static, "cpu"), d, static)
    flat = textured_flat(procgen, flatten_models, pad_to=128)
    no_quad = mesh.upload(flat, "cpu", quad_pack=False, **kw)
    assert no_quad.atlas_quad is None and no_quad.atlas is not None
    jd, jstatic = jax_scene_arrays(jax_mesh.upload(
        textured_flat(jax_procgen, jax_flatten, pad_to=128),
        quad_pack=False, **kw))
    assert_scene_equal(no_quad, jd, jstatic)


def lod_inputs(n, seed):
    rng = np.random.default_rng(seed)
    tt = rng.uniform(0.01, 40.0, size=n).astype(np.float32)
    width = rng.uniform(0.0, 0.5, size=n).astype(np.float32)
    spread = rng.uniform(0.0, 0.3, size=n).astype(np.float32)
    tt[:8], width[:8] = 0.02, 0.0           # footprints below one texel
    return tt, width, spread


@pytest.mark.parametrize("with_cone", [False, True], ids=["distance", "cone"])
def test_mip_lod_and_triangle_material_match_jax(tex_scenes, with_cone):
    """``_mip_lod`` (the distance heuristic and the ray-cone footprint)
    and ``triangle_material`` at seeded triangles and barycentrics."""
    js, ps, *_ = tex_scenes
    n = 512
    tt, width, spread = lod_inputs(n, 2)
    rng = np.random.default_rng(3)
    tri = rng.integers(0, ps.num_triangles, size=n).astype(np.int32)
    u = rng.uniform(-0.01, 0.7, size=n).astype(np.float32)
    v = (rng.uniform(-0.01, 1.0, size=n) * (1.0 - u)).astype(np.float32)
    j_cone = (jnp.asarray(width), jnp.asarray(spread)) if with_cone else None
    p_cone = (t(width), t(spread)) if with_cone else None
    with jax.disable_jit():
        want_lod = np.asarray(jax_mesh._mip_lod(js, jnp.asarray(tt),
                                                cone=j_cone))
        want = jax_mesh.triangle_material(
            js, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v),
            t=jnp.asarray(tt), cone=j_cone)
    got_lod = mesh._mip_lod(ps, t(tt), cone=p_cone).numpy()
    np.testing.assert_allclose(got_lod, want_lod, rtol=1e-6)
    assert got_lod.max() > 1.0 and got_lod.min() == 0.0
    got = mesh.triangle_material(ps, t(tri), t(u), t(v), t=t(tt),
                                 cone=p_cone)
    for f in ("albedo", "specular", "roughness", "metalness", "use_spec"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    # Without t the base level is sampled; without mips there is no LOD.
    base = mesh.triangle_material(ps, t(tri), t(u), t(v))
    with jax.disable_jit():
        jbase = jax_mesh.triangle_material(js, jnp.asarray(tri),
                                           jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(base.albedo.numpy(), np.asarray(jbase.albedo),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(base.albedo.numpy(), got.albedo.numpy())
    import dataclasses
    assert mesh._mip_lod(dataclasses.replace(ps, mip_lod_scale=0.0),
                         t(tt)) is None


def surface_rays(n, seed):
    """Rays from a ring around the sphere toward points near it (a few
    miss)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32)
    o *= (5.0 / np.linalg.norm(o, axis=0))[None, :]
    target = rng.uniform(-1.7, 1.7, size=(3, n)).astype(np.float32)
    return o, (target - o).astype(np.float32)


@pytest.mark.parametrize("method,ray_tile", [("dense", 0), ("dense", 300),
                                             ("walk", 0)])
def test_hit_with_cone_matches_jax_dense(tex_scenes, method, ray_tile):
    """The hit record with a cone against JAX's dense sweep: the port's
    dense sweep (whole, and in chunks of 300 rays, which slice the cone
    with the rays) and its walk."""
    js, ps, *_ = tex_scenes
    n = 700
    o, d = surface_rays(n, 4)
    _, width, spread = lod_inputs(n, 5)
    with jax.disable_jit():
        want = jax_mesh.mesh_hit_fn(js, method="dense")(
            jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.inf,
            cone=(jnp.asarray(width), jnp.asarray(spread)))
    got = mesh.mesh_hit_fn(ps, method=method, ray_tile=ray_tile)(
        t(o), t(d), 1e-3, float("inf"), cone=(t(width), t(spread)))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    hit = got.hit.numpy()
    assert 0.5 < hit.mean() < 1.0
    for f in ("t", "p", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy()[..., hit],
                                   np.asarray(getattr(want, f))[..., hit],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    # The fetch multiplies the UV's rounding by the texel-space slope
    # (64 texels x a 0.6 checker step): atol 1e-5.
    np.testing.assert_allclose(got.mat.albedo.numpy(),
                               np.asarray(want.mat.albedo), rtol=1e-5,
                               atol=1e-5)
    # The cone moves the albedo: a zero cone samples finer mips.
    zero = torch.zeros(n)
    sharp = mesh.mesh_hit_fn(ps, method=method, ray_tile=ray_tile)(
        t(o), t(d), 1e-3, float("inf"), cone=(zero, zero))
    assert (sharp.mat.albedo - got.mat.albedo).abs().max() > 0.01


def test_textured_walk_matches_dense(tex_scenes):
    """The port's analog of JAX's ``test_textured_render_parity_dense_vs_
    pallas``: the textured scene with ray cones renders alike through the
    walk and the dense sweep (the atlas fetch sits outside the walk), and
    the texture shows in the image."""
    _, ps, *_ = tex_scenes
    cfg = RenderConfig(max_depth=3, rr_bounces=0, ray_cones=True)
    from srt_tpu_torch.ops import rng
    imgs = {m: pathtracer.render(mesh.mesh_hit_fn(ps, method=m,
                                                  kernel_tile=128),
                                 model_scene_lights("cpu"),
                                 CameraConfig(**CAM), cfg, rng.key(0, "cpu"))
            for m in ("dense", "walk")}
    assert bool(torch.isfinite(imgs["dense"]).all())
    np.testing.assert_allclose(imgs["walk"].numpy(), imgs["dense"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(imgs["dense"].std()) > 1e-3


@pytest.mark.parametrize("cones", [True, False], ids=["cones", "no-cones"])
def test_textured_scan_render_matches_jax(tex_scenes, cones):
    """A textured frame through the scan (``trace_image_sample``, the
    bounce re-sort on, 3 bounces) from one injected uniform array: equal
    stats and the image criterion.  With cones the carry's two channels
    ride the sort; the two images differ (a filtering change)."""
    js, ps, *_ = tex_scenes
    n = CAM["width"] * CAM["height"]
    kw = dict(max_depth=3, rr_bounces=0, sort_bounces=True, ray_cones=cones)
    u = host_uniforms(6, n, total_slots(6, 3))
    with jax.disable_jit():
        j_img, j_st = jax_pt.trace_image_sample(
            jax_mesh.mesh_hit_fn(js, method="dense"), jax_lights(),
            JaxCamera(**CAM), JaxRenderConfig(**kw),
            JaxArrayStream(jnp.asarray(u)), return_stats=True)
    p_img, p_st = pathtracer.trace_image_sample(
        mesh.mesh_hit_fn(ps), model_scene_lights("cpu"), CameraConfig(**CAM),
        RenderConfig(**kw), ArrayStream(t(u)), return_stats=True)
    np.testing.assert_array_equal(p_st.numpy(),
                                  np.asarray(j_st).astype(np.int32))
    a = assert_images_match(p_img, j_img)
    assert np.isfinite(a).all() and a.std() > 1e-3
    if cones:
        other = pathtracer.trace_image_sample(
            mesh.mesh_hit_fn(ps), model_scene_lights("cpu"),
            CameraConfig(**CAM), RenderConfig(**{**kw, "ray_cones": False}),
            ArrayStream(t(u)))
        diff = (other - p_img).abs()
        assert float(diff.max()) > 1e-4 and float(diff.mean()) < 0.2


def test_textured_compact_matches_jax(tex_scenes):
    """A textured frame with cones through the compact driver at a
    schedule that slices the carry (cone channels included) after the
    first bounce: equal stats and overflow, the image criterion."""
    js, ps, *_ = tex_scenes
    n = CAM["width"] * CAM["height"]
    kw = dict(max_depth=3, rr_bounces=0, sort_bounces=True, ray_cones=True,
              uniform_use_spec=True)
    sched = (n, 256, 128)
    u = host_uniforms(8, n, total_slots(6, 3))
    with jax.disable_jit():
        j_img, j_st, j_ov = jax_trace_image_compact(
            jax_mesh.mesh_hit_fn(js, method="dense"), jax_lights(),
            JaxCamera(**CAM), JaxRenderConfig(**kw),
            JaxArrayStream(jnp.asarray(u)), sched, return_stats=True)
    p_img, p_st, p_ov = trace_image_compact(
        mesh.mesh_hit_fn(ps), model_scene_lights("cpu"), CameraConfig(**CAM),
        RenderConfig(**kw), ArrayStream(t(u)), sched, return_stats=True)
    assert int(p_ov) == int(j_ov) == 0
    assert int(p_st[1, 0]) < n
    np.testing.assert_array_equal(p_st.numpy(), np.asarray(j_st))
    a = assert_images_match(p_img, j_img)
    assert a.std() > 1e-3


def test_atlas_gradient_matches_jax():
    """d mean(image) / d atlas with ``quad_pack=False`` (the per-tap
    gathers' backward lands in the atlas), uv_sphere(8, 12), 16x12, two
    bounces with cones: against ``jax.grad``; texels the rays never
    sampled get exactly zero on both sides."""
    at = atlas.pack_atlas([checker_image(16, 4)], mip_levels=3)
    kw = dict(atlas=at.image, atlas_rects=at.rects,
              atlas_mip_rects=at.mip_rects, mip_lod_scale=4.0,
              quad_pack=False)
    js = jax_mesh.upload(textured_flat(jax_procgen, jax_flatten,
                                       pad_to=128), **kw)
    ps = mesh.upload(textured_flat(procgen, flatten_models, pad_to=128),
                     "cpu", **kw)
    cam = dict(width=16, height=12, origin=(0.0, 0.5, 4.0),
               look_at=(0.0, 0.0, 0.0))
    kwc = dict(max_depth=2, rr_bounces=0, ray_cones=True)
    u = host_uniforms(9, 16 * 12, total_slots(6, 2))

    def jax_loss(a):
        img = jax_pt.trace_with_uniforms(
            jax_mesh.mesh_hit_fn(js.replace(atlas=a), method="dense"),
            jax_lights(), JaxCamera(**cam), JaxRenderConfig(**kwc),
            jnp.asarray(u))
        return jnp.mean(img)

    with jax.disable_jit():
        want = np.asarray(jax.grad(jax_loss)(js.atlas))
    import dataclasses
    a = ps.atlas.clone().requires_grad_(True)
    img = pathtracer.trace_with_uniforms(
        mesh.mesh_hit_fn(dataclasses.replace(ps, atlas=a)),
        model_scene_lights("cpu"), CameraConfig(**cam), RenderConfig(**kwc),
        t(u))
    img.mean().backward()
    got = a.grad.numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
