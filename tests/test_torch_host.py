"""PyTorch port vs JAX package: host tables, scene conversion, camera.

The port (``srt_tpu_torch``) carries its own numpy host code; these tests
hold it bit for bit against the JAX package's on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.camera import derive_viewport as jax_viewport
from srt_tpu.camera import generate_rays as jax_generate_rays
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.ops import morton as jax_morton
from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils import obj_loader as jax_obj
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh
from srt_tpu_torch.ops import morton, traversal
from srt_tpu_torch.scene import lights_from_arrays, model_scene_lights
from srt_tpu_torch.utils import obj_loader, procgen
from srt_tpu_torch.utils.flatten import flatten_models

torch.set_num_threads(2)

MESHES = {
    "sphere": lambda pg: pg.uv_sphere(40, 60),
    "cube": lambda pg: pg.cube(),
}


def jax_scene_arrays(scene):
    """numpy leaves + static fields of a JAX MeshScene."""
    d = {f: (None if getattr(scene, f) is None
             else np.asarray(getattr(scene, f))) for f in mesh.ARRAY_FIELDS}
    static = {k: getattr(scene, k) for k in mesh.STATIC_FIELDS}
    return d, static


def assert_scene_equal(port, d, static):
    for f in mesh.ARRAY_FIELDS:
        a = getattr(port, f)
        if d[f] is None:
            assert a is None, f
            continue
        b = torch.tensor(d[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b) or (
            a.is_floating_point()
            and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(), b.nan_to_num())), f
    for k, v in static.items():
        assert getattr(port, k) == v, k


@pytest.mark.parametrize("name", sorted(MESHES))
def test_flatten_matches_jax(name):
    ref = jax_flatten([MESHES[name](jax_procgen)], pad_to=128)
    got = flatten_models([MESHES[name](procgen)], pad_to=128)
    for f in ref.__dataclass_fields__:
        a, b = getattr(ref, f), getattr(got, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.parametrize("name", sorted(MESHES))
def test_upload_tables_match_jax(name):
    """The port's own upload gives the JAX tables bit for bit, Woop and
    cluster AABBs included."""
    d, static = jax_scene_arrays(
        jax_mesh.upload(jax_flatten([MESHES[name](jax_procgen)], pad_to=128)))
    got = mesh.upload(flatten_models([MESHES[name](procgen)], pad_to=128),
                      device="cpu")
    assert got.woop is not None and got.woop.shape[1:] == (16, 128)
    assert_scene_equal(got, d, static)


def test_scene_from_arrays_round_trip():
    d, static = jax_scene_arrays(
        jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(12, 18)],
                                    pad_to=128)))
    port = mesh.scene_from_arrays(d, static, "cpu")
    assert_scene_equal(port, d, static)
    back = {f: (None if getattr(port, f) is None
                else getattr(port, f).numpy()) for f in mesh.ARRAY_FIELDS}
    assert_scene_equal(mesh.scene_from_arrays(back, static, "cpu"), d, static)
    # A textured scene: the atlas, its rects, mip rects and quad table
    # round-trip too.
    from srt_tpu.utils.atlas import pack_atlas
    img = np.random.default_rng(1).uniform(size=(12, 10, 3)).astype(
        np.float32)
    at = pack_atlas([img], mip_levels=3)
    d, static = jax_scene_arrays(jax_mesh.upload(
        jax_flatten([jax_procgen.uv_sphere(12, 18)], pad_to=128),
        atlas=at.image, atlas_rects=at.rects, atlas_mip_rects=at.mip_rects,
        mip_lod_scale=3.0))
    assert d["atlas_quad"] is not None and static["mip_lod_scale"] == 3.0
    port = mesh.scene_from_arrays(d, static, "cpu")
    assert_scene_equal(port, d, static)
    back = {f: (None if getattr(port, f) is None
                else getattr(port, f).numpy()) for f in mesh.ARRAY_FIELDS}
    assert_scene_equal(mesh.scene_from_arrays(back, static, "cpu"), d, static)


def test_build_woop_and_clusters_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 256, 3)).astype(np.float32)
    v[2, 5] = v[0, 5]                       # a degenerate triangle
    np.testing.assert_array_equal(traversal.build_woop(*v),
                                  jax_tp.build_woop(*v))
    for a, b in zip(traversal.build_clusters(*v), jax_tp.build_clusters(*v)):
        np.testing.assert_array_equal(a, b)


def test_lights_converter():
    ref = jax_lights()
    got = lights_from_arrays({k: np.asarray(getattr(ref, k))
                              for k in ("position", "color", "intensity")},
                             "cpu")
    own = model_scene_lights(device="cpu")
    for k in ("position", "color", "intensity"):
        assert torch.equal(getattr(got, k), getattr(own, k))
    assert got.count == ref.count == 6


def test_entry_points_default_to_the_card():
    """Every public function of the port that takes a ``device`` defaults
    to None, the card; without a CUDA device such a call raises instead of
    falling back to the CPU."""
    import inspect

    from srt_tpu_torch import devices
    from srt_tpu_torch import scene as scene_mod
    from srt_tpu_torch.ops import rng
    calls = {
        mesh.upload: lambda: mesh.upload(
            flatten_models([procgen.uv_sphere(4, 6)], pad_to=128)),
        model_scene_lights: model_scene_lights,
        derive_viewport: lambda: derive_viewport(
            CameraConfig(), origin=(0.0, 1.0, 2.0), look_at=(0.0, 0.0, 0.0)),
        rng.key: lambda: rng.key(0),
        scene_mod.default_sphere_scene: scene_mod.default_sphere_scene,
        scene_mod.sphere_scene_lights: scene_mod.sphere_scene_lights,
        scene_mod.random_sphere_scene: lambda: scene_mod.random_sphere_scene(
            3),
        scene_mod.make_materials: lambda: scene_mod.make_materials(
            [((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), 0.2, 0.1, True)]),
    }
    for fn, call in calls.items():
        assert inspect.signature(fn).parameters["device"].default is None
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert devices.resolve("cpu") == torch.device("cpu")
    assert rng.key(0, "cpu").device.type == "cpu"
    # The renders take no device: they run where their key or uniforms
    # and their scene lie.
    from srt_tpu_torch.models import pathtracer
    for fn in (pathtracer.render, pathtracer.render_spheres,
               pathtracer.trace_with_uniforms, pathtracer.trace_image_sample,
               pathtracer.trace_wavefront):
        assert "device" not in inspect.signature(fn).parameters
    img = pathtracer.render_spheres(
        scene_mod.default_sphere_scene("cpu"),
        scene_mod.sphere_scene_lights("cpu"), CameraConfig(width=4, height=4),
        RenderConfig(max_depth=1, rr_bounces=0), rng.key(0, "cpu"))
    assert img.device.type == "cpu" and img.shape == (4, 4, 3)


@pytest.mark.parametrize("hw", [(8, 8), (24, 40), (33, 17)])
def test_morton_perm_matches_jax(hw):
    for a, b in zip(morton.morton_perm(*hw), jax_morton.morton_perm(*hw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spp", [1, 3])
def test_generate_rays_match_jax(spp):
    kw = dict(width=24, height=16, origin=(0.0, 1.0, 5.0),
              look_at=(0.0, 0.0, 0.0))
    jitter = np.random.default_rng(1).uniform(
        size=(2, 24 * 16 * spp)).astype(np.float32)
    o_ref, d_ref = jax_generate_rays(jax_viewport(JaxCamera(**kw)), 24, 16,
                                     jnp.asarray(jitter))
    o, d = generate_rays(derive_viewport(CameraConfig(**kw), device="cpu"),
                         24, 16,
                         torch.as_tensor(jitter))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-6,
                               atol=1e-6)
    if spp == 1:
        perm = morton.morton_perm(16, 24)[0]
        _, pd = morton.permute_rays(o, d, perm)
        np.testing.assert_array_equal(pd.numpy(), d.numpy()[:, perm])


def test_obj_parsers_match_jax(tmp_path):
    """Quads split, n-gons fan, negative indices, vt/vn, usemtl runs, MTL
    fields (Ke included) and the duplicate-material skip."""
    (tmp_path / "m.mtl").write_text(
        "newmtl a\nKd 0.1 0.2 0.3\nKs 1 1 1\nNs 64\nKe 2 2 0\n"
        "newmtl b\nKd 0.5 0.5 0.5\nmap_Kd tex.png\nnewmtl a\nKd 9 9 9\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvn 0 0 1\nusemtl a\n"
        "f 1/1/1 2/2/1 3/3/1 4\nusemtl b\nf -1 1 2 3 4\n")
    ref = jax_obj.parse_obj(str(tmp_path / "m.obj"))
    got = obj_loader.parse_obj(str(tmp_path / "m.obj"))
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(a, b)
    assert ref[3:] == got[3:] and len(got[3]) == 2
    mats_ref, mats = {}, {}
    jax_obj.parse_mtl(str(tmp_path / "m.mtl"), mats_ref)
    obj_loader.parse_mtl(str(tmp_path / "m.mtl"), mats)
    assert list(mats) == list(mats_ref) == ["a", "b"]
    for k in mats:
        assert vars(mats[k]) == vars(mats_ref[k])
