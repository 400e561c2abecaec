"""PyTorch port vs JAX package: the OBJ asset path and the legacy BRDF
tail.

OBJ/MTL files are written with ``procgen.write_obj`` (plus hand-written
ones for ``vn`` and ``Ke``) and loaded by both packages: ``load_object``
(JAX's Python parser, ``use_native="never"``), ``compute_vertex_normals``,
``load_mesh_scene`` and ``set_frame`` must give equal arrays.  The legacy
sampler set (``brdf.legacy_*``) is held against JAX's on seeded inputs at
rtol 1e-5 / atol 1e-6 (the same float32 formulas; libm's ``pow``, ``sin``
and ``cos`` may differ by an ulp), the GGX pdfs and evaluators at rtol
1e-4, as ``tests/test_torch_nee.py`` holds ``eval_lobes_pdf``: the GGX
peak amplifies an ulp of the half-vector (3.3e-5 relative on 5 of 256
legacy pdfs), and checked as
``tests/test_features.py::test_legacy_brdf_tail`` checks JAX's."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.models import mesh as jax_mesh
from srt_tpu.ops import brdf as jax_brdf
from srt_tpu.ops import vec as jax_vec
from srt_tpu.scene import Materials as JaxMaterials
from srt_tpu.utils import obj_loader as jax_obj
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu.utils.flatten import set_frame as jax_set_frame
from srt_tpu_torch.models import mesh
from srt_tpu_torch.ops import brdf, vec
from srt_tpu_torch.scene import Materials
from srt_tpu_torch.utils import obj_loader, procgen
from srt_tpu_torch.utils.flatten import flatten_models, set_frame
from tests.test_torch_host import assert_scene_equal, jax_scene_arrays

torch.set_num_threads(2)


def assert_mesh_equal(got, ref):
    for f in ("positions", "uvs", "tri_vidx", "tri_mat"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.normals is None) == (ref.normals is None)
    if ref.normals is not None:
        assert np.array_equal(got.normals, ref.normals)
    assert got.name == ref.name
    assert [vars(m) for m in got.materials] == [vars(m) for m in
                                                ref.materials]


def write_meshes(tmp_path):
    """Paths of OBJ files: the Rubik grid and a sphere through
    ``write_obj`` (usemtl runs, an MTL library), and a hand-written quad
    with ``vn``, ``vt`` and an emissive material."""
    paths = []
    for name, m in (("rubik", procgen.rubik_grid()),
                    ("sphere", procgen.uv_sphere(6, 8))):
        p = str(tmp_path / f"{name}.obj")
        procgen.write_obj(p, m)
        paths.append(p)
    (tmp_path / "lamp.mtl").write_text(
        "newmtl glow\nKd 0.1 0.1 0.1\nKs 0.2 0.2 0.2\nNs 8\nKe 2 1 0.5\n")
    (tmp_path / "lamp.obj").write_text(
        "mtllib lamp.mtl\nusemtl glow\nv -1 -1 0\nv 1 -1 0\nv 1 1 0\n"
        "v -1 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n")
    paths.append(str(tmp_path / "lamp.obj"))
    return paths


@pytest.mark.parametrize("use_native", ["auto", "never"])
def test_load_object_matches_jax(tmp_path, use_native):
    """Both values of ``use_native`` take the port's Python parser, equal
    to JAX's Python parser array for array."""
    for path in write_meshes(tmp_path):
        ref = jax_obj.load_object(path, use_native="never")
        got = obj_loader.load_object(path, use_native=use_native)
        assert_mesh_equal(got, ref)
    lamp = obj_loader.load_object(path)
    assert lamp.materials[0].emissive == (2.0, 1.0, 0.5)
    assert lamp.normals is not None and lamp.num_triangles == 2


def test_compute_vertex_normals_matches_jax(tmp_path):
    """Smooth normals of a written and reloaded sphere and of a procedural
    one: equal to JAX's, and radial."""
    path = write_meshes(tmp_path)[1]
    for ref_in, got_in in (
            (jax_obj.load_object(path, use_native="never"),
             obj_loader.load_object(path)),
            (jax_procgen.uv_sphere(24, 36), procgen.uv_sphere(24, 36))):
        ref = jax_obj.compute_vertex_normals(ref_in)
        got = obj_loader.compute_vertex_normals(got_in)
        assert_mesh_equal(got, ref)
    radial = np.abs((got.normals * got.positions).sum(1))
    assert (radial[np.linalg.norm(got.normals, axis=1) > 0.5] > 0.98).all()


@pytest.mark.parametrize("pad", [1, 128])
def test_load_mesh_scene_matches_jax(tmp_path, pad, monkeypatch):
    """Three OBJ models, the second moved by a frame: the port's scene
    equals JAX's table for table (the walk tables too at pad 128).  JAX's
    ``load_mesh_scene`` takes the native parser where it is built, which
    drops ``vn`` and ``Ke``; the test sends it to its Python parser, the
    one the port carries."""
    from srt_tpu.utils import native as jax_native
    monkeypatch.setattr(jax_native, "load_object_native", lambda path: None)
    paths = write_meshes(tmp_path)
    frames = [np.eye(4, dtype=np.float32) for _ in paths]
    frames[1][:3, 3] = (0.5, -2.0, 1.0)
    ref = jax_mesh.load_mesh_scene(paths, frames=frames, method_pad=pad)
    got = mesh.load_mesh_scene(paths, frames=frames, method_pad=pad,
                               device="cpu")
    assert_scene_equal(got, *jax_scene_arrays(ref))
    assert (got.woop is not None) == (pad == 128)
    assert inspect.signature(mesh.load_mesh_scene).parameters[
        "device"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.load_mesh_scene(paths[:1])


def test_set_frame_matches_jax():
    """``set_frame`` (``tests/test_mesh.py:95``): only the one model's
    frame moves, the input scene is untouched, and the uploaded scene
    equals JAX's."""
    moved = np.eye(4, dtype=np.float32)
    moved[0, 3] = 100.0
    ref_flat = jax_flatten([jax_procgen.cube(), jax_procgen.cube(2.0)])
    flat = flatten_models([procgen.cube(), procgen.cube(2.0)])
    before = flat.frames.copy()
    got = set_frame(flat, 1, moved)
    assert np.array_equal(flat.frames, before)
    assert np.array_equal(got.frames[1], moved)
    assert np.array_equal(got.frames[0], before[0])
    ref = jax_set_frame(ref_flat, 1, moved)
    assert np.array_equal(got.frames, ref.frames)
    assert_scene_equal(mesh.upload(got, "cpu"),
                       *jax_scene_arrays(jax_mesh.upload(ref)))


def legacy_inputs(n=256):
    """``tests/test_features.py::test_legacy_brdf_tail``'s inputs, as
    (JAX, port) tuples of (normal, in_dir, materials, u1, u2, u3)."""
    rs = np.random.default_rng(4)
    normal = rs.normal(size=(3, n)).astype(np.float32)
    in_dir = rs.normal(size=(3, n)).astype(np.float32)
    mats = dict(albedo=rs.uniform(0.2, 0.9, (3, n)),
                specular=rs.uniform(0.0, 0.2, (3, n)),
                roughness=rs.uniform(0.1, 0.9, n),
                metalness=np.full((n,), 0.1))
    mats = {k: v.astype(np.float32) for k, v in mats.items()}
    us = [np.random.default_rng(s).uniform(size=n).astype(np.float32)
          for s in (1, 2, 3)]
    jax_in = (jax_vec.normalize(jnp.asarray(normal)),
              jax_vec.normalize(jnp.asarray(in_dir)),
              JaxMaterials(**{k: jnp.asarray(v) for k, v in mats.items()},
                           use_spec=jnp.ones((n,), bool)),
              *[jnp.asarray(u) for u in us])
    port_in = (vec.normalize(torch.tensor(normal)),
               vec.normalize(torch.tensor(in_dir)),
               Materials(**{k: torch.tensor(v) for k, v in mats.items()},
                         use_spec=torch.ones((n,), dtype=torch.bool)),
               *[torch.tensor(u) for u in us])
    return jax_in, port_in


def close(got, ref, what, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=1e-6, err_msg=what)


def test_legacy_brdf_tail_matches_jax():
    """``legacy_sample_next_ray`` (direction, pdf, lobe), ``legacy_brdf``
    on its directions, each legacy evaluator and
    ``probability_to_sample_diffuse`` against JAX's; the checks of JAX's
    own test on the port's values."""
    (jn, ji, jm, ju1, ju2, ju3), (pn, pi, pm, pu1, pu2, pu3) = \
        legacy_inputs()
    zeros = torch.zeros(3, pn.shape[1])
    jd, jpdf, jdiff = jax_brdf.legacy_sample_next_ray(
        jnp.zeros((3, pn.shape[1])), jn, ji, jm, ju1, ju2, ju3)
    d, pdf, is_diff = brdf.legacy_sample_next_ray(zeros, pn, pi, pm, pu1,
                                                  pu2, pu3)
    assert np.array_equal(is_diff.numpy(), np.asarray(jdiff))
    close(d, jd, "direction")
    close(pdf, jpdf, "pdf", rtol=1e-4)
    jd_t = torch.tensor(np.asarray(jd))
    close(brdf.legacy_brdf(pn, pi, jd_t, pm, is_diff),
          jax_brdf.legacy_brdf(jn, ji, jd, jm, jdiff), "legacy_brdf",
          rtol=1e-4)
    close(brdf.legacy_diffuse_pdf(pn, jd_t),
          jax_brdf.legacy_diffuse_pdf(jn, jd), "legacy_diffuse_pdf")
    close(brdf.legacy_specular_pdf(pn, pi, jd_t, pm.roughness),
          jax_brdf.legacy_specular_pdf(jn, ji, jd, jm.roughness),
          "legacy_specular_pdf", rtol=1e-4)
    close(brdf.legacy_diffuse_brdf(pm), jax_brdf.legacy_diffuse_brdf(jm),
          "legacy_diffuse_brdf")
    spec = brdf.legacy_specular_brdf(pn, -pi, jd_t, pm)
    close(spec, jax_brdf.legacy_specular_brdf(jn, -ji, jd, jm),
          "legacy_specular_brdf", rtol=1e-4)
    close(brdf.probability_to_sample_diffuse(pm.albedo, spec),
          jax_brdf.probability_to_sample_diffuse(
              jm.albedo, jax_brdf.legacy_specular_brdf(jn, -ji, jd, jm)),
          "probability_to_sample_diffuse")

    # JAX's own test, on the port: the diffuse pdf is cos / pi of the
    # sampled direction, diffuse samples lie in the normal's hemisphere,
    # the diffuse lobe evaluates to albedo * NdotL / pi, the specular lobe
    # to finite, non-negative values.
    cos = (pn * d).sum(0).numpy()
    isd = is_diff.numpy()
    assert 0 < isd.sum() < isd.size
    np.testing.assert_allclose(pdf.numpy()[isd],
                               np.maximum(cos[isd], 0.0) / np.pi,
                               rtol=1e-5, atol=1e-6)
    assert (cos[isd] > 0).all()
    assert np.isfinite(pdf.numpy()).all() and (pdf.numpy() >= 0).all()
    val = brdf.legacy_brdf(pn, pi, d, pm, is_diff).numpy()
    lambert = pm.albedo.numpy() * np.maximum(cos, 0.0) / np.pi
    np.testing.assert_allclose(val[:, isd], lambert[:, isd], rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(val[:, ~isd]).all() and (val[:, ~isd] >= 0).all()
