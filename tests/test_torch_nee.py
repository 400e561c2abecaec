"""PyTorch port vs JAX package: next-event estimation toward emissive
(Ke) triangles — the emitter tables, emitter sampling, the lobe pdf, one
NEE bounce, NEE renders through both integrators, the sentinel's exact
weight, the delta-mirror union and the gradients through the emitter
build.

The scene is ``tests/test_nee.py``'s: a small bright lamp cube over a
large receiver cube, lit by the emitter only (one negligible point light
keeps the slot protocol), seen from (0, 3, 2.5).  Inputs are made with
numpy from a seed; JAX runs under ``jax.disable_jit()`` wherever values
are compared, with ``method="dense"``.

Tolerances: emitter indices and picks exactly; the emitter tables rtol
1e-5 / atol 1e-6 (the frame inverse and the cumulative sum may round
apart by ulps); emitter samples rtol 1e-5 / atol 1e-6; ``eval_lobes_pdf``
rtol 1e-4 / atol 1e-6 (near the peak of a sharp GGX lobe the NDF
multiplies an ulp of the half vector's normalization by ~10: measured
1.2e-5 relative at roughness 0.2); bounce carries rtol 1e-5 / atol 1e-6
in pixel order with equal stats; images the port's image criterion
(``assert_images_match``) with equal stats; gradients rtol 1e-4 / atol
1e-4 x max |JAX|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.camera import derive_viewport as jax_viewport
from srt_tpu.camera import generate_rays as jax_generate_rays
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import emitters as jax_emitters
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.models.wavefront_compact import \
    trace_image_compact as jax_trace_image_compact
from srt_tpu.ops import brdf as jax_brdf
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu.ops.rng import KeyStream as JaxKeyStream
from srt_tpu.scene import Lights as JaxLights
from srt_tpu.scene import Materials as JaxMaterials
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu.utils.obj_loader import MaterialDef as JaxMaterialDef
from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import emitters, mesh, pathtracer
from srt_tpu_torch.models.wavefront_compact import trace_image_compact
from srt_tpu_torch.ops import brdf, rng
from srt_tpu_torch.ops.rng import ArrayStream, host_uniforms, total_slots
from srt_tpu_torch.scene import Lights, Materials, Spheres, make_materials
from srt_tpu_torch.utils import procgen
from srt_tpu_torch.utils.flatten import flatten_models
from srt_tpu_torch.utils.obj_loader import MaterialDef
from tests.test_torch_spheres import assert_images_match

torch.set_num_threads(2)

CAM = dict(width=24, height=18, origin=(0.0, 3.0, 2.5),
           look_at=(0.0, 0.6, 0.0))
N = CAM["width"] * CAM["height"]
# A world->model frame for the lamp that is not the identity: a rotation
# about a skew axis, a translation.
_ANG = 0.7
_AX = np.array([0.3, 0.8, 0.52]) / np.linalg.norm([0.3, 0.8, 0.52])
_K = np.array([[0, -_AX[2], _AX[1]], [_AX[2], 0, -_AX[0]],
               [-_AX[1], _AX[0], 0]])
ROTATED = np.eye(4, dtype=np.float32)
ROTATED[:3, :3] = (np.eye(3) + np.sin(_ANG) * _K
                   + (1 - np.cos(_ANG)) * _K @ _K).astype(np.float32)
ROTATED[:3, 3] = (0.2, -0.5, 0.1)


def t(x):
    return torch.tensor(np.asarray(x))


def lamp_meshes(pg, mdef):
    lamp = pg.cube(size=0.3, center=(0.9, 1.8, 0.6),
                   material=mdef(diffuse=(0.0, 0.0, 0.0),
                                 specular=(0.0, 0.0, 0.0),
                                 emissive=(40.0, 32.0, 24.0)))
    recv = pg.cube(size=2.2, center=(0.0, -0.4, 0.0),
                   material=mdef(diffuse=(0.7, 0.7, 0.7),
                                 specular=(0.2, 0.2, 0.2)))
    return [recv, lamp]


def lamp_scenes(frame=None, pad_to=128):
    """The lamp scene in both packages (the port's own upload); ``frame``
    is the lamp's world->model matrix."""
    frames = None if frame is None else [np.eye(4, dtype=np.float32), frame]
    js = jax_mesh.upload(jax_flatten(lamp_meshes(jax_procgen,
                                                 JaxMaterialDef),
                                     frames=frames, pad_to=pad_to))
    ps = mesh.upload(flatten_models(lamp_meshes(procgen, MaterialDef),
                                    frames=frames, pad_to=pad_to), "cpu")
    return js, ps


def dim_lights():
    kw = dict(position=[[0.0, 500.0, 0.0]], color=[[1.0, 1.0, 1.0]],
              intensity=[1e-6])
    return (JaxLights(**{k: jnp.asarray(v, jnp.float32)
                         for k, v in kw.items()}),
            Lights(**{k: torch.tensor(v, dtype=torch.float32)
                      for k, v in kw.items()}))


@pytest.fixture(scope="module")
def scenes():
    js, ps = lamp_scenes()
    return js, ps, jax_emitters.scene_emitters(js), \
        emitters.scene_emitters(ps)


def port_emitters_of(jem):
    """A JAX ``Emitters`` as the port's, field for field."""
    return emitters.Emitters(*(t(x) for x in jem))


@pytest.mark.parametrize("frame", [None, ROTATED], ids=["identity",
                                                         "rotated"])
def test_emitter_tables_match_jax(frame):
    """``emitter_indices`` exactly (padding excluded), ``build_emitters``
    at the stated tolerance, on the port's upload and on the port's
    conversion of the JAX scene; a scene without emitters has none."""
    js, ps = lamp_scenes(frame)
    want_idx = jax_emitters.emitter_indices(js)
    got_idx = emitters.emitter_indices(ps)
    assert got_idx.dtype == want_idx.dtype and np.array_equal(got_idx,
                                                              want_idx)
    assert len(got_idx) == 12 and got_idx.min() >= 128
    with jax.disable_jit():
        want = jax_emitters.build_emitters(js, want_idx)
    from tests.test_torch_traversal import port_scene_of
    for scene in (ps, port_scene_of(js)):
        got = emitters.build_emitters(scene, got_idx)
        for f in emitters.Emitters._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
    assert float(got.cdf[-1]) == pytest.approx(1.0, rel=1e-6)
    if frame is not None:
        # The rotated lamp's world corners are not its model corners.
        assert not np.allclose(got.v0.numpy(),
                               ps.tri_v0[t(got_idx).long()].numpy())
    plain = mesh.upload(flatten_models([procgen.cube()], pad_to=128), "cpu")
    assert emitters.scene_emitters(plain) is None


def test_sample_emitters_matches_jax(scenes):
    """With JAX's tables (its ``cdf``) and the same uniforms, the picks
    are equal and the samples agree; the port's own tables pick the same
    triangles except where a uniform falls within a rounding of a cdf
    step."""
    js, ps, jem, pem = scenes
    u = np.random.default_rng(3).uniform(size=(3, 4096)).astype(np.float32)
    u[0, :12] = np.asarray(jem.cdf)         # exactly on the steps (right)
    with jax.disable_jit():
        want = jax_emitters.sample_emitters(jem, *map(jnp.asarray, u))
        want_pick = np.clip(np.searchsorted(np.asarray(jem.cdf), u[0],
                                            side="right"), 0, 11)
    got = emitters.sample_emitters(port_emitters_of(jem), *map(t, u))
    for a, b, f in zip(got, want, ("x", "n", "le", "pdf_a")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    # The picks are searchsorted(side="right") of JAX's cdf: the points
    # lie on the picked triangles.
    v0, e1, e2 = (np.asarray(x)[want_pick].T for x in (jem.v0, jem.e1,
                                                        jem.e2))
    su = np.sqrt(u[1])
    np.testing.assert_allclose(got[0].numpy(),
                               v0 + (1.0 - su) * e1 + u[2] * su * e2,
                               rtol=1e-5, atol=1e-6)
    own = emitters.sample_emitters(pem, *map(t, u))
    same = np.isclose(own[0].numpy(), got[0].numpy(), rtol=1e-5,
                      atol=1e-6).all(0)
    assert same.mean() > 0.99


def lobe_inputs(n, seed):
    rng_ = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=0, keepdims=True)).astype(
            np.float32)
    normal = unit(rng_.normal(size=(3, n)))
    view = unit(rng_.normal(size=(3, n)) + normal)
    direction = unit(rng_.normal(size=(3, n)) + 0.5 * normal)
    h = unit(rng_.normal(size=(3, n)) + 2.0 * normal)
    rough = rng_.uniform(0.0, 1.0, size=n).astype(np.float32)
    rough[: n // 8] = 0.0                    # delta lobes
    metal = rng_.uniform(0.0, 1.0, size=n).astype(np.float32)
    metal[n // 8: n // 4] = 1.0
    mats = dict(albedo=rng_.uniform(size=(3, n)).astype(np.float32),
                specular=rng_.uniform(size=(3, n)).astype(np.float32),
                roughness=rough, metalness=metal,
                use_spec=np.ones(n, bool))
    return normal, view, direction, h, mats


@pytest.mark.parametrize("given_h", [True, False], ids=["h_diffuse", "h"])
def test_eval_lobes_pdf_matches_jax(given_h):
    """``brdf.eval_lobes_pdf`` on seeded normals, views, directions
    (some below the surface), roughness 0 (delta lobes: no pdf) and
    metalness 1."""
    normal, view, direction, h, mats = lobe_inputs(2048, 7)
    with jax.disable_jit():
        want = jax_brdf.eval_lobes_pdf(
            jnp.asarray(normal), jnp.asarray(view), jnp.asarray(direction),
            JaxMaterials(**{k: jnp.asarray(v) for k, v in mats.items()}),
            h_diffuse=jnp.asarray(h) if given_h else None)
    got = brdf.eval_lobes_pdf(t(normal), t(view), t(direction),
                              Materials(**{k: t(v) for k, v in mats.items()}),
                              h_diffuse=t(h) if given_h else None)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    pdf = got[1].numpy()
    assert (pdf > 0).mean() > 0.5 and np.isfinite(got[0].numpy()).all()


def primary_rays(stream_u):
    """Primary rays of ``CAM`` from the jitter slots of a [N, D] uniform
    array, in both packages."""
    j_jit = jnp.asarray(stream_u[:, :2].T)
    o, d = jax_generate_rays(jax_viewport(JaxCamera(**CAM)), CAM["width"],
                             CAM["height"], j_jit)
    po, pd = generate_rays(derive_viewport(CameraConfig(**CAM),
                                           device="cpu"),
                           CAM["width"], CAM["height"], t(stream_u[:, :2].T))
    return (o, d), (po, pd)


@pytest.mark.parametrize("cones", [False, True], ids=["nee", "nee+cones"])
def test_nee_bounce_step_matches_jax(scenes, cones):
    """One NEE bounce (bounce 1 of 3, the 6-D sort) on identical carries
    and uniforms: ``prev_pdf`` is the sentinel on half the rays and a
    seeded pdf on the rest; with cones the carry packs (cone width,
    spread, prev_pdf) in JAX's order.  The port runs its walk, JAX its
    dense sweep."""
    js, ps, jem, pem = scenes
    jl, pl = dim_lights()
    rng_ = np.random.default_rng(11)
    u0 = rng_.uniform(size=(N, 2)).astype(np.float32)
    (o, d), (po, pd) = primary_rays(u0)
    u = rng_.uniform(size=(rng.bounce_slots(1, True), N)).astype(np.float32)
    prev = np.where(rng_.uniform(size=N) < 0.5, 1e30,
                    rng_.uniform(0.1, 3.0, size=N)).astype(np.float32)
    kw = dict(max_depth=3, rr_bounces=0, nee=True, ray_cones=cones,
              sort_bounces=True)
    extra = []
    if cones:
        extra = [rng_.uniform(0, 0.01, size=N).astype(np.float32),
                 rng_.uniform(0, 0.02, size=N).astype(np.float32)]
    extra.append(prev)
    j_carry = (o, d, jnp.ones((3, N)), jnp.zeros((3, N)), jnp.ones(N, bool),
               jnp.arange(N, dtype=jnp.int32)) + tuple(
        jnp.asarray(x) for x in extra)
    p_carry = (po, pd, torch.ones((3, N)), torch.zeros((3, N)),
               torch.ones(N, dtype=torch.bool), torch.arange(N)) + tuple(
        t(x) for x in extra)
    with jax.disable_jit():
        j_out, j_st = jax_pt.bounce_step(
            jax_mesh.mesh_hit_fn(js, method="dense"), jl,
            JaxRenderConfig(**kw), j_carry, 1, jnp.asarray(u), sort=True,
            emitters=jem)
    p_out, p_st = pathtracer.bounce_step(
        mesh.mesh_hit_fn(ps), pl, RenderConfig(**kw), p_carry, 1, t(u),
        sort=True, emitters=pem)
    np.testing.assert_array_equal(p_st.numpy(), np.asarray(j_st))
    assert int(p_st[1]) > 0
    assert len(p_out) == len(j_out) == 6 + len(extra)
    j_ord = np.argsort(np.asarray(j_out[5]))
    p_ord = torch.argsort(p_out[5]).numpy()
    for k, (a, b) in enumerate(zip(p_out, j_out)):
        a, b = a.numpy()[..., p_ord], np.asarray(b)[..., j_ord]
        if a.dtype == bool or k == 5:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=str(k))
    # NEE lit the receiver: colour beyond the dim point light's.
    assert float(p_out[3].max()) > 0.01
    pp = p_out[-1].numpy()
    assert (pp == np.float32(1e30)).any() and (pp < 1e29).any()


def test_nee_scan_matches_jax(scenes):
    """``trace_wavefront(emitters=)`` (the scan route, bounce re-sort on,
    3 bounces) from one injected uniform array: equal stats, the image
    criterion; NEE changes the image and adds shadow queries."""
    js, ps, jem, pem = scenes
    jl, pl = dim_lights()
    kw = dict(max_depth=3, rr_bounces=0, nee=True, sort_bounces=True)
    u = host_uniforms(12, N, total_slots(1, 3, nee=True))
    (o, d), (po, pd) = primary_rays(u)
    with jax.disable_jit():
        j_img, j_st = jax_pt.trace_wavefront(
            jax_mesh.mesh_hit_fn(js, method="dense"), jl, o, d,
            JaxArrayStream(jnp.asarray(u[:, 2:])), JaxRenderConfig(**kw),
            return_stats=True, emitters=jem)
    p_img, p_st = pathtracer.trace_wavefront(
        mesh.mesh_hit_fn(ps), pl, po, pd, ArrayStream(t(u[:, 2:])),
        RenderConfig(**kw), return_stats=True, emitters=pem)
    np.testing.assert_array_equal(p_st.numpy(),
                                  np.asarray(j_st).astype(np.int32))
    assert_images_match(p_img.T, np.asarray(j_img).T)
    hit_only, h_st = pathtracer.trace_wavefront(
        mesh.mesh_hit_fn(ps), pl, po, pd, ArrayStream(t(u[:, 2:])),
        RenderConfig(**{**kw, "nee": False}), return_stats=True)
    assert int(p_st[:, 1].sum()) > int(h_st[:, 1].sum())
    assert float((p_img - hit_only).abs().max()) > 1e-3


def test_nee_compact_matches_jax(scenes):
    """``trace_image_compact(emitters=)`` at a schedule that slices the
    carry (``prev_pdf`` included) after the first bounce: equal stats and
    overflow, the image criterion."""
    js, ps, jem, pem = scenes
    jl, pl = dim_lights()
    kw = dict(max_depth=3, rr_bounces=0, nee=True, sort_bounces=True,
              uniform_use_spec=True)
    sched = (N, 256, 128)
    u = host_uniforms(13, N, total_slots(1, 3, nee=True))
    with jax.disable_jit():
        j_img, j_st, j_ov = jax_trace_image_compact(
            jax_mesh.mesh_hit_fn(js, method="dense"), jl, JaxCamera(**CAM),
            JaxRenderConfig(**kw), JaxArrayStream(jnp.asarray(u)), sched,
            return_stats=True, emitters=jem)
    p_img, p_st, p_ov = trace_image_compact(
        mesh.mesh_hit_fn(ps), pl, CameraConfig(**CAM), RenderConfig(**kw),
        ArrayStream(t(u)), sched, return_stats=True, emitters=pem)
    assert int(p_ov) == int(j_ov) == 0
    assert int(p_st[1, 0]) < N
    np.testing.assert_array_equal(p_st.numpy(), np.asarray(j_st))
    a = assert_images_match(p_img, j_img)
    assert a.mean() > 0.01


def port_frames(scene, em, nee, keys, cfg=None, hit_fn=None, size=None):
    """[K, H, W, 3] frames of the port, one per key (full-width compact)."""
    cam = CameraConfig(**{**CAM, **(size or {})})
    n = cam.width * cam.height
    hit_fn = hit_fn or mesh.mesh_hit_fn(scene)
    cfg = cfg or RenderConfig(max_depth=3, rr_bounces=0, sort_bounces=True,
                              nee=nee)
    sched = (n,) * (cfg.max_depth + cfg.rr_bounces)
    _, pl = dim_lights()
    return np.stack([trace_image_compact(
        hit_fn, pl, cam, cfg, rng.KeyStream(k, n), sched,
        emitters=em if nee else None).numpy() for k in keys])


def test_nee_direct_view_bit_identical(scenes):
    """Pixels whose primary ray hits the lamp credit Le with MIS weight
    exactly 1.0 (the 1e30 sentinel swallows any real pdf in float32), so
    they equal the hit-only frame's bit for bit (JAX's
    ``test_nee_direct_view_bit_identical``)."""
    _, ps, _, pem = scenes
    keys = [rng.key(7, "cpu")]
    plain = port_frames(ps, pem, False, keys)[0]
    nee = port_frames(ps, pem, True, keys)[0]
    d1 = port_frames(ps, pem, False, keys, cfg=RenderConfig(
        max_depth=1, rr_bounces=0, sort_bounces=True))[0]
    direct = d1.max(axis=-1) > 5.0
    assert direct.any()
    np.testing.assert_array_equal(nee[direct], plain[direct])
    assert not np.array_equal(nee, plain)


def test_nee_delta_mirror_finite_and_unbiased():
    """A roughness-0 metal mirror sphere under an emissive lamp (JAX's
    ``test_nee_delta_mirror_finite_and_unbiased``): the delta lobe has no
    area-sample pdf and takes the sentinel weight on the hit side.  One
    key's NEE frame equals JAX's (the image criterion); over 48 keys each
    the images are finite, the reflected lamp shows with NEE on, and the
    total flux of the two estimators agrees within 5%."""
    def lamp(pg, mdef):
        return pg.cube(size=0.35, center=(0.0, 2.0, 0.0),
                       material=mdef(diffuse=(0.0, 0.0, 0.0),
                                     specular=(0.0, 0.0, 0.0),
                                     emissive=(40.0, 32.0, 24.0)))

    js = jax_mesh.upload(jax_flatten([lamp(jax_procgen, JaxMaterialDef)],
                                     pad_to=128))
    ps = mesh.upload(flatten_models([lamp(procgen, MaterialDef)],
                                    pad_to=128), "cpu")
    row = [((0.9, 0.9, 0.9), (0.9, 0.9, 0.9), 0.0, 1.0, True)]
    from srt_tpu.scene import Spheres as JaxSpheres
    from srt_tpu.scene import make_materials as jax_make_materials
    j_hit = jax_pt.union_hit_fn(
        jax_pt.spheres_hit_fn(JaxSpheres(
            center=jnp.zeros((1, 3), jnp.float32),
            radius=jnp.asarray([0.9], jnp.float32),
            materials=jax_make_materials(row))),
        jax_mesh.mesh_hit_fn(js, method="dense"))
    p_hit = pathtracer.union_hit_fn(
        pathtracer.spheres_hit_fn(Spheres(
            center=torch.zeros((1, 3)), radius=torch.tensor([0.9]),
            materials=make_materials(row, "cpu"))),
        mesh.mesh_hit_fn(ps))
    jem, pem = jax_emitters.scene_emitters(js), emitters.scene_emitters(ps)
    jl, _ = dim_lights()
    cfg = dict(max_depth=3, rr_bounces=0, sort_bounces=True, nee=True)
    with jax.disable_jit():
        j_img = jax_trace_image_compact(
            j_hit, jl, JaxCamera(**CAM), JaxRenderConfig(**cfg),
            JaxKeyStream(jax.random.key(4), N), (N, N, N), emitters=jem)
    p_one = port_frames(ps, pem, True, [rng.key(4, "cpu")], hit_fn=p_hit)[0]
    assert_images_match(torch.tensor(p_one), j_img)

    plain = port_frames(ps, pem, False,
                        [rng.key(100 + k, "cpu") for k in range(48)],
                        hit_fn=p_hit)
    nee = port_frames(ps, pem, True,
                      [rng.key(200 + k, "cpu") for k in range(48)],
                      hit_fn=p_hit)
    assert np.isfinite(plain).all() and np.isfinite(nee).all()
    np.testing.assert_allclose(nee.mean(axis=0).sum(),
                               plain.mean(axis=0).sum(), rtol=0.05)
    assert (plain[0].max(axis=-1) > 5.0).any()
    assert (nee[0].max(axis=-1) > 5.0).any()


def test_nee_gradients_match_jax():
    """d mean(image) / d ``mat_emissive`` and d / d ``frames`` of an NEE
    frame (two bounces, the lamp under the rotated frame), the emitter
    tables rebuilt from the differentiated scene: against ``jax.grad``.
    More emission brightens the image."""
    js, ps = lamp_scenes(ROTATED, pad_to=1)
    jl, pl = dim_lights()
    idx = emitters.emitter_indices(ps)
    kw = dict(max_depth=2, rr_bounces=0, sort_bounces=True, nee=True)
    u = host_uniforms(14, N, total_slots(1, 2, nee=True))

    def jax_loss(ke, fr):
        s = js.replace(mat_emissive=ke, frames=fr)
        img = jax_trace_image_compact(
            jax_mesh.mesh_hit_fn(s, method="dense"), jl, JaxCamera(**CAM),
            JaxRenderConfig(**kw), JaxArrayStream(jnp.asarray(u)), (N, N),
            emitters=jax_emitters.build_emitters(s, idx))
        return jnp.mean(img)

    with jax.disable_jit():
        want = jax.grad(jax_loss, argnums=(0, 1))(js.mat_emissive, js.frames)
    ke = ps.mat_emissive.clone().requires_grad_(True)
    fr = ps.frames.clone().requires_grad_(True)
    s = dataclasses.replace(ps, mat_emissive=ke, frames=fr)
    img = trace_image_compact(
        mesh.mesh_hit_fn(s, method="dense"), pl, CameraConfig(**CAM),
        RenderConfig(**kw), ArrayStream(t(u)), (N, N),
        emitters=emitters.build_emitters(s, idx))
    img.mean().backward()
    for got, w, name in ((ke.grad, want[0], "mat_emissive"),
                         (fr.grad, want[1], "frames")):
        w = np.asarray(w)
        g = got.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0.0, name
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert float(ke.grad.sum()) > 0.0
