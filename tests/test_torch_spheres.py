"""PyTorch port vs JAX package: the sphere route of the scan integrator.

Scene constructors, the sphere quadric, the camera overrides, sphere
images from injected uniforms and from a threefry key, and the union of a
sphere and a mesh hit function.  Inputs are made with numpy from a seed
and go through both packages on the CPU.

JAX's renders run under ``jax.disable_jit()``: every operation is then
rounded as written, as the port's eager torch rounds it.  Compiled, XLA
fuses the scan body and contracts multiply-adds (the dot products and
``h * h - a * c`` of the quadric, the GGX terms), which moves pixels under
the roughness-0.01 highlights by up to 2.6e-4 relative (3 of 384 pixels
at 24x16, seed 7).  The oracle comparison at rtol = atol = 2e-3 holds the
port against float64 arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu import scene as jax_scene
from srt_tpu.camera import derive_viewport as jax_viewport
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.models import reference_cpu
from srt_tpu.ops import intersect as jax_intersect
from srt_tpu.ops.rng import ArrayStream as JaxArrayStream
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch import scene
from srt_tpu_torch.camera import derive_viewport
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.ops import intersect, rng
from srt_tpu_torch.ops.rng import host_uniforms, total_slots
from srt_tpu_torch.utils import procgen
from srt_tpu_torch.utils.flatten import flatten_models

torch.set_num_threads(2)

SPHERE_CAM = dict(width=24, height=16, origin=(0.0, 0.0, 0.0),
                  look_at=(0.0, 0.0, -1.0))
FIELDS = ("center", "radius") + scene.MATERIAL_FIELDS


def sphere_arrays(s):
    """numpy leaves of a JAX or port ``Spheres``, by field name."""
    d = {"center": s.center, "radius": s.radius,
         **{k: getattr(s.materials, k) for k in scene.MATERIAL_FIELDS}}
    return {k: np.asarray(v) for k, v in d.items()}


def assert_images_match(p_img, j_img):
    """The image criterion of the port's render tests: >= 99.5% of pixels
    within rtol 1e-4, atol 1e-5 (an ulp can flip a lobe or roulette
    choice)."""
    a, b = p_img.numpy(), np.asarray(j_img)
    assert a.shape == b.shape
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.995, \
        f"outlier pixels {np.argwhere(~close).tolist()}"
    return a


SCENES = {
    "default": (jax_scene.default_sphere_scene,
                lambda: scene.default_sphere_scene("cpu")),
    "random-12-seed3": (lambda: jax_scene.random_sphere_scene(12, seed=3),
                        lambda: scene.random_sphere_scene(12, seed=3,
                                                          device="cpu")),
    "random-40": (lambda: jax_scene.random_sphere_scene(40),
                  lambda: scene.random_sphere_scene(40, device="cpu")),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_sphere_scenes_match_jax(name):
    """Bit for bit, and again through ``spheres_from_arrays``."""
    want = sphere_arrays(SCENES[name][0]())
    for port in (SCENES[name][1](), scene.spheres_from_arrays(want, "cpu")):
        got = sphere_arrays(port)
        for k in FIELDS:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sphere_lights_and_cameras_match_jax():
    from srt_tpu import config as jax_config
    from srt_tpu_torch import config
    jl, pl = jax_scene.sphere_scene_lights(), scene.sphere_scene_lights("cpu")
    for k in ("position", "color", "intensity"):
        np.testing.assert_array_equal(getattr(pl, k).numpy(),
                                      np.asarray(getattr(jl, k)))
    assert pl.count == jl.count == 2
    for k in ("REFERENCE_WIDTH", "REFERENCE_HEIGHT"):
        assert getattr(config, k) == getattr(jax_config, k)
    for k in ("SPHERES_CAMERA", "MODEL_CAMERA"):
        a, b = getattr(config, k), getattr(jax_config, k)
        for f in ("width", "height", "origin", "look_at", "v_up", "vfov",
                  "focus_dist", "defocus_angle", "viewport_mode"):
            assert getattr(a, f) == getattr(b, f), (k, f)


def sphere_rays(seed):
    """Rays of every kind against the default scene: from outside toward
    the spheres (both roots ahead), from inside a small sphere and inside
    the ground sphere (near root behind t_min, far root taken), rays
    pointing away (misses), and per-ray t_max that cuts some hits off."""
    rng_ = np.random.default_rng(seed)
    n = 512
    o = rng_.uniform(-3.0, 3.0, size=(3, n)).astype(np.float32)
    o[2] = rng_.uniform(0.5, 3.0, size=n)
    o[:, :64] = np.array([[1.8], [0.0], [-2.0]], np.float32) \
        + rng_.uniform(-0.2, 0.2, size=(3, 64))           # inside blue
    o[:, 64:96] = np.array([[0.0], [-2.0], [-1.0]], np.float32)  # in ground
    target = np.array([[0.0], [0.0], [-2.0]], np.float32) \
        + rng_.uniform(-2.0, 2.0, size=(3, n))
    d = (target - o).astype(np.float32)
    d[:, 96:160] *= -1.0                                  # away: most miss
    t_max = rng_.uniform(0.5, 20.0, size=n).astype(np.float32)
    t_max[::3] = np.inf
    t_max[:96] = np.inf
    return o, d, t_max


@pytest.mark.parametrize("seed", [0, 1])
def test_sphere_hit_and_normal_match_jax(seed):
    """hit and idx equal, t within rtol 1e-6; the facing normal too."""
    o, d, t_max = sphere_rays(seed)
    js, ps = jax_scene.default_sphere_scene(), scene.default_sphere_scene(
        "cpu")
    jh, jt, ji = (np.asarray(x) for x in jax_intersect.sphere_hit(
        jnp.asarray(o), jnp.asarray(d), js.center, js.radius, 1e-3,
        jnp.asarray(t_max)))
    ph, pt, pi = intersect.sphere_hit(torch.tensor(o), torch.tensor(d),
                                      ps.center, ps.radius, 1e-3,
                                      torch.tensor(t_max))
    np.testing.assert_array_equal(ph.numpy(), jh)
    np.testing.assert_array_equal(pi.numpy(), ji)
    assert pi.dtype == torch.int32
    np.testing.assert_allclose(pt.numpy()[jh], jt[jh], rtol=1e-6)
    assert np.isinf(pt.numpy()[~jh]).all()
    # Every kind of ray is there: misses, both roots, a cut by t_max.
    assert 0 < jh.sum() < jh.size
    assert jh[:96].all() and (ji[64:96] == 1).all()
    h_inf = intersect.sphere_hit(torch.tensor(o), torch.tensor(d),
                                 ps.center, ps.radius, 1e-3, float("inf"))[0]
    assert (h_inf & ~ph).any() and not (ph & ~h_inf).any()
    # Normals at the hits, against the ray.
    p = o + np.where(jh, jt, 1.0)[None, :] * d
    c = np.asarray(js.center)[ji].T
    r = np.asarray(js.radius)[ji]
    jn, jf = (np.asarray(x) for x in jax_intersect.sphere_normal(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(r), jnp.asarray(d)))
    pn, pf = intersect.sphere_normal(torch.tensor(p), torch.tensor(c),
                                     torch.tensor(r), torch.tensor(d))
    np.testing.assert_array_equal(pf.numpy(), jf)
    np.testing.assert_allclose(pn.numpy(), jn, rtol=1e-6, atol=1e-7)
    assert not jf[64:96].any()       # from inside: the normal is flipped


def test_sphere_root_is_correctly_rounded(capsys):
    """``sphere_hit`` takes the quadric's root in float64 and rounds it,
    because torch's CPU float32 ``sqrt`` is not correctly rounded on
    every input, while JAX's (the reference) and numpy's are.  On the
    discriminants of 64 batches of ``sphere_rays`` against the default
    scene: JAX's root equals the float64-rounded one everywhere, and the
    port's ``t`` equals JAX's, both rounding every operation as written
    (``jax.disable_jit()``).  Prints how many of the discriminants
    torch's float32 ``sqrt`` rounds the other way."""
    ps, js = scene.default_sphere_scene("cpu"), jax_scene.default_sphere_scene()
    o, d, t_max = zip(*(sphere_rays(s) for s in range(64)))
    o, d, t_max = (np.concatenate(x, -1) for x in (o, d, t_max))
    o_t, d_t = torch.tensor(o), torch.tensor(d)
    oc = ps.center.T[:, :, None] - o_t[:, None, :]
    a = (d_t * d_t).sum(0)[None, :]
    h = (d_t[:, None, :] * oc).sum(0)
    c = (oc * oc).sum(0) - (ps.radius * ps.radius)[:, None]
    disc = h * h - a * c
    disc = disc[disc >= 0.0]
    rounded = torch.sqrt(disc.double()).float()
    np.testing.assert_array_equal(np.sqrt(disc.numpy()), rounded.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jnp.sqrt)(jnp.asarray(disc.numpy()))),
        rounded.numpy())
    off = int((torch.sqrt(disc) != rounded).sum())
    with capsys.disabled():
        print(f"\ntorch float32 sqrt: {off} of {disc.numel()} quadric "
              f"discriminants not correctly rounded "
              f"({100 * off / disc.numel():.3f}%)")
    with jax.disable_jit():
        jh, jt, _ = (np.asarray(x) for x in jax_intersect.sphere_hit(
            jnp.asarray(o), jnp.asarray(d), js.center, js.radius, 1e-3,
            jnp.asarray(t_max)))
    ph, pt, _ = intersect.sphere_hit(o_t, d_t, ps.center, ps.radius, 1e-3,
                                     torch.tensor(t_max))
    np.testing.assert_array_equal(ph.numpy(), jh)
    np.testing.assert_array_equal(pt.numpy(), jt)


@pytest.mark.parametrize("override", ["origin", "look_at", "both"])
def test_derive_viewport_overrides_match_jax(override):
    kw = {}
    if override in ("origin", "both"):
        kw["origin"] = (0.3, 1.5, 4.0)
    if override in ("look_at", "both"):
        kw["look_at"] = (0.5, -0.2, -1.0)
    cam = dict(width=24, height=16, origin=(0.0, 1.0, 5.0),
               look_at=(0.0, 0.0, 0.0))
    want = jax_viewport(JaxCamera(**cam), **{k: jnp.asarray(v, jnp.float32)
                                             for k, v in kw.items()})
    got = derive_viewport(CameraConfig(**cam),
                          **{k: torch.tensor(v) for k, v in kw.items()},
                          device="cpu")
    plain = derive_viewport(CameraConfig(**cam), device="cpu")
    for f in ("center", "pixel00", "delta_u", "delta_v", "defocus_u",
              "defocus_v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6)
    assert not torch.equal(got.pixel00, plain.pixel00)


@pytest.mark.parametrize("sort_bounces", [False, True], ids=["unsorted",
                                                             "sorted"])
@pytest.mark.parametrize("morton_order", [False, True], ids=["rows",
                                                             "morton"])
@pytest.mark.parametrize("sky_gradient", [False, True], ids=["grey",
                                                             "gradient"])
def test_trace_with_uniforms_matches_jax_and_oracle(sky_gradient,
                                                    morton_order,
                                                    sort_bounces):
    """The default sphere scene at 24x16, max_depth 3 + 2 roulette
    bounces, one injected uniform array (numpy seed 7): the port against
    JAX (equal stats, the image criterion) and against the numpy oracle
    (rtol = atol = 2e-3, as tests/test_sphere_pathtracer.py)."""
    kw = dict(max_depth=3, rr_bounces=2, sky_gradient=sky_gradient,
              morton_order=morton_order, sort_bounces=sort_bounces)
    js, jl = jax_scene.default_sphere_scene(), jax_scene.sphere_scene_lights()
    n = SPHERE_CAM["width"] * SPHERE_CAM["height"]
    u = host_uniforms(7, n, total_slots(2, 5))
    with jax.disable_jit():
        j_img = jax_pt.trace_image_sample(
            jax_pt.spheres_hit_fn(js), jl, JaxCamera(**SPHERE_CAM),
            JaxRenderConfig(**kw), JaxArrayStream(jnp.asarray(u)),
            return_stats=True)
    p_img = pathtracer.trace_image_sample(
        pathtracer.spheres_hit_fn(scene.default_sphere_scene("cpu")),
        scene.sphere_scene_lights("cpu"), CameraConfig(**SPHERE_CAM),
        RenderConfig(**kw), rng.ArrayStream(torch.tensor(u)),
        return_stats=True)
    np.testing.assert_array_equal(p_img[1].numpy(),
                                  np.asarray(j_img[1]).astype(np.int32))
    a = assert_images_match(p_img[0], j_img[0])
    # trace_with_uniforms is this sample without stats.
    same = pathtracer.trace_with_uniforms(
        pathtracer.spheres_hit_fn(scene.default_sphere_scene("cpu")),
        scene.sphere_scene_lights("cpu"), CameraConfig(**SPHERE_CAM),
        RenderConfig(**kw), torch.tensor(u))
    assert torch.equal(same, p_img[0])
    m = js.materials
    ref = reference_cpu.render_image(
        reference_cpu.OracleScene(*(np.asarray(x) for x in (
            js.center, js.radius, m.albedo, m.specular, m.roughness,
            m.metalness, m.use_spec, jl.position, jl.color, jl.intensity))),
        SPHERE_CAM["width"], SPHERE_CAM["height"], SPHERE_CAM["origin"],
        SPHERE_CAM["look_at"], u, max_depth=3, rr_bounces=2,
        sky_gradient=sky_gradient)
    np.testing.assert_allclose(a, ref, rtol=2e-3, atol=2e-3)
    assert a.mean() > 0.01


def test_random_scene_matches_oracle():
    """random_sphere_scene(12, seed=3) at 16x16, max_depth 4 + 1, against
    the oracle at rtol = atol = 2e-3 (tests/test_sphere_pathtracer.py's
    random-scene case)."""
    js = jax_scene.random_sphere_scene(12, seed=3)
    jl = jax_scene.sphere_scene_lights()
    cam = dict(width=16, height=16, origin=(0.0, 1.0, 4.0),
               look_at=(0.0, 0.0, -1.0))
    u = host_uniforms(11, 256, total_slots(2, 5))
    img = pathtracer.trace_with_uniforms(
        pathtracer.spheres_hit_fn(scene.random_sphere_scene(12, 3, "cpu")),
        scene.sphere_scene_lights("cpu"), CameraConfig(**cam),
        RenderConfig(max_depth=4, rr_bounces=1), torch.tensor(u)).numpy()
    m = js.materials
    ref = reference_cpu.render_image(
        reference_cpu.OracleScene(*(np.asarray(x) for x in (
            js.center, js.radius, m.albedo, m.specular, m.roughness,
            m.metalness, m.use_spec, jl.position, jl.color, jl.intensity))),
        16, 16, cam["origin"], cam["look_at"], u, max_depth=4, rr_bounces=1)
    np.testing.assert_allclose(img, ref, rtol=2e-3, atol=2e-3)


def test_render_key_spp2_matches_jax():
    """``render`` with spp 2 from a threefry key: each sample its own
    ``KeyStream(fold_in(key, s))``, the mean over samples; the port's key
    against ``jax.random.key``, with a camera pose override."""
    cam = dict(width=24, height=16)
    kw = dict(max_depth=2, rr_bounces=1, spp=2)
    pose = dict(origin=(0.2, 0.3, 0.5), look_at=(0.0, 0.0, -2.0))
    with jax.disable_jit():
        j_img = jax_pt.render(
            jax_pt.spheres_hit_fn(jax_scene.default_sphere_scene()),
            jax_scene.sphere_scene_lights(), JaxCamera(**cam),
            JaxRenderConfig(**kw), jax.random.key(5),
            **{k: jnp.asarray(v, jnp.float32) for k, v in pose.items()})
    p_img = pathtracer.render(
        pathtracer.spheres_hit_fn(scene.default_sphere_scene("cpu")),
        scene.sphere_scene_lights("cpu"), CameraConfig(**cam),
        RenderConfig(**kw), rng.key(5, "cpu"),
        **{k: torch.tensor(v) for k, v in pose.items()})
    a = assert_images_match(p_img, j_img)
    assert np.isfinite(a).all() and a.max() > 0.01
    # render_spheres is render over spheres_hit_fn; spp 1 draws from
    # fold_in(key, 0).
    one = pathtracer.render_spheres(
        scene.default_sphere_scene("cpu"), scene.sphere_scene_lights("cpu"),
        CameraConfig(**cam), RenderConfig(max_depth=2, rr_bounces=1),
        rng.key(5, "cpu"))
    with jax.disable_jit():
        j_one = jax_pt.render_spheres(
            jax_scene.default_sphere_scene(), jax_scene.sphere_scene_lights(),
            JaxCamera(**cam), JaxRenderConfig(max_depth=2, rr_bounces=1),
            jax.random.key(5))
    assert_images_match(one, j_one)


@pytest.fixture(scope="module")
def union_case():
    """tests/test_features.py's heterogeneous scene: a red sphere in front
    of a 2-unit cube, in both packages."""
    from srt_tpu.scene import Spheres as JaxSpheres
    rows = [((1, 0, 0), (0.5,) * 3, 0.2, 0.1, True)]
    jsph = JaxSpheres(center=jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32),
                      radius=jnp.asarray([0.5], jnp.float32),
                      materials=jax_scene.make_materials(rows))
    psph = scene.Spheres(center=torch.tensor([[0.0, 0.0, 2.0]]),
                         radius=torch.tensor([0.5]),
                         materials=scene.make_materials(rows, "cpu"))
    jcube = jax_mesh.upload(jax_flatten([jax_procgen.cube(size=2.0)]))
    pcube = mesh.upload(flatten_models([procgen.cube(size=2.0)]),
                        device="cpu")
    pcube128 = mesh.upload(flatten_models([procgen.cube(size=2.0)],
                                          pad_to=128), device="cpu")
    return jsph, psph, jcube, pcube, pcube128


@pytest.mark.parametrize("method", ["dense", "walk"])
def test_union_hit_fn_matches_jax(union_case, method):
    """The nearest hit wins field by field; a missing ``emitted`` counts
    as zeros and a missing ``tri`` as -1, as in JAX."""
    jsph, psph, jcube, pcube, pcube128 = union_case
    j_union = jax_pt.union_hit_fn(jax_pt.spheres_hit_fn(jsph),
                                  jax_mesh.mesh_hit_fn(jcube, method="dense"))
    p_union = pathtracer.union_hit_fn(
        pathtracer.spheres_hit_fn(psph),
        mesh.mesh_hit_fn(pcube128 if method == "walk" else pcube,
                         method=method))
    o = np.asarray([[0, 0, 5], [0.9, 0.9, 5], [0, 3, 5], [0, 0, 1.5]],
                   np.float32).T
    d = np.asarray([[0, 0, -1], [0, 0, -1], [0, 0, -1], [0, 0, 1]],
                   np.float32).T
    for any_hit in (False, True):
        want = j_union(jnp.asarray(o), jnp.asarray(d), 1e-3,
                       jnp.full((4,), jnp.inf), any_hit=any_hit)
        got = p_union(torch.tensor(o), torch.tensor(d), 1e-3,
                      torch.full((4,), float("inf")), any_hit=any_hit)
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   rtol=1e-6)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.normal.numpy(),
                                   np.asarray(want.normal), atol=1e-6)
        for f in scene.MATERIAL_FIELDS:
            np.testing.assert_allclose(
                getattr(got.mat, f).numpy(),
                np.asarray(getattr(want.mat, f)), rtol=1e-6, err_msg=f)
        for f in ("emitted", "tri"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None) == any_hit, f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got.t.numpy()[:2], [2.5, 4.0], rtol=1e-5)
    assert got.hit.numpy().tolist() == [True, True, False, True]


def test_union_image_matches_jax(union_case):
    """A small union image (12x8, two bounces) through the scan."""
    jsph, psph, jcube, pcube, _ = union_case
    cam = dict(width=12, height=8, origin=(0.0, 0.0, 5.0),
               look_at=(0.0, 0.0, 0.0))
    u = host_uniforms(3, 96, total_slots(2, 2))
    kw = dict(max_depth=2, rr_bounces=0)
    with jax.disable_jit():
        j_img = jax_pt.trace_with_uniforms(
            jax_pt.union_hit_fn(jax_pt.spheres_hit_fn(jsph),
                                jax_mesh.mesh_hit_fn(jcube, method="dense")),
            jax_scene.sphere_scene_lights(), JaxCamera(**cam),
            JaxRenderConfig(**kw), jnp.asarray(u))
    p_img = pathtracer.trace_with_uniforms(
        pathtracer.union_hit_fn(pathtracer.spheres_hit_fn(psph),
                                mesh.mesh_hit_fn(pcube, method="dense")),
        scene.sphere_scene_lights("cpu"), CameraConfig(**cam),
        RenderConfig(**kw), torch.tensor(u))
    a = assert_images_match(p_img, j_img)
    assert np.isfinite(a).all() and a.max() > 0.01
