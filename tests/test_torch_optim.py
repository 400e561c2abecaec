"""PyTorch port vs JAX package: the inverse-rendering trainer
(``srt_tpu_torch/optim.py`` against ``srt_tpu/optim.py``).

``float_partition`` must name and order the trainable leaves as JAX's
``keystr`` names them and never train a bool or int leaf;
``clamp_sphere_scene`` must project as JAX's does;
``run_inverse_rendering`` must follow JAX's loss trajectory from the same
start (Adam in both, ``optax.adam``'s defaults; the port's image is the
JAX image to 2.5e-5 for the same key, so the trajectories agree to
float32 reduction order: rtol 1e-3 on each loss, atol 1e-3 on the
parameters, measured 1.7e-4 and 1.1e-4); and gradient descent through the
walk must pull a displaced vertex back (the demo of
``tests/test_mesh_gradients.py``).  JAX's trainer runs compiled, as it
ships.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu import optim as jax_optim
from srt_tpu import scene as jax_scene
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch import optim, scene
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.ops import rng
from srt_tpu_torch.ops.rng import host_uniforms, total_slots
from srt_tpu_torch.scene import model_scene_lights
from tests.test_torch_spheres import sphere_arrays
from tests.test_torch_traversal import port_scene_of

torch.set_num_threads(2)

CAM = dict(width=24, height=16)
CFG = dict(max_depth=2, rr_bounces=0, spp=1)


def jax_start():
    """The JAX sphere scene moved off the truth: red sphere's albedo and
    every roughness."""
    true = jax_scene.default_sphere_scene()
    m = true.materials
    return true.replace(materials=m.replace(
        albedo=m.albedo.at[3].set(jnp.asarray([0.3, 0.6, 0.6])),
        roughness=m.roughness * 1.2))


def jax_paths(params, trainable=None):
    leaves, _ = jax_optim.float_partition(params, trainable)
    with_path, _ = jax.tree_util.tree_flatten_with_path(params)
    ids = {id(x) for x in leaves}
    return sorted(jax.tree_util.keystr(p) for p, x in with_path
                  if id(x) in ids)


def port_paths(params, trainable=None):
    leaves, _ = optim.float_partition(params, trainable)
    ids = {id(x) for x in leaves}
    return sorted(p for p, x in optim._leaves_with_paths(params)
                  if id(x) in ids)


@pytest.mark.parametrize("trainable", [
    None, lambda p, _: "albedo" in p, lambda p, _: p.startswith("[1]")])
def test_float_partition_names_leaves_as_jax(trainable):
    """Spheres and lights in a tuple: the same trainable paths, no bool
    leaf (``use_spec``), and merge puts new leaves where they were."""
    jp = (jax_scene.default_sphere_scene(), jax_scene.sphere_scene_lights())
    pp = (scene.default_sphere_scene("cpu"),
          scene.sphere_scene_lights("cpu"))
    want = jax_paths(jp, trainable)
    assert port_paths(pp, trainable) == want
    assert not any("use_spec" in p for p in want)
    leaves, merge = optim.float_partition(pp, trainable)
    rebuilt = merge([x + 1.0 for x in leaves])
    for (path, new), (_, old) in zip(optim._leaves_with_paths(rebuilt),
                                     optim._leaves_with_paths(pp)):
        moved = path in want
        assert torch.equal(new, old + 1.0 if moved else old), path
    assert rebuilt[0].materials.use_spec.dtype == torch.bool


def test_float_partition_of_a_mesh_scene_skips_ints_and_bools():
    """A ``MeshScene``: the float leaves are JAX's (its static fields and
    int/bool tables are never trained), ``tri_vidx`` and ``tri_mat`` stay
    put."""
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(6, 8)],
                                     pad_to=128))
    ps = port_scene_of(js)
    want = jax_paths(js)
    assert port_paths(ps) == want
    assert ".mat_diffuse" in want and ".tri_vidx" not in want
    assert ".mat_use_texture" not in want
    leaves, merge = optim.float_partition(ps)
    back = merge(leaves)
    assert back.tri_vidx is ps.tri_vidx and back.num_triangles == \
        ps.num_triangles


def test_clamp_sphere_scene_matches_jax():
    rs = np.random.default_rng(4)
    d = sphere_arrays(jax_scene.default_sphere_scene())
    for k in ("albedo", "specular", "roughness", "metalness", "radius"):
        d[k] = rs.uniform(-0.5, 1.5, d[k].shape).astype(np.float32)
    js = jax_scene.default_sphere_scene()
    js = js.replace(radius=jnp.asarray(d["radius"]),
                    materials=js.materials.replace(**{
                        k: jnp.asarray(d[k]) for k in
                        ("albedo", "specular", "roughness", "metalness")}))
    want = sphere_arrays(jax_optim.clamp_sphere_scene(js))
    got = sphere_arrays(optim.clamp_sphere_scene(
        scene.spheres_from_arrays(d, "cpu")))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_run_inverse_rendering_follows_jax():
    """Five fixed-noise Adam steps on the albedo and roughness of the
    sphere scene from the same start, projected by ``clamp_sphere_scene``:
    the port's losses and parameters follow JAX's."""
    cam, cfg = JaxCamera(**CAM), JaxRenderConfig(**CFG)
    lights = jax_scene.sphere_scene_lights()
    key = jax.random.key(0)
    target = jax_pt.render_spheres(jax_scene.default_sphere_scene(), lights,
                                   cam, cfg, key)

    def trainable(p, _):
        return "albedo" in p or "roughness" in p

    want = jax_optim.run_inverse_rendering(
        lambda s, k: jax_pt.render_spheres(s, lights, cam, cfg, k),
        jax_start(), target, key, steps=5, learning_rate=0.02, log_every=0,
        project_fn=jax_optim.clamp_sphere_scene, trainable=trainable,
        fixed_noise=True)

    p_lights = scene.sphere_scene_lights("cpu")
    p_cam, p_cfg = CameraConfig(**CAM), RenderConfig(**CFG)
    start = scene.spheres_from_arrays(sphere_arrays(jax_start()), "cpu")
    p_target = torch.tensor(np.asarray(target))
    steps = []
    got = optim.run_inverse_rendering(
        lambda s, k: pathtracer.render_spheres(s, p_lights, p_cam, p_cfg, k),
        start, p_target, rng.key(0, "cpu"), steps=5, learning_rate=0.02,
        log_every=0, project_fn=optim.clamp_sphere_scene,
        trainable=trainable, fixed_noise=True,
        callback=lambda i, params, loss: steps.append(i))
    assert steps == list(range(5)) and got.steps == 5
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    assert got.losses[-1] < got.losses[0]
    for f in ("albedo", "roughness"):
        np.testing.assert_allclose(
            getattr(got.params.materials, f).numpy(),
            np.asarray(getattr(want.params.materials, f)), atol=1e-3,
            err_msg=f)
    # The start is untouched and the untrained leaves stay where they were.
    assert torch.equal(start.materials.albedo, scene.spheres_from_arrays(
        sphere_arrays(jax_start()), "cpu").materials.albedo)
    assert torch.equal(got.params.center, start.center)


def test_run_inverse_rendering_keys_and_logging(capsys, tmp_path):
    """``fixed_noise=False`` renders step i with ``rng.fold_in(key, i)``,
    ``fixed_noise=True`` with ``key``; ``log_every`` prints; a run
    resumed from a checkpoint path renders its remaining steps with their
    own keys; a caller's loss and optimizer replace the MSE and Adam."""
    key = rng.key(5, "cpu")
    seen = []

    def render_fn(params, k):
        seen.append(k.clone())
        return params[0] * 2.0

    params = (torch.ones(4), torch.zeros(2, dtype=torch.int32))
    res = optim.run_inverse_rendering(render_fn, params, torch.zeros(4), key,
                                      steps=3, log_every=2)
    assert [torch.equal(k, rng.fold_in(key, i)) for i, k in
            enumerate(seen)] == [True] * 3
    assert res.params[1] is params[1] and torch.equal(params[0],
                                                      torch.ones(4))
    assert float(res.params[0][0]) < 1.0
    out = capsys.readouterr().out
    assert "step 0:" in out and "step 2:" in out and "step 1:" not in out
    seen.clear()
    optim.run_inverse_rendering(render_fn, params, torch.zeros(4), key,
                                steps=2, log_every=0, fixed_noise=True)
    assert all(torch.equal(k, key) for k in seen)
    path = str(tmp_path / "ckpt.npz")
    optim.run_inverse_rendering(render_fn, params, torch.zeros(4), key,
                                steps=2, log_every=0, checkpoint_path=path)
    seen.clear()
    res = optim.run_inverse_rendering(render_fn, params, torch.zeros(4), key,
                                      steps=3, log_every=0,
                                      checkpoint_path=path)
    assert len(seen) == 1 and torch.equal(seen[0], rng.fold_in(key, 2))
    assert len(res.losses) == 1 and res.steps == 3
    # A loss and an optimizer of the caller's: one SGD step of 0.25 on
    # sum(2p) moves each entry by 0.5.
    res = optim.run_inverse_rendering(
        render_fn, params, torch.zeros(4), key, steps=1, log_every=0,
        loss_fn=lambda p, target, k: render_fn(p, k).sum(),
        optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.25))
    assert torch.equal(res.params[0], torch.full((4,), 0.5))
    assert res.losses == [8.0]


def test_inverse_rendering_recovers_perturbed_vertex():
    """Gradient descent through the walk (30 Adam steps at 2e-2 on the
    shared vertices) pulls a displaced vertex back toward the pose that
    made the target, as ``tests/test_mesh_gradients.py`` asks of JAX."""
    ps = port_scene_of(jax_mesh.upload(jax_flatten(
        [jax_procgen.uv_sphere(6, 8, radius=1.0)], pad_to=128)))
    lights = model_scene_lights("cpu")
    cam = CameraConfig(width=12, height=10, origin=(0.0, 0.5, 4.0),
                       look_at=(0.0, 0.0, 0.0))
    cfg = RenderConfig(max_depth=2, rr_bounces=0)
    u = torch.tensor(host_uniforms(7, 120, total_slots(6, 2)))

    def render_fn(positions, _key):
        return pathtracer.trace_with_uniforms(
            mesh.mesh_hit_fn(mesh.with_positions(ps, positions)), lights,
            cam, cfg, u)

    target = render_fn(ps.positions, None)
    vi = int(torch.argmax(ps.positions @ torch.tensor([0.0, 0.2, 1.0])))
    p0 = ps.positions.clone()
    p0[vi] += torch.tensor([0.05, -0.04, 0.06])
    l0 = float(((render_fn(p0, None) - target) ** 2).mean())
    res = optim.run_inverse_rendering(render_fn, p0, target, None, steps=30,
                                      learning_rate=2e-2, log_every=0,
                                      fixed_noise=True)
    err0 = float((p0[vi] - ps.positions[vi]).norm())
    err1 = float((res.params[vi] - ps.positions[vi]).norm())
    assert res.losses[0] == pytest.approx(l0, rel=1e-6)
    assert res.losses[-1] < 0.3 * l0, (l0, res.losses[-1])
    assert err1 < 0.6 * err0, (err0, err1)
