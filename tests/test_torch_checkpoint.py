"""PyTorch port vs JAX package: checkpoints and the trainer's resume
(``srt_tpu_torch/utils/checkpoint.py`` and
``optim.run_inverse_rendering(checkpoint_path=...)`` against
``srt_tpu/utils/checkpoint.py`` and ``srt_tpu/optim.py``).

Checkpoint files are npz in both packages with the same leaf order, so
each package reads the other's.  A resumed port run equals an
uninterrupted one bit for bit (the leaves and the optimizer state are
restored exactly; the CPU renders are deterministic).  Its losses follow
JAX's resumed run at ``tests/test_torch_optim.py``'s rtol 1e-3 (the
images agree to float32 reduction order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu import optim as jax_optim
from srt_tpu import scene as jax_scene
from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import pathtracer as jax_pt
from srt_tpu.utils import checkpoint as jax_ckpt
from srt_tpu_torch import optim, scene
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import pathtracer
from srt_tpu_torch.ops import rng
from srt_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_spheres import sphere_arrays

torch.set_num_threads(2)

TREE = {"a": np.arange(6.0, dtype=np.float32).reshape(2, 3),
        "b": (np.zeros(3, np.float32), np.ones((2, 2), np.float32)),
        "c": np.array([1, 4, 9], np.int32)}


def port_tree():
    return {"a": torch.tensor(TREE["a"]),
            "b": tuple(torch.tensor(x) for x in TREE["b"]),
            "c": torch.tensor(TREE["c"])}


def assert_tree_equal(got):
    assert torch.equal(got["a"], torch.tensor(TREE["a"]))
    assert all(torch.equal(x, torch.tensor(y))
               for x, y in zip(got["b"], TREE["b"]))
    assert torch.equal(got["c"], torch.tensor(TREE["c"]))
    assert isinstance(got["b"], tuple)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_checkpoint_roundtrip(tmp_path, mode):
    """``tests/test_optim_app.py``'s round trips (``save`` and
    ``save_async``) on the port, and the files of the two packages read
    by each other (same leaf order, same meta)."""
    path = str(tmp_path / "t.npz")
    tree = port_tree()
    if mode == "sync":
        ckpt.save(path, tree, extra={"step": 7})
    else:
        fut = ckpt.save_async(path, tree, extra={"step": 7})
        tree["a"].add_(1.0)                   # the snapshot was taken
        fut.result()
    leaves, extra = ckpt.load(path)
    assert extra == {"step": 7}
    assert_tree_equal(ckpt.restore_into(port_tree(), leaves))
    assert ckpt.load(str(tmp_path / "missing.npz")) is None

    # JAX reads the port's file, and the port JAX's.
    jtree = {"a": jnp.asarray(TREE["a"]),
             "b": tuple(jnp.asarray(x) for x in TREE["b"]),
             "c": jnp.asarray(TREE["c"])}
    j_leaves, j_extra = jax_ckpt.load(path)
    restored = jax_ckpt.restore_into(jtree, j_leaves)
    assert j_extra == extra
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(jtree)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jpath = str(tmp_path / "j.npz")
    jax_ckpt.save(jpath, jtree, extra={"step": 7})
    leaves, extra = ckpt.load(jpath)
    assert extra == {"step": 7}
    assert_tree_equal(ckpt.restore_into(port_tree(), leaves))
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_into({"a": tree["a"]}, leaves)


def test_train_state_restores_the_optimizer_exactly(tmp_path):
    """``save_train_state`` / ``restore_train_state`` of Adam after three
    steps: every state tensor bit for bit (``step`` included), the
    resuming optimizer's hyperparameters kept, and the next step equal to
    the uninterrupted optimizer's."""
    torch.manual_seed(0)
    w = [torch.randn(5, requires_grad=True), torch.randn(2, 3,
                                                         requires_grad=True)]
    opt = torch.optim.Adam(w, lr=0.05)

    def step(leaves, optimizer):
        optimizer.zero_grad()
        sum((x ** 3).sum() for x in leaves).backward()
        optimizer.step()

    for _ in range(3):
        step(w, opt)
    path = str(tmp_path / "train.npz")
    ckpt.save_train_state(path, w, opt.state_dict(), 3)

    fresh = [torch.zeros(5, requires_grad=True),
             torch.zeros(2, 3, requires_grad=True)]
    opt2 = torch.optim.Adam(fresh, lr=0.05)
    params, state, at = ckpt.restore_train_state(ckpt.load(path), fresh,
                                                 opt2.state_dict())
    assert at == 3 and isinstance(params, list)
    with torch.no_grad():
        for leaf, x in zip(fresh, params):
            leaf.copy_(x)
    opt2.load_state_dict(state)
    want, got = opt.state_dict(), opt2.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i in want["state"]:
        for k, v in want["state"][i].items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    step(w, opt)
    step(fresh, opt2)
    assert all(torch.equal(a, b) for a, b in zip(w, fresh))


CAM = dict(width=24, height=16)
CFG = dict(max_depth=2, rr_bounces=0, spp=1)


def trainer_case():
    """The JAX test's trainer (``tests/test_optim_app.py::test_inverse_
    rendering_recovers_albedo``) in both packages: the red sphere's albedo
    from a moved start, fixed noise, clamped."""
    lights = jax_scene.sphere_scene_lights()
    true = jax_scene.default_sphere_scene()
    key = jax.random.key(0)
    target = jax_pt.render_spheres(true, lights, JaxCamera(**CAM),
                                   JaxRenderConfig(**CFG), key)
    start = true.replace(materials=true.materials.replace(
        albedo=true.materials.albedo.at[3].set(jnp.asarray([0.3, 0.6,
                                                            0.6]))))

    def jax_run(path, steps, every=20):
        return jax_optim.run_inverse_rendering(
            lambda s, k: jax_pt.render_spheres(s, lights, JaxCamera(**CAM),
                                               JaxRenderConfig(**CFG), k),
            start, target, key, steps=steps, learning_rate=0.05,
            log_every=0, project_fn=jax_optim.clamp_sphere_scene,
            fixed_noise=True, trainable=lambda p, _: "albedo" in p,
            checkpoint_path=path, checkpoint_every=every)

    p_lights = scene.sphere_scene_lights("cpu")
    p_start = scene.spheres_from_arrays(sphere_arrays(start), "cpu")
    p_target = torch.tensor(np.asarray(target))

    def port_run(path, steps, every=20):
        return optim.run_inverse_rendering(
            lambda s, k: pathtracer.render_spheres(
                s, p_lights, CameraConfig(**CAM), RenderConfig(**CFG), k),
            p_start, p_target, rng.key(0, "cpu"), steps=steps,
            learning_rate=0.05, log_every=0,
            project_fn=optim.clamp_sphere_scene, fixed_noise=True,
            trainable=lambda p, _: "albedo" in p, checkpoint_path=path,
            checkpoint_every=every)

    return jax_run, port_run, np.asarray(true.materials.albedo)[3]


def test_resumed_training_equals_uninterrupted(tmp_path):
    """20 steps, then a resume to 40, equals 40 straight bit for bit
    (losses and parameters); a finished run resumes to no step; the
    losses follow JAX's resumed run (rtol 1e-3) and recover the albedo as
    JAX's test asks."""
    jax_run, port_run, true_albedo = trainer_case()
    straight = port_run(None, 40)
    first = port_run(str(tmp_path / "p.npz"), 20)
    second = port_run(str(tmp_path / "p.npz"), 40)
    assert len(first.losses) == len(second.losses) == 20
    assert first.losses + second.losses == straight.losses
    assert torch.equal(second.params.materials.albedo,
                       straight.params.materials.albedo)
    assert second.steps == 40
    assert ckpt.load(str(tmp_path / "p.npz"))[1]["step"] == 40
    done = port_run(str(tmp_path / "p.npz"), 40)
    assert done.losses == [] and torch.equal(
        done.params.materials.albedo, straight.params.materials.albedo)

    j_first = jax_run(str(tmp_path / "j.npz"), 20)
    j_second = jax_run(str(tmp_path / "j.npz"), 40)
    np.testing.assert_allclose(first.losses + second.losses,
                               j_first.losses + j_second.losses, rtol=1e-3)
    assert straight.losses[-1] < straight.losses[0] * 0.25
    rec = straight.params.materials.albedo[3].numpy()
    assert np.abs(rec - true_albedo).max() < 0.25
