"""PyTorch port vs JAX package: the threefry ``KeyStream`` / ``SlotBlock``
bit for bit, and the render plan of a streamed scene frame for frame from
one key.

The port's ``key``, ``fold_in``, ``KeyStream.take`` and
``SlotBlock.full``/``rows_at`` must equal ``jax.random.key_data``,
``jax.random.fold_in`` and the JAX package's ``KeyStream`` exactly (JAX's
default partitionable threefry layout), for seeds, counters and block
shapes including column counts that are not multiples of 128."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.config import CameraConfig as JaxCamera
from srt_tpu.config import RenderConfig as JaxRenderConfig
from srt_tpu.models import fastpath as jax_fastpath
from srt_tpu.models import mesh as jax_mesh
from srt_tpu.ops import rng as jax_rng
from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu.scene import model_scene_lights as jax_lights
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import fastpath
from srt_tpu_torch.ops import rng, traversal
from srt_tpu_torch.scene import lights_from_arrays
from tests.test_torch_traversal import exact_reciprocal  # noqa: F401
from tests.test_torch_traversal import port_scene_of

torch.set_num_threads(2)

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 + 5]


def bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    k = rng.key(seed, "cpu")
    jk = jax.random.key(seed)
    np.testing.assert_array_equal(k.numpy(), jax.random.key_data(jk))
    for data in (0, 1, 7, 123456789, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            rng.fold_in(k, data).numpy(),
            jax.random.key_data(jax.random.fold_in(jk, data)))
    with pytest.raises(ValueError, match="uint32"):
        rng.fold_in(k, 2 ** 32)


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("n", [128, 1000])
def test_key_stream_matches_jax(seed, n):
    """Successive ``take`` / ``take_block`` calls consume one counter each,
    as the JAX stream does; blocks are bit-equal, ``rows_at`` too."""
    ks = rng.KeyStream(rng.key(seed, "cpu"), n)
    jks = jax_rng.KeyStream(jax.random.key(seed), n)
    for k in (2, 18):
        np.testing.assert_array_equal(bits(ks.take(k)), bits(jks.take(k)))
    blk, jblk = ks.take_block(14), jks.take_block(14)
    full = blk.full()
    np.testing.assert_array_equal(bits(full), bits(jblk.full()))
    assert full.dtype == torch.float32 and 0.0 <= float(full.min())
    assert float(full.max()) < 1.0
    cols = np.random.default_rng(seed % 97).integers(0, n, 300)
    for lo, hi in ((0, 14), (6, 11)):
        got = blk.rows_at(lo, hi, torch.as_tensor(cols))
        np.testing.assert_array_equal(
            bits(got), bits(jblk.rows_at(lo, hi, jnp.asarray(cols,
                                                             jnp.int32))))
        np.testing.assert_array_equal(bits(got), bits(full[lo:hi][:, cols]))


def test_threefry_checks_and_launches_nothing_on_cpu():
    traversal.reset_launch_counts()
    k = rng.key(3, "cpu")
    rng.KeyStream(k, 64).take_block(4).rows_at(1, 3, torch.arange(5))
    assert traversal.launch_counts["threefry"] == 0
    with pytest.raises(TypeError, match="int64 tensor of 2"):
        rng.threefry(k.to(torch.int32), 0, 1, 4)
    with pytest.raises(ValueError, match="uint32 lattice"):
        rng.SlotBlock(k, 2 ** 16, 2 ** 16)


@pytest.fixture
def streamed_scene(exact_reciprocal, monkeypatch):
    """uv_sphere(50, 170): 131 clusters (not a multiple of 16), 9
    superclusters, so both plans take the compacted default walk
    schedule; both packages' stream thresholds are lowered below 131."""
    monkeypatch.setattr(traversal, "STREAM_THRESHOLD_CLUSTERS", 100)
    monkeypatch.setattr(jax_tp, "STREAM_THRESHOLD_CLUSTERS", 100)
    js = jax_mesh.upload(jax_flatten([jax_procgen.uv_sphere(50, 170)],
                                     pad_to=128))
    assert js.woop.shape[0] == 131
    jl = jax_lights()
    pl = lights_from_arrays({k: np.asarray(getattr(jl, k))
                             for k in ("position", "color", "intensity")},
                            "cpu")
    return js, port_scene_of(js), jl, pl


def test_render_plan_matches_jax_for_one_key(streamed_scene, monkeypatch):
    """The slice as a whole: ``make_render_plan(...).render(key)`` in both
    packages, 32x32, two bounces, streamed walks, probed with key 0 and
    rendered with key 3.  Schedules and stats must be equal; pixels
    allclose (rtol 1e-4, atol 1e-5) on >= 99.5% of the image (an ulp can
    flip a lobe choice; see tests/test_torch_render.py)."""
    js, ps, jl, pl = streamed_scene
    cam = dict(width=32, height=32, origin=(0.0, 1.0, 5.0),
               look_at=(0.0, 0.0, 0.0))
    kw = dict(max_depth=2, rr_bounces=0, spp=1)
    j_plan = jax_fastpath.make_render_plan(js, jl, JaxCamera(**cam),
                                           JaxRenderConfig(**kw),
                                           method="pallas")
    j_img, j_st, j_ov = j_plan.render(jax.random.key(3))
    calls = []
    for name in ("intersect", "intersect_stream", "pgwalk2",
                 "pgwalk2_stream"):
        def spy(*a, _fn=getattr(traversal, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(traversal, name, spy)
    p_plan = fastpath.make_render_plan(ps, pl, CameraConfig(**cam),
                                       RenderConfig(**kw))
    p_img, p_st, p_ov = p_plan.render(rng.key(3, "cpu"))
    assert set(calls) == {"intersect_stream", "pgwalk2_stream"}
    assert p_plan.schedule == j_plan.schedule
    assert int(j_ov) == int(p_ov) == 0
    np.testing.assert_array_equal(p_st.numpy(), np.asarray(j_st))
    a, b = p_img.numpy(), np.asarray(j_img)
    assert a.shape == b.shape == (32, 32, 3)
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.995, \
        f"outlier pixels {np.argwhere(~close).tolist()}"
    assert a.mean() > 0.01
