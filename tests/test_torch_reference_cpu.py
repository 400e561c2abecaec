"""PyTorch port vs JAX package: the numpy oracle and ``rng.split``.

``srt_tpu_torch/models/reference_cpu.py`` is a copy of
``srt_tpu/models/reference_cpu.py`` (plain numpy, unchanged in
behaviour), so both oracles are held bit for bit on the same inputs:
``render_image`` on two sphere scenes from ``host_uniforms``, and
``trace`` on a few hundred random rays with each sky option.
``rng.split`` is held bit for bit against ``jax.random.split`` (the
partitionable threefry layout, JAX's default, which this test asserts).
"""

import itertools

import jax
import numpy as np
import pytest

from srt_tpu.models import reference_cpu as jax_oracle
from srt_tpu_torch.models import reference_cpu as oracle
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import default_sphere_scene, random_sphere_scene
from srt_tpu_torch.scene import sphere_scene_lights


def _scene_arrays(name):
    spheres = (default_sphere_scene("cpu") if name == "default"
               else random_sphere_scene(6, seed=4, device="cpu"))
    lights = sphere_scene_lights("cpu")
    m = spheres.materials
    return tuple(x.numpy() for x in (
        spheres.center, spheres.radius, m.albedo, m.specular, m.roughness,
        m.metalness, m.use_spec, lights.position, lights.color,
        lights.intensity))


@pytest.mark.parametrize(
    "size,seed,max_depth,rr_bounces",
    list(itertools.product(((16, 12), (20, 16)), (0, 1), (2, 5), (0, 3))))
def test_render_image_equals_jax_oracle(size, seed, max_depth, rr_bounces):
    arrays = _scene_arrays("default" if seed == 0 else "random")
    w, h = size
    n_slots = rng.total_slots(2, max_depth + rr_bounces)
    u = rng.host_uniforms(seed, w * h, n_slots)
    kw = dict(max_depth=max_depth, rr_bounces=rr_bounces)
    got = oracle.render_image(oracle.OracleScene(*arrays), w, h,
                              (0.0, 0.0, 0.0), (0.0, 0.0, -1.0), u, **kw)
    want = jax_oracle.render_image(jax_oracle.OracleScene(*arrays), w, h,
                                   (0.0, 0.0, 0.0), (0.0, 0.0, -1.0), u, **kw)
    assert got.shape == (h, w, 3)
    assert np.isfinite(got).all() and got.max() > 0.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sky", [dict(), dict(sky_gradient=True,
                                              sky_always=False)])
def test_trace_equals_jax_oracle(sky):
    arrays = _scene_arrays("random")
    gen = np.random.default_rng(9)
    n = 300
    o = np.zeros((n, 3), np.float32)
    d = gen.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    u = gen.uniform(size=(n, 4 * rng.bounce_slots(2))).astype(np.float32)
    got = oracle.trace(oracle.OracleScene(*arrays), o, d, u, max_depth=2,
                       rr_bounces=2, **sky)
    want = jax_oracle.trace(jax_oracle.OracleScene(*arrays), o, d, u,
                            max_depth=2, rr_bounces=2, **sky)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [1, 2, 16])
def test_split_equals_jax(num):
    assert jax.config.jax_threefry_partitionable
    for seed in (0, 11, 123456789, 2 ** 32 - 1):
        for data in (None, 7):
            k = jax.random.key(seed)
            key = rng.key(seed, "cpu")
            if data is not None:
                k = jax.random.fold_in(k, data)
                key = rng.fold_in(key, data)
            want = np.asarray(jax.random.key_data(jax.random.split(k, num)))
            got = rng.split(key, num)
            assert tuple(got.shape) == (num, 2)
            np.testing.assert_array_equal(got.numpy(),
                                          want.astype(np.int64))
