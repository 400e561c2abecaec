"""PyTorch port vs JAX package: the host runtime (``utils/native.py``,
``csrc/srt_native.cpp``), the C++ BVH builder.

The port's C++ builder must give the JAX package's numpy tree array for
array (and, where JAX's own library builds, JAX's C++ tree), and
``flatten_models`` through it JAX's scene; ``build_bvh`` must dispatch as
JAX's does.  The library builds with the host C++ compiler; the tests skip
only where none is on ``PATH``."""

import dataclasses
import os

import numpy as np
import pytest

from srt_tpu.utils import bvh as jax_bvh
from srt_tpu.utils import native as jax_native
from srt_tpu.utils import procgen as jax_procgen
from srt_tpu.utils.flatten import flatten_models as jax_flatten
from srt_tpu_torch.utils import bvh, native, procgen
from srt_tpu_torch.utils.flatten import FlatScene, flatten_models

BVH_FIELDS = ("node_min", "node_max", "node_first", "node_count",
              "prim_order")


@pytest.fixture
def cxx(monkeypatch):
    """The native paths on: skip without a C++ compiler, and clear
    ``SRT_NO_NATIVE``."""
    if native._compiler() is None:
        pytest.skip("no C++ compiler (g++ or c++) on PATH")
    monkeypatch.delenv("SRT_NO_NATIVE", raising=False)


def tri_inputs(mesh):
    v0, v1, v2 = (mesh.positions[mesh.tri_vidx[:, i]] for i in range(3))
    return ((v0 + v1 + v2) / 3.0, np.minimum(np.minimum(v0, v1), v2),
            np.maximum(np.maximum(v0, v1), v2))


def box_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return (lo + hi) * 0.5, lo, hi


def equal_centres(n=40):
    c = np.full((n, 3), 0.25, np.float32)
    return c, c - 1, c + 1


BVH_INPUTS = {
    "sphere40x60": lambda: tri_inputs(procgen.uv_sphere(40, 60)),
    "sphere80x120": lambda: tri_inputs(procgen.uv_sphere(80, 120)),
    "boxes": lambda: box_inputs(3000),
    "equal_centres": equal_centres,
    "n1": lambda: box_inputs(1, 1),
    "n2": lambda: box_inputs(2, 2),
}


def assert_bvh_equal(got, ref):
    for f in BVH_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("leaf_size", [1, 2, 4])
@pytest.mark.parametrize("inputs", list(BVH_INPUTS))
def test_native_bvh_matches_jax(cxx, inputs, leaf_size):
    """The port's C++ builder against JAX's numpy builder, bit for bit,
    and against JAX's C++ builder where that builds."""
    centers, bmin, bmax = BVH_INPUTS[inputs]()
    got = native.build_bvh_native(centers, bmin, bmax, leaf_size)
    assert_bvh_equal(got, jax_bvh.build_bvh(centers, bmin, bmax, leaf_size,
                                            use_native="never"))
    if inputs == "equal_centres":
        assert got.num_nodes == 1 and int(got.node_count[0]) == len(centers)
    if jax_native.available():
        assert_bvh_equal(got, jax_native.build_bvh_native(centers, bmin,
                                                          bmax, leaf_size))


def test_native_bvh_rejects_mismatched_shapes(cxx):
    """Boxes that are not [T, 3] like the centres never reach the C++
    builder."""
    centers, bmin, bmax = box_inputs(8)
    for args in ((centers, bmin[:4], bmax), (centers, bmin, bmax[:, :2])):
        with pytest.raises(ValueError, match=r"\[T, 3\]"):
            native.build_bvh_native(*args)


@pytest.fixture
def spy(monkeypatch):
    """The primitive counts of ``native.build_bvh_native``'s calls that
    returned a tree."""
    calls = []

    def wrapped(*args, _fn=native.build_bvh_native):
        out = _fn(*args)
        if out is not None:
            calls.append(len(args[0]))
        return out
    monkeypatch.setattr(native, "build_bvh_native", wrapped)
    return calls


FLAT_SCENES = {
    # name: (models, leaf_size, pad_to)
    "sphere40x60": (lambda p: [p.uv_sphere(40, 60)], 2, 1),
    "rubik+sphere80x120": (lambda p: [p.rubik_grid(), p.uv_sphere(80, 120)],
                           2, 128),
    "sphere40x60+cube": (lambda p: [p.uv_sphere(40, 60), p.cube()], 4, 1),
}


@pytest.mark.parametrize("name", list(FLAT_SCENES))
def test_flatten_through_native_matches_jax(cxx, spy, name):
    """``flatten_models`` takes the C++ builder for each model of 1,024 or
    more triangles (the numpy one for the rest) and gives JAX's scene,
    every array equal."""
    models, leaf_size, pad_to = FLAT_SCENES[name]
    got = flatten_models(models(procgen), leaf_size=leaf_size, pad_to=pad_to)
    ref = jax_flatten(models(jax_procgen), leaf_size=leaf_size,
                      pad_to=pad_to)
    assert spy and all(n >= bvh.NATIVE_MIN_PRIMS for n in spy)
    assert len(spy) == sum(m.num_triangles >= bvh.NATIVE_MIN_PRIMS
                           for m in models(procgen))
    for f in dataclasses.fields(FlatScene):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name


@pytest.mark.parametrize("case", ["auto_1024", "auto_1023", "never_1024",
                                  "no_native_env", "no_compiler"])
def test_dispatch(cxx, spy, monkeypatch, tmp_path, case):
    """``build_bvh``: "auto" takes the C++ builder at 1,024 primitives and
    more, numpy below and with "never"; ``SRT_NO_NATIVE`` or no compiler
    on ``PATH`` makes ``available()`` False and "auto" take numpy, never
    touching the library.  The trees are the numpy builder's either
    way."""
    n = 1023 if case == "auto_1023" else 1024
    use_native = "never" if case == "never_1024" else "auto"
    if case == "no_native_env":
        monkeypatch.setenv("SRT_NO_NATIVE", "1")
    if case == "no_compiler":
        monkeypatch.setenv("PATH", str(tmp_path))
    if case in ("no_native_env", "no_compiler"):
        assert not native.available()
        monkeypatch.setattr(native, "load", lambda: pytest.fail("built"))
    centers, bmin, bmax = box_inputs(n, 3)
    got = bvh.build_bvh(centers, bmin, bmax, use_native=use_native)
    assert_bvh_equal(got, bvh.build_bvh(centers, bmin, bmax,
                                        use_native="never"))
    assert spy == ([1024] if case == "auto_1024" else [])


def test_failed_build_raises(cxx, monkeypatch, tmp_path):
    """With a compiler present, a source that does not compile raises
    from ``build_bvh``: no quiet fallback to numpy."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load.cache_clear()
    try:
        centers, bmin, bmax = box_inputs(1024, 4)
        with pytest.raises(RuntimeError, match="failed"):
            bvh.build_bvh(centers, bmin, bmax)
        assert not [p for p in os.listdir(tmp_path / "build")
                    if p.endswith(".so") or ".tmp" in p]
    finally:
        native.load.cache_clear()
