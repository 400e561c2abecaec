"""K1 and K2 of ``srt_tpu_torch/tools/micro_occ.py`` (the port of
``tools/micro_occ.py``'s two Pallas kernels) on the CPU: their plain
versions against JAX's kernels and against B1's culled lists.

JAX's tool exits at import off the TPU and benchmarks at module level, so
its ``make_cf`` is taken from the source with ``ast`` and run in Pallas
interpret mode.  Its ``run`` passes one operand to a kernel of two inputs
(``def run(rcf)``, ``)(rcf)``: the ``bounds`` operand is missing, so on
the TPU v4 only ever printed FAILED); the test adds ``bounds`` to both,
which is the only change made to the extracted code.
"""

import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from srt_tpu_torch.ops import traversal
from srt_tpu_torch.tools import micro_occ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS, BOXES = 4096, 10


class _AddBounds(ast.NodeTransformer):
    """``def run(rcf)`` -> ``def run(rcf, bounds)``; the pallas_call's
    ``)(rcf)`` -> ``)(rcf, bounds)``."""

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        if node.name == "run":
            node.args.args.append(ast.arg(arg="bounds"))
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        inner = node.func
        if (isinstance(inner, ast.Call)
                and getattr(inner.func, "attr", None) == "pallas_call"):
            node.args.append(ast.Name(id="bounds", ctx=ast.Load()))
        return node


@functools.lru_cache(maxsize=None)
def jax_make_cf(n: int, c: int):
    """JAX's ``make_cf`` from tools/micro_occ.py, for n rays and c boxes,
    with its pallas_call in interpret mode and the bounds operand
    passed."""
    src = open(os.path.join(ROOT, "tools", "micro_occ.py")).read()
    fn = next(node for node in ast.parse(src).body
              if isinstance(node, ast.FunctionDef) and node.name == "make_cf")
    module = ast.fix_missing_locations(
        ast.Module(body=[_AddBounds().visit(fn)], type_ignores=[]))
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    env = dict(N=n, C=c, jax=jax, jnp=jnp, pl=interp, pltpu=pltpu)
    exec(compile(module, "tools/micro_occ.py", "exec"), env)
    return env["make_cf"]


def port_occupancy(rays_cf, bounds, tile, g):
    return micro_occ.occupancy_cf(torch.as_tensor(rays_cf),
                                  torch.as_tensor(bounds), tile, g).numpy()


def test_add_one_plain_is_x_plus_one():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 128))
                        .astype(np.float32))
    np.testing.assert_array_equal(micro_occ.add_one_plain(x).numpy(),
                                  x.numpy() + np.float32(1.0))
    # On a CPU tensor the wrapper runs the plain version.
    assert torch.equal(micro_occ.add_one(x), micro_occ.add_one_plain(x))


@pytest.mark.parametrize("tile,g", [(8, 1), (8, 8), (512, 1), (512, 8)])
def test_occupancy_matches_jax_on_mixed_data(tile, g):
    """Mixed occupancy (20-80% ones), with rays that start inside their
    box: K2's plain version equals JAX's kernel exactly."""
    rays_cf, bounds = micro_occ.mixed_data(N_RAYS, BOXES, tile, seed=tile)
    want = np.asarray(jax_make_cf(N_RAYS, BOXES)(g, tile)(
        jnp.asarray(rays_cf), jnp.asarray(bounds)))
    got = port_occupancy(rays_cf, bounds, tile, g)
    assert 0.2 <= got.mean() <= 0.8, got.mean()
    assert got.dtype == np.int32 and got.shape == (N_RAYS // tile, BOXES)
    np.testing.assert_array_equal(got, want)


def test_occupancy_matches_jax_on_its_own_data():
    """JAX's tool's own data (normal draws, in its order): equal to JAX's
    kernel."""
    _, rays_cf, bounds = micro_occ.own_data(N_RAYS, BOXES, 0)
    want = np.asarray(jax_make_cf(N_RAYS, BOXES)(8, 512)(
        jnp.asarray(rays_cf), jnp.asarray(bounds)))
    got = port_occupancy(rays_cf, bounds, 512, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", [8, 32, 512])
def test_occupancy_matches_b1_lists(tile):
    """K2 against B1's per-tile lists (``traversal.cull_plain``) on the
    same rays.  The predicates differ only for a ray that starts inside a
    box (t_near < 0 <= t_far): K2 then compares the exit t_far with
    t_max, B1 the entry max(t_near, 0) = 0.  Rays that start outside every
    box (``inside=0``) make the two the same test."""
    rays_cf, bounds = micro_occ.mixed_data(N_RAYS, BOXES, tile, seed=7,
                                           inside=0.0)
    got = port_occupancy(rays_cf, bounds, tile, 1)
    clist, _, counts = traversal.cull_plain(
        torch.as_tensor(np.ascontiguousarray(rays_cf.T)),
        torch.as_tensor(bounds), tile)
    listed = np.zeros_like(got)
    for t, (row, k) in enumerate(zip(clist.numpy(), counts[:, 0].numpy())):
        listed[t, row[:k]] = 1
    assert 0.2 <= got.mean() <= 0.8
    np.testing.assert_array_equal(got, listed)


def test_occupancy_does_not_depend_on_g_and_checks_shapes():
    rays_cf, bounds = micro_occ.mixed_data(N_RAYS, BOXES, 32, seed=3)
    r, b = torch.as_tensor(rays_cf), torch.as_tensor(bounds)
    ref = micro_occ.occupancy_cf(r, b, 32, 1)
    for g in (2, 16, 128):
        assert torch.equal(micro_occ.occupancy_cf(r, b, 32, g), ref)
    with pytest.raises(ValueError):
        micro_occ.occupancy_cf(r, b, 32, 3)          # 128 tiles, g = 3
    with pytest.raises(ValueError):
        micro_occ.occupancy_cf(r[:7], b, 32)         # not [8, N]
    with pytest.raises(ValueError):
        micro_occ.occupancy_cf(r, torch.zeros((8, 33)), 32)


def test_micro_occ_run_on_cpu():
    """Every variant's record, with finite positive wall times; device
    times are not measured on the CPU."""
    recs = micro_occ.run("cpu", n=8192, c=BOXES, tile=512, groups=(8, 16),
                         reps=1, verbose=False, launch_reps=2)
    assert [r["variant"] for r in recs] == ["v0", "v0b", "v0c", "v1"] + \
        ["v4"] * 4
    for r in recs:
        assert np.isfinite(r["ms"]) and r["ms"] > 0
        assert r["device_ms"] is None and r["device"] == "cpu"
    for r in recs[0], recs[2], recs[3]:         # v0, v0c, v1
        assert np.isfinite(r["us_a_launch"]) and r["us_a_launch"] > 0
    mixed = [r["ones"] for r in recs if r.get("data") == "mixed"]
    assert all(0.2 <= x <= 0.8 for x in mixed)


@pytest.mark.parametrize("tile", [1, 6, 8, 32, 48, 128, 384, 512, 600, 4096])
@pytest.mark.parametrize("n_tiles,sms", [(1, 132), (17, 132), (64, 132),
                                         (4096, 132), (32768, 132),
                                         (4096, 8)])
def test_occupancy_launch_gives_each_tile_to_one_block(tile, n_tiles, sms):
    """Block b takes tiles [b k, (b + 1) k): every tile is in exactly one
    block and no block splits a tile; a block of several tiles covers them
    in one pass of its threads, as the kernel requires."""
    blocks, threads, k = micro_occ.occupancy_launch(n_tiles * tile, tile,
                                                    sms)
    rays = micro_occ.OCC_RAYS
    assert 1 <= k <= 512 and blocks * k >= n_tiles > (blocks - 1) * k
    assert threads % 32 == 0 and 32 <= threads <= micro_occ.OCC_MAX_THREADS
    assert k == 1 or k * tile <= threads * rays
    if tile <= micro_occ.OCC_BLOCK_RAYS:
        assert threads * rays < k * tile + 32 * rays


def test_occupancy_launch_fills_the_card_and_ignores_g(monkeypatch):
    """At the tool's shape the grid has at least 2 blocks an SM; the
    wrapper passes the same launch for every g (the launch is recorded
    with the card's path forced on CPU tensors)."""
    blocks, threads, k = micro_occ.occupancy_launch(262144, 512, 132)
    assert blocks >= 264 and (blocks, threads, k) == (512, 128, 1)
    for tile, n in ((8, 262144), (48, 196608)):
        assert micro_occ.occupancy_launch(n, tile, 132)[0] >= 264
    launches = []
    monkeypatch.setattr(micro_occ, "launch",
                        lambda name, *args: launches.append(args[2:-1]))
    monkeypatch.setattr(traversal, "_on_cpu", lambda x: False)
    monkeypatch.setattr(traversal, "_sm_count", lambda dev: 132)
    rays_cf, bounds = micro_occ.mixed_data(N_RAYS, BOXES, 32, seed=3)
    for g in (1, 8, 64):
        micro_occ.occupancy_cf(torch.as_tensor(rays_cf),
                               torch.as_tensor(bounds), 32, g)
    want = (N_RAYS, BOXES, 32, *micro_occ.occupancy_launch(N_RAYS, 32, 132))
    assert launches == [want] * 3


def test_add_one_refuses_other_types_and_layouts_and_takes_odd_lengths():
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(8, 128))
                        .astype(np.float32))
    with pytest.raises(ValueError):
        micro_occ.add_one(x.double())
    with pytest.raises(ValueError):
        micro_occ.add_one(x.T)
    for view in (x.flatten()[1:], x.flatten()[:1023], x.flatten()[1:1025]):
        np.testing.assert_array_equal(micro_occ.add_one_plain(view).numpy(),
                                      view.numpy() + np.float32(1.0))
        assert torch.equal(micro_occ.add_one(view), view + 1.0)
