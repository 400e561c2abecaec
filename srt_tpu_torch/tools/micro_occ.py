"""Launch cost and occupancy micro-benchmark (``tools/micro_occ.py``'s
counterpart): the fixed cost of one kernel launch apart from per-element
work.

Run as ``python3 -m srt_tpu_torch.tools.micro_occ [--device DEV] [--n N]
[--boxes C] [--tile T] [--reps R]``.  Variants, as in JAX's tool:

* v0: K1 (``add_one``, ``csrc/micro_occ.cu``), one launch on [8, 128];
* v0b: two K1 launches chained;
* v0c: ``x + 1.0`` through torch (one ``torch.add``);
* v1: B1 (``traversal.cull``) on N rays [N, 8] against C boxes at tile T;
* v4: K2 (``occupancy_cf``), rays component-first [8, N] against C boxes,
  one int32 a (tile, box), at JAX's g = 8 and 64 (tiles a block on the
  TPU), on JAX's own data and on data of mixed occupancy
  (``mixed_data``).  On the card g only checks that N is a multiple of
  tile * g: K2's launch comes from N, the tile and the SM count
  (``occupancy_launch``), so g = 8 and g = 64 run the same launch.

JAX's own data (normal draws, seed 0) gives an occupancy of 1 everywhere,
which would hide a fault in K2; the mixed data aims each tile's rays at
some of the boxes.  JAX's v4 passes one operand to a two-input kernel
(tools/micro_occ.py:106,119), so on the TPU it only ever printed FAILED;
K2 takes the ``bounds`` operand that v4 meant to pass.

Each line gives the wall ms of a call (calls back to back, one
synchronise: JAX's ``timeit``; for K1 it is the host's cost of a launch)
and the device ms (CUDA events around calls queued behind a spin; "not
measured" on the CPU); v0, v0c and v1 also give the host's µs a call
over ``LAUNCH_REPS`` calls back to back, the cost of a launch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.ops import traversal
from srt_tpu_torch.ops.cuda_lib import launch
from srt_tpu_torch.tools import common

N, TILE, C = 262144, 512, 10
GROUPS = (8, 64)
MAX_BOXES = 32      # K2's per-ray hit mask is one 32-bit word
# K2's launch (csrc/micro_occ.cu): consecutive rays a thread (the
# kernel's OCC_RAYS), rays a block while its tiles fit in one pass, at most
# threads a block, at least blocks an SM where the tiles allow it.
OCC_RAYS, OCC_BLOCK_RAYS, OCC_MAX_THREADS, OCC_BLOCKS_PER_SM = 4, 512, 512, 2
# Host cost of a launch: back-to-back calls timed.
LAUNCH_REPS = 10_000


# ---------------------------------------------------------------------------
# K1: o = x + 1 (replaces triv_kernel, tools/micro_occ.py:45)
# ---------------------------------------------------------------------------

def add_one_plain(x):
    return x + 1.0


def add_one(x, plain: bool = False):
    """K1 on a contiguous float32 tensor of any size: a float4 a thread,
    or a float a thread when the length is not a multiple of 4 or a
    pointer not 16-byte aligned."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("add_one takes a contiguous float32 tensor")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"add_one takes fewer than 2**31 elements, got "
                         f"{x.numel()}")
    if plain or traversal._on_cpu(x):
        return add_one_plain(x)
    o = torch.empty_like(x)
    launch("add_one", x, o, x.numel())
    return o


# ---------------------------------------------------------------------------
# K2: component-first occupancy (replaces make_cf's kern, :76)
# ---------------------------------------------------------------------------

def _check_occupancy(rays_cf, bounds, tile: int, g: int) -> None:
    if rays_cf.dim() != 2 or rays_cf.shape[0] != 8:
        raise ValueError(f"rays_cf must be [8, N], got {tuple(rays_cf.shape)}")
    if bounds.dim() != 2 or bounds.shape[0] != 8:
        raise ValueError(f"bounds must be [8, C], got {tuple(bounds.shape)}")
    if not 1 <= bounds.shape[1] <= MAX_BOXES:
        raise ValueError(f"1 to {MAX_BOXES} boxes, got {bounds.shape[1]}")
    if tile < 1 or g < 1 or rays_cf.shape[1] % (tile * g):
        raise ValueError(f"N = {rays_cf.shape[1]} is not a multiple of "
                         f"tile * g = {tile} * {g}")


def occupancy_cf_plain(rays_cf, bounds, tile: int, g: int = 1):
    """Plain version of K2: occ [N / tile, C] int32, 1 where some ray of
    the tile passes the slab test of box c (``sel`` is t_near, or t_far
    from inside the box, below the ray's t_max).  ``g`` only checks JAX's
    grid rule, N a multiple of tile * g: the output does not depend on
    it."""
    _check_occupancy(rays_cf, bounds, tile, g)
    n, c = rays_cf.shape[1], bounds.shape[1]
    o = rays_cf[0:3, None, :]
    inv = 1.0 / rays_cf[3:6, None, :]
    t0 = (bounds[0:3, :, None] - o) * inv                      # [3, C, N]
    t1 = (bounds[3:6, :, None] - o) * inv
    mn, mx = torch.minimum(t0, t1), torch.maximum(t0, t1)
    t_near = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    t_far = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    sel = torch.where(t_near >= 0.0, t_near, t_far)
    hit = (t_near <= t_far) & (t_far >= 0.0) & (sel < rays_cf[6][None, :])
    return hit.view(c, n // tile, tile).any(-1).T.to(torch.int32).contiguous()


def occupancy_launch(n: int, tile: int, sms: int):
    """(blocks, threads, tiles a block) of a K2 launch on n rays in
    tiles of ``tile``, from these and the SM count alone (JAX's g
    does not enter).  A block takes whole tiles: as many as fill
    ``OCC_BLOCK_RAYS`` rays while the grid keeps ``OCC_BLOCKS_PER_SM``
    blocks an SM, with threads of ``OCC_RAYS`` rays for one pass over
    them; a larger tile is one block's, up to ``OCC_MAX_THREADS`` threads
    looping over it."""
    n_tiles = n // tile
    if tile <= OCC_BLOCK_RAYS:
        k = max(1, min(OCC_BLOCK_RAYS // tile,
                       n_tiles // (OCC_BLOCKS_PER_SM * sms)))
        rays = k * tile
    else:
        k, rays = 1, min(tile, OCC_MAX_THREADS * OCC_RAYS)
    threads = -(-rays // (32 * OCC_RAYS)) * 32
    return -(-n_tiles // k), threads, k


def occupancy_cf(rays_cf, bounds, tile: int, g: int = 1, plain: bool = False):
    """K2 (``csrc/micro_occ.cu``), launched as ``occupancy_launch`` gives.
    ``g`` only keeps JAX's divisibility rule (n a multiple of tile * g):
    on the card every g runs the same launch."""
    if plain or traversal._on_cpu(rays_cf):
        return occupancy_cf_plain(rays_cf, bounds, tile, g)
    _check_occupancy(rays_cf, bounds, tile, g)
    rays_cf = traversal._f32(rays_cf)
    bounds = traversal._f32(bounds)
    n, c = rays_cf.shape[1], bounds.shape[1]
    occ = torch.empty((n // tile, c), dtype=torch.int32, device=rays_cf.device)
    launch("occupancy_cf", rays_cf, bounds, n, c, tile,
           *occupancy_launch(n, tile, traversal._sm_count(rays_cf.device)),
           occ)
    return occ


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def own_data(n: int = N, c: int = C, seed: int = 0):
    """JAX's tool's data, drawn in its order (tools/micro_occ.py:38-40):
    rays [n, 8], rays_cf [8, n], bounds [8, c], all normal (numpy)."""
    rng = np.random.default_rng(seed)
    rays = rng.normal(size=(n, 8)).astype(np.float32)
    rays_cf = rng.normal(size=(8, n)).astype(np.float32)
    bounds = rng.normal(size=(8, c)).astype(np.float32)
    return rays, rays_cf, bounds


def mixed_data(n: int, c: int, tile: int, seed: int = 1,
               inside: float = 0.05):
    """Rays of mixed occupancy (numpy): (rays_cf [8, n], bounds [8, c]).

    Box k is the unit cube centred at (3k, 0, 0).  Each tile aims at a
    random half of the boxes: its rays start above them (z in [10, 12])
    and head for a point of one of those boxes; 15% head up, away from
    every box, and a share ``inside`` starts inside its box with a random
    direction.  A third of the rays end at t_max in [5, 15], some before
    their box, and half of those inside a box end in [0.05, 1], often
    before they leave it; the rest never end.  Directions are unit
    length."""
    rng = np.random.default_rng(seed)
    bounds = np.zeros((8, c), np.float32)
    bounds[0] = 3.0 * np.arange(c) - 0.5
    bounds[1:3] = -0.5
    bounds[3] = 3.0 * np.arange(c) + 0.5
    bounds[4:6] = 0.5
    n_tiles = n // tile
    chosen = rng.random((n_tiles, c)) < 0.5
    weight = rng.random((n_tiles, tile, c)) * chosen[:, None, :]
    target = weight.argmax(-1).reshape(-1)
    aimed = weight.max(-1).reshape(-1) > 0.0
    cx = 3.0 * target
    o = np.stack([cx + rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  rng.uniform(10.0, 12.0, n)])
    aim = np.stack([cx + rng.uniform(-0.4, 0.4, n),
                    rng.uniform(-0.4, 0.4, n), np.zeros(n)])
    d = aim - o
    up = ~aimed | (rng.random(n) < 0.15)
    d[:, up] = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                         np.ones(n)])[:, up]
    inner = aimed & (rng.random(n) < inside)
    o[:, inner] = np.stack([cx + rng.uniform(-0.3, 0.3, n),
                            rng.uniform(-0.3, 0.3, n),
                            rng.uniform(-0.3, 0.3, n)])[:, inner]
    d[:, inner] = rng.normal(size=(3, n))[:, inner]
    d /= np.linalg.norm(d, axis=0)
    t_max = np.where(rng.random(n) < 1.0 / 3.0, rng.uniform(5.0, 15.0, n),
                     np.inf)
    # Half the rays that start inside a box end before they leave it.
    short = inner & (rng.random(n) < 0.5)
    t_max[short] = rng.uniform(0.05, 1.0, n)[short]
    rays_cf = np.zeros((8, n), np.float32)
    rays_cf[0:3], rays_cf[3:6], rays_cf[6] = o, d, t_max
    return rays_cf, bounds


# ---------------------------------------------------------------------------
# The tool
# ---------------------------------------------------------------------------

def run(device=None, n: int = N, c: int = C, tile: int = TILE,
        groups=GROUPS, reps: int = 20, seed: int = 0, verbose: bool = True,
        launch_reps: int = LAUNCH_REPS):
    """Time every variant; returns one record a variant: ``variant``,
    ``what``, ``ms`` (wall a call), ``device_ms`` (None on the CPU), for
    v0, v0c and v1 ``us_a_launch`` (wall µs a call over ``launch_reps``
    calls) and, for v4, ``g``, ``data`` and ``ones`` (the share of 1s)."""
    dev = resolve(device)
    card = common.header("micro_occ", dev, verbose)
    rays, rays_cf, bounds = (torch.as_tensor(a, device=dev)
                             for a in own_data(n, c, seed))
    mixed_cf, mixed_bounds = (torch.as_tensor(a, device=dev)
                              for a in mixed_data(n, c, tile, seed + 1))
    small = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    records = []

    def time_variant(variant, what, fn, **extra):
        ms = common.wall_s(fn, dev=dev, reps=reps, warm=2) * 1e3
        d_ms, _ = common.device_ms(fn, dev)
        rec = dict(variant=variant, what=what, ms=ms, device_ms=d_ms,
                   device=card, **extra)
        records.append(rec)
        if verbose:
            dev_txt = "not measured" if d_ms is None else f"{d_ms:9.5f} ms"
            ones = f"  ones {extra['ones']:.4f}" if "ones" in extra else ""
            us = (f"  {extra['us_a_launch']:.3f} µs a launch (host, "
                  f"{launch_reps} back to back)"
                  if "us_a_launch" in extra else "")
            print(f"{variant:4s} {what:40s} {ms:9.5f} ms a call (wall), "
                  f"device {dev_txt}{ones}{us}", flush=True)

    def host_us(fn):
        return common.wall_s(fn, dev=dev, reps=launch_reps) * 1e6

    def k1():
        return add_one(small)

    def torch_add():
        return small + 1.0

    def b1():
        return traversal.cull(rays, bounds, tile)

    time_variant("v0", "K1 add_one, one launch [8, 128]", k1,
                 us_a_launch=host_us(k1))
    time_variant("v0b", "K1 add_one, two launches chained",
                 lambda: add_one(add_one(small)))
    time_variant("v0c", "torch x + 1.0", torch_add,
                 us_a_launch=host_us(torch_add))
    time_variant("v1", f"B1 cull, {n} rays, {c} boxes, tile {tile}", b1,
                 us_a_launch=host_us(b1))
    for data, (rcf, bnd) in (("own", (rays_cf, bounds)),
                             ("mixed", (mixed_cf, mixed_bounds))):
        for g in groups:
            ones = float(occupancy_cf(rcf, bnd, tile, g).float().mean())
            time_variant("v4", f"K2 occupancy_cf g={g} (divisibility "
                         f"only), {data} data",
                         lambda r=rcf, b=bnd, g=g: occupancy_cf(r, b, tile, g),
                         g=g, data=data, ones=ones)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--boxes", type=int, default=C)
    ap.add_argument("--tile", type=int, default=TILE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_occ", args.device)
    if dev is None:
        return 2
    run(dev, args.n, args.boxes, args.tile, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
