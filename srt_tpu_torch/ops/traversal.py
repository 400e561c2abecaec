"""Cluster-culled Woop traversal: tables, the walk kernels' wrappers and
their plain PyTorch versions (counterpart of
``srt_tpu/ops/traversal_pallas.py``).

Triangles stay in BVH order, chunked into clusters of 128; 16 consecutive
clusters form a supercluster ("super").  Two walks carry the default
render path:

* the **tiled walk** (primary rays): ``cull`` (B1) slab-tests each ray
  tile against every super and writes a near-to-far list of the supers the
  tile needs; ``intersect`` (B2) walks that list with a shrinking
  tile-best-t gate, a per-super 16-cluster slab gate and a Woop
  unit-triangle evaluation of every admitted cluster;
* the **per-group walk "pg2"** (later bounces, shadow rays): ``cull_pg2``
  (B3) ORs per-ray cluster occupancy over groups of G rays into 16-bit
  words per super, listed in ascending super index (its kernel tests each
  super's box first and skips the clusters of supers no ray of a warp
  enters, with the same result); ``pgwalk2`` (B4) evaluates exactly those
  clusters for the group's rays.

Two more walks are selectable per bounce (``walks="binned"`` / ``"pg"``):

* the **pair-binned walk** (``binned=True``): ``cull_perray`` (B5) writes
  each 8-ray group's entry distance per super; ``binned_pairs`` groups the
  (group, super) pairs super-major into tiles of one super each, which
  ``intersect`` (B2) walks as one-entry lists; a segment-min combines the
  pairs per ray.  When the pairs overflow their static capacity the call
  takes the tiled walk instead (one host read of the pair count);
* the **mask-scan walk** (``binned="pg"``): ``cull_gmask`` (B6) writes
  each 8-ray group's 16-bit cluster word per super, uncompacted (its
  kernel tests each super's box first and skips the clusters of supers no
  ray of the group enters, with the same result); ``pgwalk`` (B7) scans
  every word and evaluates the set clusters.

Models above ``STREAM_THRESHOLD_CLUSTERS`` clusters take the streamed
variants of the walks (B2s ``intersect_stream``, B4s ``pgwalk2_stream``):
the same contract on a Woop table padded to whole supers.  B2 and B2s
run one kernel, as B4 and B4s do; each copies the clusters it evaluates
asynchronously into a ring of shared-memory buffers ahead of the
evaluation in both modes.  ``intersect_count`` (B2c) is the tiled walk
with per-tile counters (supers processed, clusters evaluated).

Each wrapper runs its hand-written CUDA kernel (``srt_tpu_torch/csrc``) on
CUDA tensors and its plain version on CPU tensors.  ``plain=True`` forces
the plain version on CUDA tensors too; it exists for kernel-vs-plain
comparisons.  There is no fallback: a kernel that fails to build or launch
raises.  Each kernel launch adds one to ``launch_counts[name]``.

The kernels only select the winning triangle per ray (fp32 candidate
search with an ``EDGE_EPS`` slop at shared edges); ``model_hit`` re-derives
exact (t, u, v) for the winner with one Moller-Trumbore evaluation.

Gradients: the walks are candidate searches with no gradient, as in the
JAX package, which wraps every kernel operand in ``stop_gradient``
(traversal_pallas.py:1466-1540).  ``model_tables``, ``stream_table`` and
``pack_rays`` build every kernel operand from detached tensors, so a walk
(kernel or plain version) never joins the autograd graph on either
device, and gradients with respect to vertices, frames and rays flow only
through the exact refine (``model_hit`` here, ``mesh_hit_fn``'s refine in
``models/mesh.py``).

Winner rule: the lexicographic minimum of (t, triangle index) over the
candidates a walk evaluates, so exact-t ties go to the smallest index.
The TPU's tiled walk instead gives same-lane cross-super ties to the
nearest-entry super (ROADMAP.md section C).

Parity notes (named where they apply):

* NaN: min/max propagate NaN as ``jnp.minimum``/``maximum`` do, so NaN
  boxes (padding) and on-boundary axis-parallel rays (0 * inf) fail every
  slab test.  ``torch.minimum``/``maximum`` propagate NaN; the CUDA
  kernels use explicit NaN-propagating helpers.
* Reciprocal: exact ``1 / den`` followed by the TPU kernel's Newton step,
  in the same operation order, built without FMA contraction, so a kernel
  and its plain version give bit-equal candidate t.
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from srt_tpu_torch.ops.cuda_lib import launch as _launch
from srt_tpu_torch.ops.cuda_lib import (  # noqa: F401  (re-exported)
    launch_counts, reset_launch_counts)
from srt_tpu_torch.ops.intersect import MT_HIT_EPS, MT_PARALLEL_EPS, mt_refine

CLUSTER = 128          # triangles per cluster
SUPER = 16             # clusters per supercluster (one 16-bit word)
GROUP = 8              # rays per group of the pair-binned and mask-scan walks
DEFAULT_TILE = 512     # rays per tiled-walk tile
DEN_EPS_SCALE = MT_PARALLEL_EPS
T_EPS = MT_HIT_EPS
EDGE_EPS = 1e-4        # candidate acceptance slop at shared edges
BIG = 3.0e37           # finite miss sentinel (inf would NaN in 0*inf)
MISS_IDX = 2 ** 30     # "no candidate yet" triangle index
# ``model_hit(stream=None)`` takes the streamed walks above this many
# clusters per model: the JAX package's switch point
# (traversal_pallas.py:1430), kept so both packages take the same branch
# on the same scene.  Its best value on the GPU is not measured yet.
STREAM_THRESHOLD_CLUSTERS = 1700

# Memory bound of the plain versions' broadcast temporaries (elements).
_PLAIN_CHUNK = 1 << 23


# ---------------------------------------------------------------------------
# Host-side precompute (numpy; same results as the JAX package)
# ---------------------------------------------------------------------------

def build_woop(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Per-triangle world->unit-triangle affine transforms, [13, T] float32:
    rows 0-3 the x-row (3 linear coefficients + translation), 4-7 the
    y-row, 8-11 the z-row, row 12 the |det|-scaled parallel epsilon
    (+inf for degenerate triangles).  Computed in float64."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(v1, np.float64) - v0
    e2 = np.asarray(v2, np.float64) - v0
    n = np.cross(e1, e2)
    t_count = v0.shape[0]

    a = np.stack([e1, e2, n], axis=-1)
    det = np.linalg.det(a)
    ok = np.abs(det) > 1e-18
    a_safe = np.where(ok[:, None, None], a, np.eye(3)[None])
    a_inv = np.linalg.inv(a_safe)
    trans = -np.einsum("tij,tj->ti", a_inv, v0)

    out = np.zeros((13, t_count), np.float64)
    for r in range(3):
        out[4 * r + 0] = a_inv[:, r, 0]
        out[4 * r + 1] = a_inv[:, r, 1]
        out[4 * r + 2] = a_inv[:, r, 2]
        out[4 * r + 3] = trans[:, r]
    n2 = np.einsum("ti,ti->t", n, n)
    out[12] = np.where(ok, DEN_EPS_SCALE / np.maximum(n2, 1e-30), np.inf)
    return out.astype(np.float32)


def build_clusters(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                   cluster: int = CLUSTER):
    """AABBs of consecutive ``cluster``-triangle chunks: (cmin [C, 3],
    cmax [C, 3]).  T must be a multiple of ``cluster``."""
    t_count = v0.shape[0]
    if t_count % cluster:
        raise ValueError("pad triangles to the cluster size first")
    c = t_count // cluster

    def chunk(arr):
        return np.asarray(arr, np.float32).reshape(c, cluster, 3)

    lo = np.minimum(np.minimum(chunk(v0).min(1), chunk(v1).min(1)),
                    chunk(v2).min(1))
    hi = np.maximum(np.maximum(chunk(v0).max(1), chunk(v1).max(1)),
                    chunk(v2).max(1))
    return lo, hi


# ---------------------------------------------------------------------------
# Shared arithmetic of the plain versions
# ---------------------------------------------------------------------------

def _ray_cols(rays8):
    """rays8 [..., 8] -> eight [..., 1] columns (ox oy oz dx dy dz t_max
    t_lo)."""
    return [rays8[..., q:q + 1] for q in range(8)]


def _slab(lo, hi, o, inv, fma_form: bool):
    """Slab test against boxes (lo/hi: 3 tensors each) for rays (o/inv: 3
    tensors each).  ``fma_form`` is the pg2 cull's ``box * inv - o * inv``
    (``o`` then holds ``o * inv``); otherwise ``(box - o) * inv``.
    Returns (t_near, t_far, sel), NaN-propagating (parity note NaN)."""
    if fma_form:
        t0 = [lo[a] * inv[a] - o[a] for a in range(3)]
        t1 = [hi[a] * inv[a] - o[a] for a in range(3)]
    else:
        t0 = [(lo[a] - o[a]) * inv[a] for a in range(3)]
        t1 = [(hi[a] - o[a]) * inv[a] for a in range(3)]
    mn = [torch.minimum(t0[a], t1[a]) for a in range(3)]
    mx = [torch.maximum(t0[a], t1[a]) for a in range(3)]
    t_near = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    t_far = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    # Entry bound max(t_near, 0), not exit-if-inside: a box entered from
    # inside can still hold candidates nearer than its exit.
    sel = torch.clamp_min(t_near, 0.0)
    return t_near, t_far, sel


def _woop_candidates(o, d, w, nested: bool):
    """Woop unit-triangle evaluation.  o/d: 3 ray tensors each [..., R, 1];
    w: [..., 13, 128] rows.  ``nested`` folds the affine rows right to
    left (the per-group walk's order), else left to right (the tiled
    walk's).  Returns (t, valid) [..., R, 128]."""
    def r(q):
        return w[..., q:q + 1, :]

    def affine(q):
        if nested:
            ro = o[0] * r(q) + (o[1] * r(q + 1) + (o[2] * r(q + 2) + r(q + 3)))
            rd = d[0] * r(q) + (d[1] * r(q + 1) + d[2] * r(q + 2))
        else:
            ro = o[0] * r(q) + o[1] * r(q + 1) + o[2] * r(q + 2) + r(q + 3)
            rd = d[0] * r(q) + d[1] * r(q + 1) + d[2] * r(q + 2)
        return ro, rd

    zo, zd = affine(8)
    parallel = zd.abs() <= r(12)
    den = torch.where(parallel, torch.ones_like(zd), zd)
    # Parity note Reciprocal: exact 1/den, then the TPU's Newton step.
    inv = 1.0 / den
    inv = inv * (2.0 - den * inv)
    t = -zo * inv
    xo, xd = affine(0)
    u = xo + t * xd
    yo, yd = affine(4)
    v = yo + t * yd
    m = torch.minimum(torch.minimum(u, v), (1.0 + 2 * EDGE_EPS) - u - v)
    valid = (m >= -EDGE_EPS) & ~parallel & (t > T_EPS)
    return t, valid


def _lex_min_lanes(t, valid, idx):
    """Per ray, the lexicographic min of (t, idx) over the 128 lanes of
    valid candidates: (t_min [..., R], i_min [..., R]); (inf, MISS_IDX)
    when no lane is valid."""
    tc = torch.where(valid, t, torch.full_like(t, float("inf")))
    t_min = tc.amin(-1)
    at_min = valid & (tc == t_min[..., None])
    i_min = torch.where(at_min, idx, torch.full_like(idx, MISS_IDX)).amin(-1)
    return t_min, i_min


def _lex_merge(bt, bi, t, i):
    better = (t < bt) | ((t == bt) & (i < bi))
    return torch.where(better, t, bt), torch.where(better, i, bi)


# ---------------------------------------------------------------------------
# B1: tiled-walk cull
# ---------------------------------------------------------------------------

def _super_entries(rays8, sbounds, width: int):
    """Per block of ``width`` consecutive rays, each super's minimum entry
    max(t_near, 0) over the rays that enter it before their t_max, else
    BIG: [Np/width, S] (the slab pass of B1 and B5)."""
    s = sbounds.shape[1]
    lo = [sbounds[a] for a in range(3)]
    hi = [sbounds[3 + a] for a in range(3)]
    parts = []
    step = max(width, (_PLAIN_CHUNK // s) // width * width)
    for r0 in range(0, rays8.shape[0], step):
        c = _ray_cols(rays8[r0:r0 + step])
        inv = [1.0 / c[3 + a] for a in range(3)]
        t_near, t_far, sel = _slab(lo, hi, c[0:3], inv, fma_form=False)
        hit = (t_near <= t_far) & (t_far >= 0.0) & (sel < c[6])
        e = torch.where(hit, sel, torch.full_like(sel, BIG))
        parts.append(e.view(-1, width, s).amin(1))
    return torch.cat(parts)


def cull_plain(rays8, sbounds, tile: int):
    """Plain version of B1.  rays8 [Np, 8]; sbounds [8, S] (rows min xyz,
    max xyz, pad).  Returns (clist [Np/tile, S] int32, elist [Np/tile, S]
    f32, counts [Np/tile, 1] int32): per tile, the supers any ray enters
    before its t_max, ordered by (tile-min entry distance, index); unused
    slots hold 0."""
    s = sbounds.shape[1]
    e = _super_entries(rays8, sbounds, tile)
    counts = (e < BIG).sum(1, dtype=torch.int32)[:, None]
    e_sorted, order = torch.sort(e, dim=1, stable=True)   # ties by index
    used = torch.arange(s, device=e.device)[None, :] < counts
    clist = torch.where(used, order, torch.zeros_like(order)).to(torch.int32)
    elist = torch.where(used, e_sorted, torch.zeros_like(e_sorted))
    return clist, elist, counts


# B1 launch shape (``csrc/cull.cu``): rays per thread, 1 or 2 (2 needs a
# tile of a multiple of 64 rays).  Chosen with sweep_cull_walk.py on the
# headline (S = 50) and config8 (S = 246) frames' launches.
CULL_RAYS_PER_THREAD = 2


def cull_rays_per_thread(tile: int) -> int:
    """Rays per thread of a B1 launch at ``tile`` rays per tile: a whole
    number of warps per block."""
    rpt = CULL_RAYS_PER_THREAD
    return rpt if tile % (32 * rpt) == 0 else 1


def cull(rays8, sbounds, tile: int, plain: bool = False):
    """B1 (replaces ``_cull_kernel``, traversal_pallas.py:134)."""
    if plain or _on_cpu(rays8):
        return cull_plain(rays8, sbounds, tile)
    _check_tile(tile)
    n_tiles = rays8.shape[0] // tile
    s = sbounds.shape[1]
    dev = rays8.device
    clist = torch.empty((n_tiles, s), dtype=torch.int32, device=dev)
    elist = torch.empty((n_tiles, s), dtype=torch.float32, device=dev)
    counts = torch.empty((n_tiles, 1), dtype=torch.int32, device=dev)
    _launch("cull", _f32(rays8), _f32(sbounds), n_tiles, tile, s,
            cull_rays_per_thread(tile), clist, elist, counts)
    return clist, elist, counts


# ---------------------------------------------------------------------------
# B2: tiled walk
# ---------------------------------------------------------------------------

def intersect_plain(counts, clist, elist, rays8, cb, woop, tile: int,
                    any_hit: bool = False, count: bool = False):
    """Plain version of B2 (and of B2s on a padded table, and of B2c with
    ``count``).  Per tile, walk the listed supers in order; skip a super
    unless its entry is below the tile gate (the max over the tile's rays
    of their best t; any-hit: also until every ray is resolved).  A
    processed super admits each of its 16 clusters that some ray of the
    tile enters before its current best t, and every admitted cluster's
    128 triangles are evaluated.  Returns (t [Np, 1] f32 — best candidate
    t, t_max on a miss; i [Np, 1] int32 — local triangle id or -1), and
    with ``count`` also ctr [Np/tile, 2] int32: per tile, the supers
    processed and the clusters evaluated."""
    npad = rays8.shape[0]
    n_tiles = npad // tile
    dev = rays8.device
    r = rays8.view(n_tiles, tile, 8)
    o = [r[..., a:a + 1] for a in range(3)]
    d = [r[..., 3 + a:4 + a] for a in range(3)]
    inv = [1.0 / x for x in d]
    t_max = r[..., 6]
    t_lo = r[..., 7:8]
    bt = t_max.clone()
    bi = torch.full((n_tiles, tile), MISS_IDX, dtype=torch.int32, device=dev)
    tbm = torch.full((n_tiles,), BIG, dtype=torch.float32, device=dev)
    done = torch.zeros((n_tiles,), dtype=torch.bool, device=dev)
    cnt = counts[:, 0]
    lane = torch.arange(CLUSTER, dtype=torch.int32, device=dev)
    ctr = torch.zeros((n_tiles, 2), dtype=torch.int32, device=dev)
    for j in range(clist.shape[1]):
        gate = (j < cnt) & (elist[:, j] < tbm)
        if any_hit:
            gate = gate & ~done
        tiles = gate.nonzero()[:, 0]
        if tiles.numel() == 0:
            continue
        s_idx = clist[tiles, j].long()
        b = cb[s_idx]                                        # [m, 8, 16]
        ot = [x[tiles] for x in o]
        it = [x[tiles] for x in inv]
        t_near, t_far, sel = _slab([b[:, q:q + 1, :] for q in range(3)],
                                   [b[:, q:q + 1, :] for q in range(3, 6)],
                                   ot, it, fma_form=False)
        enters = (t_near <= t_far) & (t_far >= 0.0) & (sel < bt[tiles][..., None])
        occ16 = enters.any(1)                                # [m, 16]
        ctr[tiles, 0] += 1
        ctr[tiles, 1] += occ16.sum(1, dtype=torch.int32)
        for k in range(SUPER):
            sub = occ16[:, k].nonzero()[:, 0]
            step = max(1, _PLAIN_CHUNK // (tile * CLUSTER))
            for c0 in range(0, sub.numel(), step):
                sk = sub[c0:c0 + step]
                tt = tiles[sk]
                c = s_idx[sk] * SUPER + k
                t, valid = _woop_candidates([x[tt] for x in o],
                                            [x[tt] for x in d],
                                            woop[c, :13], nested=False)
                if any_hit:
                    valid = valid & (t > t_lo[tt])
                idx = (c.to(torch.int32) * CLUSTER)[:, None, None] + lane
                t_c, i_c = _lex_min_lanes(t, valid, idx)
                bt[tt], bi[tt] = _lex_merge(bt[tt], bi[tt], t_c, i_c)
        tbm[tiles] = bt[tiles].amax(1)
        if any_hit:
            done[tiles] = ((bt[tiles] < t_max[tiles])
                           | (t_max[tiles] <= 0.0)).all(1)
    out_i = torch.where(bt < t_max, bi, torch.full_like(bi, -1))
    out = bt.reshape(npad, 1), out_i.reshape(npad, 1)
    return out + (ctr,) if count else out


# B2/B2s/B2c launch shape (``csrc/intersect.cu``): up to INTERSECT_LANES
# threads per ray, at most 1024 a block, and no more than the launch needs
# to reach about INTERSECT_FILL threads per SM: many tiles keep one lane
# per ray (the binned frame's millions of pair rays), a million rays take
# two (the headline's primaries), few tiles (config8's primaries, the
# pair tiles of late bounces) take more.  Chosen with sweep_cull_walk.py
# on the headline, config8 and binned frames' own calls.
INTERSECT_LANES = 4
INTERSECT_FILL = 8 * 2048


def intersect_threads(tile: int, n_rays: int, sms: int) -> int:
    """Threads per block of a B2/B2s/B2c launch of ``n_rays`` rays at
    ``tile`` rays per tile on a card of ``sms`` SMs: L lanes per ray, L at
    most INTERSECT_LANES and 1024 // tile, and at most what brings the
    launch to sms * INTERSECT_FILL threads (at least 1)."""
    fill = sms * INTERSECT_FILL // max(1, n_rays)
    return tile * max(1, min(INTERSECT_LANES, 1024 // tile, fill))


def _intersect_launch(name, counts, clist, elist, rays8, cb, woop, tile,
                      any_hit, stream, *extra):
    """Launch B2/B2s/B2c.  The streamed walk (``stream``) launches its
    tiles longest list first (an argsort of the counts), so that the
    heaviest tiles do not start last and hold the end of the launch: the
    large models it serves give tiles lists of very different lengths
    (config8's primaries: 13 clusters a tile on average, 100 at most).
    On the resident walk's launches the argsort costs more than it
    saves."""
    _check_tile(tile)
    npad = rays8.shape[0]
    out_t = torch.empty((npad, 1), dtype=torch.float32, device=rays8.device)
    out_i = torch.empty((npad, 1), dtype=torch.int32, device=rays8.device)
    order = None
    if stream:
        order = torch.argsort(counts[:, 0], descending=True,
                              stable=True).to(torch.int32)
    _launch(name, _i32(counts), _i32(clist), _f32(elist), clist.shape[1],
            _f32(rays8), _f32(cb), _f32(woop), order, npad // tile, tile,
            intersect_threads(tile, npad, _sm_count(rays8.device)),
            int(any_hit), out_t, out_i, *extra)
    return out_t, out_i


def intersect(counts, clist, elist, rays8, cb, woop, tile: int,
              any_hit: bool = False, plain: bool = False):
    """B2 (replaces ``_intersect_kernel`` resident mode,
    traversal_pallas.py:1061).  cb [S, 8, 16] per-super cluster boxes;
    woop [C, 16, 128]."""
    if plain or _on_cpu(rays8):
        return intersect_plain(counts, clist, elist, rays8, cb, woop, tile,
                               any_hit)
    return _intersect_launch("intersect", counts, clist, elist, rays8, cb,
                             woop, tile, any_hit, False)


def intersect_stream(counts, clist, elist, rays8, cb, woop, tile: int,
                     any_hit: bool = False, plain: bool = False):
    """B2s (replaces ``_intersect_kernel`` with ``stream=True``,
    traversal_pallas.py:1061): B2's contract and kernel on a Woop table
    [C, 16, 128] with C padded to whole supers (``stream_table``)."""
    _check_stream_table(woop)
    if plain or _on_cpu(rays8):
        return intersect_plain(counts, clist, elist, rays8, cb, woop, tile,
                               any_hit)
    return _intersect_launch("intersect_stream", counts, clist, elist, rays8,
                             cb, woop, tile, any_hit, True)


def intersect_count(counts, clist, elist, rays8, cb, woop, tile: int,
                    any_hit: bool = False, stream: bool = False,
                    plain: bool = False):
    """B2c (replaces ``_intersect_kernel`` with ``count_evals=True``,
    traversal_pallas.py:1111-1115): B2, or B2s with ``stream``, plus
    ctr [Np/tile, 2] int32 per tile: supers that passed the gate and the
    popcount of each processed super's cluster word.  Counting does not
    change the walk."""
    if stream:
        _check_stream_table(woop)
    if plain or _on_cpu(rays8):
        return intersect_plain(counts, clist, elist, rays8, cb, woop, tile,
                               any_hit, count=True)
    ctr = torch.empty((rays8.shape[0] // tile, 2), dtype=torch.int32,
                      device=rays8.device)
    out = _intersect_launch("intersect_count", counts, clist, elist, rays8,
                            cb, woop, tile, any_hit, stream, ctr)
    return out + (ctr,)


# ---------------------------------------------------------------------------
# B3: per-group cull
# ---------------------------------------------------------------------------

def _group_words(rays8, cb8, s_count: int, group: int, fma_form: bool):
    """Per group of ``group`` consecutive rays, the cluster occupancy
    (entry max(t_near, 0) below the ray's t_max) OR-ed over the group, as
    one 16-bit word per super: [Np/G, S] int32 (the slab pass of B3 and
    B6; ``fma_form`` as in ``_slab``)."""
    n_cl = s_count * SUPER
    lo = [cb8[a, :n_cl] for a in range(3)]
    hi = [cb8[3 + a, :n_cl] for a in range(3)]
    shifts = torch.arange(SUPER, dtype=torch.int32, device=rays8.device)
    parts = []
    step = max(group, (_PLAIN_CHUNK // n_cl) // group * group)
    for r0 in range(0, rays8.shape[0], step):
        c = _ray_cols(rays8[r0:r0 + step])
        inv = [1.0 / c[3 + a] for a in range(3)]
        o = [c[a] * inv[a] for a in range(3)] if fma_form else c[0:3]
        t_near, t_far, sel = _slab(lo, hi, o, inv, fma_form)
        hit = (t_near <= t_far) & (t_far >= 0.0) & (sel < c[6])
        occ = hit.view(-1, group, s_count, SUPER).any(1)
        parts.append((occ.to(torch.int32) << shifts).sum(-1, dtype=torch.int32))
    return torch.cat(parts)


def cull_pg2_plain(rays8, cb8, s_count: int, group: int):
    """Plain version of B3.  cb8 [8, >= 16*S] per-cluster boxes (rows min
    xyz, max xyz, pad; NaN boxes for padding clusters).  Per group of
    ``group`` consecutive rays: clist [Np/G, S] int32 (active supers,
    ascending), bits [Np/G, S] int32 (their 16 cluster-occupancy bits),
    counts [Np/G, 1] int32; unused slots hold 0."""
    bits = _group_words(rays8, cb8, s_count, group, fma_form=True)
    active = bits != 0
    counts = active.sum(1, dtype=torch.int32)[:, None]
    order = torch.sort((~active).to(torch.int8), dim=1, stable=True).indices
    used = torch.arange(s_count, device=bits.device)[None, :] < counts
    zero = torch.zeros_like(bits)
    clist = torch.where(used, order.to(torch.int32), zero)
    bits_out = torch.where(used, bits.gather(1, order), zero)
    return clist, bits_out, counts


def super_bounds(cb8, s_count: int):
    """Each super's box from the per-cluster boxes cb8 [8, >= 16*S]: the
    exact min/max of its real clusters, NaN padding boxes excluded through
    +/-BIG identities: [8, S] (rows min xyz, max xyz, zero pad), as
    ``model_tables`` builds ``sbounds``."""
    box = cb8[:6, :s_count * SUPER].reshape(6, s_count, SUPER)
    nan = torch.isnan(box)
    lo = torch.where(nan[:3], BIG, box[:3]).amin(-1)
    hi = torch.where(nan[3:], -BIG, box[3:]).amax(-1)
    return torch.cat([lo, hi, torch.zeros_like(lo[:2])]).contiguous()


def cull_pg2(rays8, cb8, s_count: int, group: int, sbounds,
             plain: bool = False):
    """B3 (replaces ``_cull_pg2_kernel``, traversal_pallas.py:527).
    ``sbounds`` [8, S]: the supers' boxes from the same ``model_tables``
    call as cb8 (equal to ``super_bounds(cb8, S)``), which the kernel tests
    before their clusters; the lists equal the plain version's only when
    each bounds its super's real cluster boxes.  The plain version does
    not read them."""
    _check_group(group, rays8.shape[0])
    if tuple(sbounds.shape) != (8, s_count):
        raise ValueError(f"sbounds has shape {tuple(sbounds.shape)}, need "
                         f"(8, {s_count})")
    if plain or _on_cpu(rays8):
        return cull_pg2_plain(rays8, cb8, s_count, group)
    if cb8.shape[1] < s_count * SUPER:
        raise ValueError(f"cb8 has {cb8.shape[1]} clusters, need "
                         f"{s_count * SUPER}")
    ng = rays8.shape[0] // group
    dev = rays8.device
    clist = torch.empty((ng, s_count), dtype=torch.int32, device=dev)
    bits = torch.empty((ng, s_count), dtype=torch.int32, device=dev)
    counts = torch.empty((ng, 1), dtype=torch.int32, device=dev)
    cb8 = _f32(cb8)
    _launch("cull_pg2", _f32(rays8), cb8, cb8.shape[1], _f32(sbounds),
            rays8.shape[0], s_count, group, clist, bits, counts)
    return clist, bits, counts


# ---------------------------------------------------------------------------
# B4: per-group walk
# ---------------------------------------------------------------------------

def pgwalk2_plain(clist, bits, counts, rays8, woop, group: int,
                  any_hit: bool = False):
    """Plain version of B4.  Each ray's winner is the lexicographic min of
    (t, index) over the valid candidates of every cluster its group
    lists, with t below min(t_max, BIG).  Returns (t [Np, 1] — the
    winner's t, else min(t_max, BIG); i [Np, 1] int32 — local id or
    -1)."""
    dev = rays8.device
    listed = torch.arange(clist.shape[1], device=dev)[None, :] < counts
    k16 = torch.arange(SUPER, dtype=torch.int32, device=dev)
    on = (((bits[..., None] >> k16) & 1) > 0) & listed[..., None]
    g_idx, j_idx, k_idx = on.nonzero(as_tuple=True)
    cl = clist[g_idx, j_idx].long() * SUPER + k_idx
    return _group_walk_plain(g_idx, cl, rays8, woop, group, any_hit,
                             torch.clamp_max(rays8[:, 6], BIG), nested=True)


def _group_walk_plain(g_idx, cl, rays8, woop, group: int, any_hit: bool,
                      t_cap, nested: bool):
    """The per-group walks' result: for each ray, the lexicographic min of
    (t, index) over the valid candidates of the (group ``g_idx``, cluster
    ``cl``) pairs with t below ``t_cap`` [Np].  Returns (t [Np, 1] — the
    winner's t, else t_cap; i [Np, 1] int32 — local id or -1)."""
    npad = rays8.shape[0]
    ng = npad // group
    dev = rays8.device
    rays_g = rays8.view(ng, group, 8)
    lane = torch.arange(CLUSTER, dtype=torch.int32, device=dev)
    pt, pi, pr = [], [], []
    step = max(1, _PLAIN_CHUNK // (group * CLUSTER))
    for p0 in range(0, cl.numel(), step):
        g = g_idx[p0:p0 + step]
        c = cl[p0:p0 + step]
        cols = _ray_cols(rays_g[g])                          # [p, G, 1]
        t, valid = _woop_candidates(cols[0:3], cols[3:6], woop[c, :13],
                                    nested)
        valid = valid & (t < t_cap.view(ng, group)[g][..., None])
        if any_hit:
            valid = valid & (t > cols[7])
        idx = (c.to(torch.int32) * CLUSTER)[:, None, None] + lane
        t_c, i_c = _lex_min_lanes(t, valid, idx)
        pt.append(t_c.reshape(-1))
        pi.append(i_c.reshape(-1))
        pr.append((g[:, None] * group
                   + torch.arange(group, device=dev)).reshape(-1))
    best_t = t_cap.clone()
    best_i = torch.full((npad,), MISS_IDX, dtype=torch.int32, device=dev)
    if pt:
        pt, pi, pr = torch.cat(pt), torch.cat(pi), torch.cat(pr)
        best_t = best_t.scatter_reduce(0, pr, pt, "amin")
        at_min = pt == best_t[pr]
        best_i = best_i.scatter_reduce(
            0, pr, torch.where(at_min, pi, torch.full_like(pi, MISS_IDX)),
            "amin")
    out_i = torch.where(best_t < t_cap, best_i, torch.full_like(best_i, -1))
    return best_t[:, None], out_i[:, None]


def pgwalk2(clist, bits, counts, rays8, woop, group: int,
            any_hit: bool = False, plain: bool = False):
    """B4 (replaces ``_pgwalk2_kernel`` resident mode,
    traversal_pallas.py:697)."""
    _check_group(group, rays8.shape[0])
    if plain or _on_cpu(rays8):
        return pgwalk2_plain(clist, bits, counts, rays8, woop, group, any_hit)
    return _pgwalk2_launch("pgwalk2", clist, bits, counts, rays8, woop, group,
                           any_hit)


def pgwalk2_stream(clist, bits, counts, rays8, woop, group: int,
                   any_hit: bool = False, plain: bool = False):
    """B4s (replaces ``_pgwalk2_kernel`` with ``stream=True``,
    traversal_pallas.py:697): B4's contract and kernel on a Woop table
    padded to whole supers (``stream_table``)."""
    _check_group(group, rays8.shape[0])
    _check_stream_table(woop)
    if plain or _on_cpu(rays8):
        return pgwalk2_plain(clist, bits, counts, rays8, woop, group, any_hit)
    return _pgwalk2_launch("pgwalk2_stream", clist, bits, counts, rays8, woop,
                           group, any_hit)


# B4/B4s launch shape: PGWALK2_LANES threads per ray (at least 128 a
# block); each group's list is split over enough blocks that the launch
# has about PGWALK2_FILL threads per SM, at most PGWALK2_MAX_PARTS blocks
# per group.  The fill is 32 times an H100 SM's 2,048-thread limit: a few
# long lists then no longer hold the end of a launch alone.  Chosen with
# sweep_pgwalk2.py on the headline and config8 frames' own calls.
PGWALK2_LANES = 4
PGWALK2_FILL = 32 * 2048
PGWALK2_MAX_PARTS = 64


def pgwalk2_shape(n_groups: int, list_w: int, group: int, sms: int):
    """(threads per block, blocks per group) of a B4/B4s launch on a card
    of ``sms`` SMs, from the launch's shape alone (``csrc/pgwalk2.cu``):
    min(1024, max(PGWALK2_LANES * G, 128)) threads, at most 64 per ray;
    the split P fills the card when the groups are few and is 1 when they
    are many."""
    threads = min(1024, max(PGWALK2_LANES * group, 128), 64 * group)
    fill = sms * PGWALK2_FILL // max(1, n_groups * threads)
    return threads, max(1, min(fill, PGWALK2_MAX_PARTS, list_w * SUPER))


def _pgwalk2_launch(name, clist, bits, counts, rays8, woop, group, any_hit):
    npad = rays8.shape[0]
    dev = rays8.device
    n_groups = npad // group
    threads, parts = pgwalk2_shape(n_groups, clist.shape[1], group,
                                   _sm_count(dev))
    keys = (torch.empty((parts, npad), dtype=torch.int64, device=dev)
            if parts > 1 else None)
    out_t = torch.empty((npad, 1), dtype=torch.float32, device=dev)
    out_i = torch.empty((npad, 1), dtype=torch.int32, device=dev)
    _launch(name, _i32(clist), _i32(bits), _i32(counts), clist.shape[1],
            _f32(rays8), _f32(woop), n_groups, group, threads, parts, keys,
            int(any_hit), out_t, out_i)
    return out_t, out_i


# ---------------------------------------------------------------------------
# B5: per-group super entries, and the pair binning (plain torch, as the
# JAX package computes it in XLA outside any kernel)
# ---------------------------------------------------------------------------

def cull_perray_plain(rays8, sbounds):
    """Plain version of B5: per group of GROUP consecutive rays, each
    super's minimum entry max(t_near, 0) over the rays that enter it
    before their t_max, else BIG: e [Np/8, S] f32 (B1's slab form)."""
    return _super_entries(rays8, sbounds, GROUP)


# B5/B6 launch shape (``csrc/cull_perray.cu``, ``csrc/cull_gmask.cu``): a
# warp takes CULL_WARP_GROUPS (B5) or CULL_GMASK_WARP_GROUPS (B6)
# consecutive 8-ray groups, or one on launches of fewer than CULL_FILL
# groups per SM (so that the few live groups of a small launch run side by
# side); CULL_BLOCK_WARPS warps a block.  Chosen with sweep_cull_walk.py
# on the binned and pg frames' launches.
CULL_WARP_GROUPS = 4
CULL_GMASK_WARP_GROUPS = 2
CULL_FILL = 128
CULL_BLOCK_WARPS = 4


def group_cull_shape(n_groups: int, sms: int, groups: int):
    """(groups per warp, warps per block) of a B5 or B6 launch of
    ``n_groups`` 8-ray groups on a card of ``sms`` SMs, the kernel taking
    ``groups`` a warp on large launches."""
    gpw = groups if n_groups >= sms * CULL_FILL else 1
    return gpw, CULL_BLOCK_WARPS


def cull_perray(rays8, sbounds, plain: bool = False):
    """B5 (replaces ``_cull_perray_kernel``, traversal_pallas.py:284)."""
    _check_group(GROUP, rays8.shape[0])
    if plain or _on_cpu(rays8):
        return cull_perray_plain(rays8, sbounds)
    npad, s = rays8.shape[0], sbounds.shape[1]
    e = torch.empty((npad // GROUP, s), dtype=torch.float32,
                    device=rays8.device)
    _launch("cull_perray", _f32(rays8), _f32(sbounds), npad, s,
            *group_cull_shape(npad // GROUP, _sm_count(rays8.device),
                              CULL_WARP_GROUPS), e)
    return e


def pair_capacity(n_groups: int, s: int, gpt: int, factor: int) -> int:
    """Static (group, super) pair capacity: ``factor`` slots per group,
    at most every pair plus a tile of padding per super, rounded up to
    whole 8-tile windows of ``gpt`` groups (``_pair_capacity``)."""
    cap = min(factor * n_groups, n_groups * s + s * gpt)
    return -(-cap // (gpt * 8)) * (gpt * 8)


def binned_pairs(e_group, gpt: int, p_cap: int):
    """Group the per-group super occupancy ``e_group`` [G, S] into
    super-major pair tiles of ``gpt`` groups (``_binned_pairs``).

    Returns (pair_grp [p_cap] int32 — group id per pair slot, G for
    padding; tile_super [p_cap/gpt, 1] int32 — each tile's one super;
    tile_counts [p_cap/gpt, 1] int32 — 1 for tiles below the total;
    total — 0-d tensor, the slots the pairs need, > p_cap on overflow).
    Pairs past ``p_cap`` are dropped, as ``.at[].set(mode="drop")``
    drops them."""
    n_groups, s = e_group.shape
    dev = e_group.device
    occ = (e_group < BIG).T.to(torch.int64)                 # [S, G]
    cnt = occ.sum(1)
    cnt_pad = (cnt + gpt - 1) // gpt * gpt
    ends = torch.cumsum(cnt_pad, 0)
    offs = ends - cnt_pad
    pos = offs[:, None] + torch.cumsum(occ, 1) - 1
    keep = (occ > 0) & (pos < p_cap)
    grp_ids = torch.arange(n_groups, dtype=torch.int32,
                           device=dev).expand(s, n_groups)
    pair_grp = torch.full((p_cap,), n_groups, dtype=torch.int32, device=dev)
    pair_grp[pos[keep]] = grp_ids[keep]
    tile_start = torch.arange(p_cap // gpt, dtype=torch.int64,
                              device=dev) * gpt
    tile_super = torch.clamp_max(
        torch.searchsorted(ends, tile_start, right=True), s - 1)
    tile_counts = tile_start < ends[-1]
    return (pair_grp, tile_super.to(torch.int32)[:, None],
            tile_counts.to(torch.int32)[:, None], ends[-1])


# ---------------------------------------------------------------------------
# B6: per-group cluster masks; B7: the mask-scan walk
# ---------------------------------------------------------------------------

def cull_gmask_plain(rays8, cb8, s_count: int):
    """Plain version of B6: per group of GROUP consecutive rays, the
    cluster occupancy OR-ed over the group, one 16-bit word per super
    (bit k of word s is cluster 16*s + k), uncompacted: mask [Np/8, S]
    int32.  B1's ``(box - o) * inv`` slab form, not B3's."""
    return _group_words(rays8, cb8, s_count, GROUP, fma_form=False)


def cull_gmask(rays8, cb8, s_count: int, sbounds, plain: bool = False):
    """B6 (replaces ``_cull_gmask_kernel``, traversal_pallas.py:436).
    ``sbounds`` [8, S]: the supers' boxes from the same ``model_tables``
    call as cb8 (equal to ``super_bounds(cb8, S)``), which the kernel tests
    before their clusters; the words equal the plain version's only when
    each bounds its super's real cluster boxes.  The plain version does
    not read them."""
    _check_group(GROUP, rays8.shape[0])
    if tuple(sbounds.shape) != (8, s_count):
        raise ValueError(f"sbounds has shape {tuple(sbounds.shape)}, need "
                         f"(8, {s_count})")
    if plain or _on_cpu(rays8):
        return cull_gmask_plain(rays8, cb8, s_count)
    if cb8.shape[1] < s_count * SUPER:
        raise ValueError(f"cb8 has {cb8.shape[1]} clusters, need "
                         f"{s_count * SUPER}")
    npad = rays8.shape[0]
    mask = torch.empty((npad // GROUP, s_count), dtype=torch.int32,
                       device=rays8.device)
    cb8 = _f32(cb8)
    _launch("cull_gmask", _f32(rays8), cb8, cb8.shape[1], _f32(sbounds),
            npad, s_count,
            *group_cull_shape(npad // GROUP, _sm_count(rays8.device),
                              CULL_GMASK_WARP_GROUPS), mask)
    return mask


def pgwalk_plain(mask, rays8, woop, any_hit: bool = False):
    """Plain version of B7.  Each ray's winner is the lexicographic min of
    (t, index) over the valid candidates of every cluster whose bit is
    set in its group's words, with t below t_max (no BIG cap), the affine
    rows folded left to right (B2's order).  Returns (t [Np, 1] — the
    winner's t, else t_max; i [Np, 1] int32 — local id or -1)."""
    k16 = torch.arange(SUPER, dtype=torch.int32, device=rays8.device)
    on = ((mask[..., None] >> k16) & 1) > 0
    g_idx, s_idx, k_idx = on.nonzero(as_tuple=True)
    return _group_walk_plain(g_idx, s_idx * SUPER + k_idx, rays8, woop,
                             GROUP, any_hit, rays8[:, 6], nested=False)


# B7 launch shape (``csrc/pgwalk.cu``): a block walks a tile of
# PGWALK_GROUPS neighbouring groups, PGWALK_LANES lanes per ray
# (PGWALK_FEW_LANES on launches below PGWALK_FILL threads per SM); the
# device splits the tiles' clusters into about PGWALK_ITEMS work items per
# SM of at least PGWALK_MIN_CHUNK clusters each.  Chosen with
# sweep_cull_walk.py on the pg frame's own launches: 8 lanes take each
# 4,096-ray launch (a few live groups) about 14% below 4 lanes; at 65,536
# rays 4 lanes are as fast or faster, hence the fill of 1024.
PGWALK_GROUPS = 8
PGWALK_LANES = 4
PGWALK_FEW_LANES = 8
PGWALK_FILL = 1024
PGWALK_MIN_CHUNK = 2
PGWALK_ITEMS = 16


def pgwalk_shape(n_groups: int, sms: int):
    """(groups per tile K, lanes per ray, least clusters per work item,
    work items aimed at) of a B7 launch of ``n_groups`` groups on a card of
    ``sms`` SMs, from the launch's shape alone: K * 8 * lanes threads per
    block, at most 1024."""
    lanes = PGWALK_LANES
    if n_groups * GROUP * lanes < sms * PGWALK_FILL:
        lanes = PGWALK_FEW_LANES
    k = max(1, min(PGWALK_GROUPS, 128 // GROUP, 1024 // (GROUP * lanes)))
    return k, lanes, PGWALK_MIN_CHUNK, sms * PGWALK_ITEMS


def pgwalk_plan(mask, k: int, min_chunk: int, target: int):
    """B7's work items, as its kernels split them on the device: per tile
    of ``k`` consecutive groups, the clusters set in the OR of their words
    (cnt [n_tiles]); chunk = max(min_chunk, ceil(total / target)); tile b
    gives ceil(cnt[b] / chunk) items, item j of it the clusters of rank
    j * chunk .. (j + 1) * chunk - 1 in ascending cluster order.  Returns
    (cnt, chunk, items)."""
    n_groups, s = mask.shape
    pad = -n_groups % k
    words = torch.cat([mask & 0xFFFF, mask.new_zeros((pad, s))])
    words = words.view(-1, k, s)
    orw = words[:, 0].clone()
    for g in range(1, k):
        orw |= words[:, g]
    cnt = sum(((orw >> b) & 1).sum(1) for b in range(SUPER))
    total = int(cnt.sum())
    chunk = max(min_chunk, -(-total // target))
    return cnt, chunk, int(((cnt + chunk - 1) // chunk).sum())


def pgwalk(mask, rays8, woop, any_hit: bool = False, plain: bool = False):
    """B7 (replaces ``_pgwalk_kernel``, traversal_pallas.py:937).  mask
    [Np/8, S] int32 from ``cull_gmask``; woop [C, 16, 128]."""
    _check_pgwalk(mask, rays8)
    if plain or _on_cpu(rays8):
        return pgwalk_plain(mask, rays8, woop, any_hit)
    return _pgwalk_launch(mask, rays8, woop, any_hit)[:2]


def pgwalk_device_plan(mask, rays8, woop, any_hit: bool = False):
    """(chunk, items) of B7's work split as its plan kernel chose it for
    these CUDA operands, read back after one launch: the device's side of
    ``pgwalk_plan``, for checks outside the render path."""
    _check_pgwalk(mask, rays8)
    if _on_cpu(rays8):
        raise ValueError("pgwalk_device_plan needs CUDA tensors")
    work = _pgwalk_launch(mask, rays8, woop, any_hit)[2]
    chunk, items = work[1:3].tolist()
    return chunk, items


def _check_pgwalk(mask, rays8) -> None:
    _check_group(GROUP, rays8.shape[0])
    if mask.shape[0] != rays8.shape[0] // GROUP:
        raise ValueError(f"mask has {mask.shape[0]} rows for "
                         f"{rays8.shape[0] // GROUP} groups")


def _pgwalk_launch(mask, rays8, woop, any_hit):
    """One B7 launch: (out_t, out_i, work), work the kernels' control
    array ([1] chunk, [2] items)."""
    npad = rays8.shape[0]
    dev = rays8.device
    n_groups = npad // GROUP
    k, lanes, min_chunk, target = pgwalk_shape(n_groups, _sm_count(dev))
    n_tiles = -(-n_groups // k)
    work = torch.empty((4 + 2 * n_tiles + 1,), dtype=torch.int32, device=dev)
    keys = torch.empty((npad,), dtype=torch.int64, device=dev)
    out_t = torch.empty((npad, 1), dtype=torch.float32, device=dev)
    out_i = torch.empty((npad, 1), dtype=torch.int32, device=dev)
    _launch("pgwalk", _i32(mask), mask.shape[1], _f32(rays8), _f32(woop),
            n_groups, int(any_hit), k, lanes, min_chunk, target, work, keys,
            out_t, out_i)
    return out_t, out_i, work


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------

def _on_cpu(x) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors
    (kernel); any other device raises."""
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"traversal kernels need CPU or CUDA tensors, got "
                     f"{x.device}")


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    """The card's SM count, read once a device (launch shapes ask for it
    on every call)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_tile(tile: int) -> None:
    if tile % 32 or not 32 <= tile <= 1024:
        raise ValueError(f"kernel tile {tile} must be a multiple of 32 in "
                         f"[32, 1024] (one thread per ray)")


def _check_group(group: int, npad: int) -> None:
    if group < 1 or group > 1024 or group & (group - 1):
        raise ValueError(f"pg2 group {group} must be a power of two <= 1024")
    if npad % group:
        raise ValueError(f"{npad} rays do not split into groups of {group}")


def _f32(x):
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    return x.contiguous()


def _i32(x):
    if x.dtype != torch.int32:
        raise TypeError(f"expected int32, got {x.dtype}")
    return x.contiguous()


def _check_stream_table(woop) -> None:
    if woop.shape[0] % SUPER:
        raise ValueError(f"the streamed walks need the Woop table padded to "
                         f"whole supers ({woop.shape[0]} clusters); use "
                         f"stream_table")


# ---------------------------------------------------------------------------
# Model-hit wrapper (the mesh_hit_fn strategy entry point)
# ---------------------------------------------------------------------------

def model_tables(scene, b: int):
    """The walk tables of model ``b``: (woop [C, 16, 128], cb [S, 8, 16],
    sbounds [8, S], cb8 [8, 16*S], s_count, n_clusters).

    Clusters pad to a full super.  The per-cluster boxes (cb, cb8) pad
    with NaN boxes, which fail every slab test for any ray (an inverted
    box would slab-test as a huge one); the super bounds reduce with
    +/-BIG identities so a partial super keeps its real bounds.  All are
    detached: kernel operands carry no autograd history."""
    lo = scene.model_first_tri[b]
    count = scene.model_padded_tri_count[b]
    if count % CLUSTER:
        raise ValueError("model is not cluster-aligned; flatten with "
                         "pad_to=128")
    c_lo = lo // CLUSTER
    n_clusters = count // CLUSTER
    cmin = scene.cluster_min[c_lo:c_lo + n_clusters].detach()
    cmax = scene.cluster_max[c_lo:c_lo + n_clusters].detach()
    s_count = -(-n_clusters // SUPER)
    c_pad = s_count * SUPER - n_clusters

    def pad(x, value):
        fill = torch.full((c_pad, 3), value, dtype=x.dtype, device=x.device)
        return torch.cat([x, fill])

    cmin_n, cmax_n = pad(cmin, float("nan")), pad(cmax, float("nan"))
    zeros = torch.zeros((s_count, 2, SUPER), dtype=torch.float32,
                        device=cmin.device)
    cb = torch.cat([cmin_n.view(s_count, SUPER, 3).transpose(1, 2),
                    cmax_n.view(s_count, SUPER, 3).transpose(1, 2),
                    zeros], dim=1).contiguous()
    smin = pad(cmin, BIG).view(s_count, SUPER, 3).amin(1)
    smax = pad(cmax, -BIG).view(s_count, SUPER, 3).amax(1)
    sbounds = torch.cat([smin.T, smax.T, zeros[:, :, 0].T]).contiguous()
    cb8 = torch.cat([cmin_n.T, cmax_n.T,
                     torch.zeros((2, s_count * SUPER), dtype=torch.float32,
                                 device=cmin.device)]).contiguous()
    woop = scene.woop[c_lo:c_lo + n_clusters].detach()
    return woop, cb, sbounds, cb8, s_count, n_clusters


# Padded Woop slices of the streamed walks: id(table) -> (weak reference
# to the table, {(first cluster, clusters): padded slice}); an entry is
# dropped when its table is freed.
_STREAM_TABLES = {}


def stream_table(scene, b: int):
    """Model ``b``'s Woop slice [C, 16, 128] padded with zero clusters to
    whole supers, as the streamed walks take it (zero rows: the parallel
    test ``|zd| <= 0`` holds, so a padding cluster never hits; its NaN
    box gates it off anyway).  Built once per table: a full-table copy per
    walk call would be a new cost in every frame."""
    c_lo = scene.model_first_tri[b] // CLUSTER
    n_clusters = scene.model_padded_tri_count[b] // CLUSTER
    woop = scene.woop[c_lo:c_lo + n_clusters].detach()
    w_pad = -n_clusters % SUPER
    if not w_pad:
        return woop
    table = scene.woop
    ref, per_table = _STREAM_TABLES.get(id(table), (None, None))
    if ref is None or ref() is not table:
        per_table = {}
        ref = weakref.ref(table,
                          lambda _, k=id(table): _STREAM_TABLES.pop(k, None))
        _STREAM_TABLES[id(table)] = ref, per_table
    if (c_lo, n_clusters) not in per_table:
        per_table[(c_lo, n_clusters)] = torch.cat(
            [woop, woop.new_zeros((w_pad,) + tuple(woop.shape[1:]))])
    return per_table[(c_lo, n_clusters)]


def pack_rays(scene, b: int, origins, dirs, t_best, tile: int,
              t_lo: float = 0.0):
    """The walk kernels' ray operand for model ``b``: (rays8 [Np, 8], o_m,
    d_m) with Np = N rounded up to ``tile``; columns origin, direction,
    t_max, t_lo, in model space.  Padding rays are dead (t_max = 0).

    Root-AABB t-clip: hits lie inside the model's box, so a ray's window
    ends just past the box exit; rays missing the box become dead.  NaN
    from an on-boundary origin with an axis-parallel direction kills the
    ray, as in the slab tests.

    ``rays8`` is built from detached tensors (the kernels are candidate
    searches outside the autograd graph); ``o_m`` and ``d_m`` keep their
    history for the caller's exact refine."""
    from srt_tpu_torch.models.mesh import transform_rays

    o_m, d_m = transform_rays(scene.frames[b], origins, dirs)
    o_k, d_k = o_m.detach(), d_m.detach()
    n = origins.shape[1]
    dev = origins.device
    c_lo = scene.model_first_tri[b] // CLUSTER
    c_hi = c_lo + scene.model_padded_tri_count[b] // CLUSTER
    root_lo = scene.cluster_min[c_lo:c_hi].detach().amin(0)
    root_hi = scene.cluster_max[c_lo:c_hi].detach().amax(0)
    inv_d = 1.0 / d_k
    tb0 = (root_lo[:, None] - o_k) * inv_d
    tb1 = (root_hi[:, None] - o_k) * inv_d
    bt_near = torch.minimum(tb0, tb1).amax(0)
    bt_far = torch.maximum(tb0, tb1).amin(0)
    t_clip = torch.where((bt_near <= bt_far) & (bt_far >= 0.0),
                         bt_far * (1.0 + 1e-4) + 1e-3,
                         torch.zeros_like(bt_far))
    t_best = torch.as_tensor(t_best, dtype=torch.float32,
                             device=dev).detach()
    rays8 = torch.zeros((n + (-n) % tile, 8), dtype=torch.float32,
                        device=dev)
    rays8[:n, 0:3] = o_k.T
    rays8[:, 3:6] = 1.0
    rays8[:n, 3:6] = d_k.T
    rays8[:n, 6] = torch.minimum(t_best.expand(n), t_clip)
    rays8[:, 7] = t_lo
    return rays8, o_m, d_m


def pair_rays(rays8, pair_grp):
    """The pair tiles' ray operand [P*8, 8]: each pair slot's group of
    GROUP rays, and a dead group (t_max 0) for the padding slots."""
    n_groups = rays8.shape[0] // GROUP
    dead = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0] * GROUP,
                        device=rays8.device)
    rays_grp = torch.cat([rays8.reshape(n_groups, GROUP * 8), dead[None]])
    return rays_grp[pair_grp.long()].view(-1, 8)


def _pair_walk(rays8, sbounds, cb, woop, tile: int, any_hit: bool,
               pair_factor: int, plain: bool):
    """The pair-binned walk (the binned branch of ``pallas_model_hit``,
    traversal_pallas.py:1637-1687): B5, the pair tiles walked by B2 as
    one-entry lists, and a segment-min combine per ray: min t first, then
    the smallest index among the pairs at that t.  If the pairs need more
    than the static capacity, the tiled walk (B1 + B2) on the same rays
    instead.  The choice reads the pair count on the host once per call
    (the eager counterpart of JAX's ``lax.cond``); only the chosen branch
    runs.  Returns (t [Np, 1] — t_max on a miss, i [Np, 1] int32)."""
    npad = rays8.shape[0]
    dev = rays8.device
    n_groups, gpt = npad // GROUP, tile // GROUP
    e_group = cull_perray(rays8, sbounds, plain)
    p_cap = pair_capacity(n_groups, sbounds.shape[1], gpt, pair_factor)
    pair_grp, tile_super, tile_counts, total = binned_pairs(e_group, gpt,
                                                            p_cap)
    if int(total) > p_cap:
        launch_counts["binned_fallback"] += 1
        clist, elist, counts = cull(rays8, sbounds, tile, plain)
        return intersect(counts, clist, elist, rays8, cb, woop, tile, any_hit,
                         plain)
    launch_counts["binned_pairs"] += 1
    elist0 = torch.zeros((p_cap // gpt, 1), dtype=torch.float32, device=dev)
    pt, pi = intersect(tile_counts, tile_super, elist0,
                       pair_rays(rays8, pair_grp), cb, woop, tile, any_hit,
                       plain)
    pt, pi = pt[:, 0], pi[:, 0]
    pt = torch.where(pi >= 0, pt, torch.full_like(pt, float("inf")))
    # Padding slots land in the rows past npad.
    pair_ray = (pair_grp.long()[:, None] * GROUP
                + torch.arange(GROUP, device=dev)).reshape(-1)
    seg_t = torch.full((npad + GROUP,), float("inf"), device=dev)
    seg_t = seg_t.scatter_reduce(0, pair_ray, pt, "amin")
    win = (pi >= 0) & (pt <= seg_t[pair_ray])
    miss = torch.full_like(pi, MISS_IDX)
    seg_i = torch.full((npad + GROUP,), MISS_IDX, dtype=torch.int32,
                       device=dev)
    seg_i = seg_i.scatter_reduce(0, pair_ray, torch.where(win, pi, miss),
                                 "amin")
    hit = seg_i[:npad] < MISS_IDX
    out_t = torch.where(hit, seg_t[:npad], rays8[:, 6])
    out_i = torch.where(hit, seg_i[:npad], torch.full_like(seg_i[:npad], -1))
    return out_t[:, None], out_i[:, None]


def model_hit(scene, b: int, origins, dirs, t_best, tile: int = DEFAULT_TILE,
              any_hit: bool = False, refine: bool = True, stream=None,
              binned=False, pair_factor: int = 8, count_evals: bool = False,
              t_min: float = 0.0, plain: bool = False):
    """Closest hit of [3, N] rays against model ``b`` (counterpart of
    ``pallas_model_hit``).  Returns (t [N], tri_idx [N] int32, u, v), and
    with ``count_evals`` also the tiled walk's per-tile counters ctr
    [Np/tile, 2] int32 (``intersect_count``).

    ``binned``: False for the tiled walk; True (or ``"binned"``) for the
    pair-binned walk, with ``pair_factor`` pair slots per 8-ray group
    before it falls back to the tiled walk; ``"pg"`` for the mask-scan
    walk; ``"pg2:G[:W]"`` for the per-group walk at G-ray groups (W is a
    TPU unroll width with no effect on the result).  As in the JAX
    package, neither ``True`` nor ``"pg"`` streams or runs on a one-super
    model: those calls take the tiled walk.  ``stream``: None takes the
    streamed walks for models of more than ``STREAM_THRESHOLD_CLUSTERS``
    clusters, as the JAX package does; True/False force them on or off.
    ``any_hit`` is the shadow-ray mode: candidate t > ``t_min`` is
    required and any hit inside t_best may end the walk.
    ``refine=False`` (or any-hit) returns the kernels' candidate t with
    zero u/v.  ``plain=True`` runs the plain versions on CUDA tensors (for
    kernel-vs-plain comparisons only).
    """
    if scene.woop is None:
        raise ValueError("scene was uploaded without walk tables; use "
                         "flatten_models(..., pad_to=128) + upload()")
    if count_evals and binned:
        raise ValueError("count_evals instrumentation covers the tiled walk "
                         "only")
    pairs = binned is True or binned == "binned"
    mask_scan = binned == "pg"
    group = 0
    if isinstance(binned, str) and not (pairs or mask_scan):
        if not binned.startswith("pg2:"):
            raise ValueError(f"unknown walk {binned!r}")
        group = int(binned.split(":")[1])

    lo = scene.model_first_tri[b]
    woop, cb, sbounds, cb8, s_count, n_clusters = model_tables(scene, b)
    if stream is None:
        stream = n_clusters > STREAM_THRESHOLD_CLUSTERS
    if stream:
        woop = stream_table(scene, b)
    pairs = pairs and s_count > 1 and not stream
    mask_scan = mask_scan and s_count > 1 and not stream
    # The pair capacity, and so the pair walk's branch, follows the padded
    # ray count: pad as the JAX package does, to whole 8-tile windows.
    rays8, o_m, d_m = pack_rays(scene, b, origins, dirs, t_best,
                                tile * 8 if pairs else tile,
                                t_min if any_hit else 0.0)
    n = origins.shape[1]
    npad = rays8.shape[0]
    dev = origins.device

    if group and s_count > 1:
        clist, bits, counts = cull_pg2(rays8, cb8, s_count, group, sbounds,
                                       plain)
        walk = pgwalk2_stream if stream else pgwalk2
        out_t, out_i = walk(clist, bits, counts, rays8, woop, group, any_hit,
                            plain)
    elif mask_scan:
        mask = cull_gmask(rays8, cb8, s_count, sbounds, plain)
        out_t, out_i = pgwalk(mask, rays8, woop, any_hit, plain)
    elif pairs:
        out_t, out_i = _pair_walk(rays8, sbounds, cb, woop, tile, any_hit,
                                  pair_factor, plain)
    else:
        if s_count == 1:
            # One super: the list is trivial; the cluster gate culls.
            alive = rays8[:, 6].view(-1, tile).amax(1) > 0.0
            counts = alive.to(torch.int32)[:, None]
            clist = torch.zeros((npad // tile, 1), dtype=torch.int32,
                                device=dev)
            elist = torch.zeros((npad // tile, 1), dtype=torch.float32,
                                device=dev)
        else:
            clist, elist, counts = cull(rays8, sbounds, tile, plain)
        if count_evals:
            out_t, out_i, ctr = intersect_count(
                counts, clist, elist, rays8, cb, woop, tile, any_hit, stream,
                plain)
        else:
            walk = intersect_stream if stream else intersect
            out_t, out_i = walk(counts, clist, elist, rays8, cb, woop, tile,
                                any_hit, plain)
    out_t = out_t[:n, 0]
    out_i = out_i[:n, 0]

    hit = out_i >= 0
    idx = torch.where(hit, out_i + lo, torch.full_like(out_i, -1))
    inf = torch.full_like(out_t, float("inf"))
    if any_hit or not refine:
        zeros = torch.zeros_like(out_t)
        out = (torch.where(hit, out_t, inf), idx, zeros, zeros)
    else:
        w = torch.clamp_min(idx, 0).long()
        v0 = scene.tri_v0[w].T
        t, u, v = mt_refine(o_m, d_m, v0, scene.tri_v1[w].T - v0,
                            scene.tri_v2[w].T - v0)
        zeros = torch.zeros_like(t)
        out = (torch.where(hit, t, inf), idx, torch.where(hit, u, zeros),
               torch.where(hit, v, zeros))
    return out + (ctr,) if count_evals else out
