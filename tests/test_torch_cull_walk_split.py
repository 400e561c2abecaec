"""The new orders of work of B3 (``csrc/cull_pg2.cu``) and of the tiled
walk B2/B2s/B2c (``csrc/intersect.cu``) give their functions' results.

Each kernel's order of work is written out here as a plain PyTorch twin
and held against the port's plain version and the interpret-mode Pallas
launch:

* B3 tests each super's box first, in the cluster test's FMA form, and a
  warp of 32 rays skips the super's 16 cluster tests when none of its
  live rays enters the super (a NaN super test counts as entering); it
  then lists each group's nonzero words chunk by chunk, ranked by a
  prefix count, and zero-fills the rest of the row.  Its words must equal
  ``_group_words`` and its lists ``_launch_cull_pg2``'s, bit for bit, on
  rays with infinite reciprocals, origins on box faces and at zero
  coordinates, dead rays, and a model whose last super is partial.
* B2 splits each admitted cluster's triangles round-robin by pairs over L
  lanes per ray that keep private (t, index) minima and meet once per
  processed super that admitted a cluster, and splits the super's 16
  cluster slab tests over the lanes too.  Its result and B2c counters
  must equal ``intersect_plain``'s bit for bit, and its result the
  Pallas launch's as ``tests/test_torch_traversal.py`` holds it (exact
  reciprocal, verified 1-ulp near-ties only), closest and any-hit, and
  exact ties between copies of the sphere go to the smaller index.

No test needs a card."""

import numpy as np
import pytest
import torch

from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu_torch.ops import traversal as tr
from tests.test_torch_traversal import (  # noqa: F401  (fixtures)
    exact_reciprocal, scenes)
from tests.test_torch_traversal import (TILE, assert_walk_equal, j,
                                        pg2_jax_tables)

torch.set_num_threads(2)

WARP = 32
CHUNK = 64          # supers per staged chunk (CHUNK, csrc/cull_pg2.cu)
N_CULL = 1024


# ---------------------------------------------------------------------------
# B3: the two-level cull
# ---------------------------------------------------------------------------

def cull_rays(cb8, sbounds, dead):
    """N_CULL rays in four blocks of 256 (rays8 [N, 8]): aimed at the
    sphere; axis-parallel (one or two zero direction components, so
    infinite reciprocals, some -0); starting on a cluster's or a super's
    box face (a face coordinate with a zero direction component on that
    axis) or at a zero coordinate; and random directions from anywhere.
    ``dead``: "live", "third" (every third ray t_max = 0) or "all"."""
    rng = np.random.default_rng(5)
    n = N_CULL // 4
    o = rng.uniform(-3.0, 3.0, (N_CULL, 3)).astype(np.float32)
    d = np.empty_like(o)
    d[:n] = rng.uniform(-0.3, 0.3, (n, 3)) - o[:n]
    axes = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    d[n:2 * n] = axes * rng.choice([-1.0, 1.0], (n, 1))
    two = rng.random(n) < 0.3          # some rays with one zero component
    d[n:2 * n][two] += np.roll(axes[two], 1, 1) * 0.5
    d[n:2 * n][rng.random(n) < 0.2] *= -1.0       # -0 components
    lo = np.concatenate([cb8[:3].numpy(), sbounds[:3].numpy()], 1)
    real = ~np.isnan(lo[0])
    faces = lo[:, real]
    face = rng.integers(0, faces.shape[1], n)
    ax = rng.integers(0, 3, n)
    blk = slice(2 * n, 3 * n)
    o[blk][np.arange(n), ax] = faces[ax, face]
    o[blk][rng.random(n) < 0.25, 0] = 0.0              # zero coordinates
    d[blk] = rng.uniform(-0.2, 0.2, (n, 3)) - 0.2 * o[blk]
    d[blk][np.arange(n), ax] = 0.0
    d[blk][o[blk][:, 0] == 0.0, 0] = 0.0
    d[3 * n:] = rng.normal(0.0, 1.0, (n, 3))
    t = np.where(rng.random(N_CULL) < 0.5, np.inf,
                 rng.uniform(0.5, 6.0, N_CULL)).astype(np.float32)
    if dead == "third":
        t[::3] = 0.0
    elif dead == "all":
        t[:] = 0.0
    rays8 = np.zeros((N_CULL, 8), np.float32)
    rays8[:, 0:3], rays8[:, 3:6], rays8[:, 6] = o, d, t
    return torch.tensor(rays8)


def two_level_words(rays8, cb8, sbounds, s_count, group):
    """B3's slab pass in the kernel's order: the super pre-test per ray,
    a warp's cluster tests only for the supers some live lane of it may
    enter, the group OR.  Returns (words [Np/G, S], may_enter [Np, S],
    tested [Np, S])."""
    c = tr._ray_cols(rays8)
    inv = [1.0 / c[3 + a] for a in range(3)]
    p = [c[a] * inv[a] for a in range(3)]
    live = c[6] > 0.0
    tn, tf, sel = tr._slab([sbounds[a] for a in range(3)],
                           [sbounds[3 + a] for a in range(3)], p, inv, True)
    nan = torch.isnan(tn) | torch.isnan(tf)
    enter = live & (nan | ((tn <= tf) & (tf >= 0.0) & (sel < c[6])))
    tested = enter.view(-1, WARP, s_count).any(1).repeat_interleave(WARP, 0)
    n_cl = s_count * tr.SUPER
    tn, tf, sel = tr._slab([cb8[a, :n_cl] for a in range(3)],
                           [cb8[3 + a, :n_cl] for a in range(3)], p, inv,
                           True)
    hit = (tn <= tf) & (tf >= 0.0) & (sel < c[6])
    # Exactness of the pre-test: no cluster of a failed super is entered.
    assert not (hit & ~enter.repeat_interleave(tr.SUPER, 1)).any()
    hit &= tested.repeat_interleave(tr.SUPER, 1)
    occ = hit.view(-1, group, s_count, tr.SUPER).any(1)
    shifts = torch.arange(tr.SUPER, dtype=torch.int32)
    words = (occ.to(torch.int32) << shifts).sum(-1, dtype=torch.int32)
    return words, enter, tested


def chunked_lists(words):
    """The kernel's list build: per chunk of CHUNK supers, each nonzero
    word at the group's count plus its rank (nonzero words before it in
    the chunk); the rest of the row zero-filled."""
    ng, s = words.shape
    clist = np.full((ng, s), -1, np.int64)
    bits = np.full((ng, s), -1, np.int64)
    counts = np.zeros((ng, 1), np.int64)
    w = words.numpy()
    for s0 in range(0, s, CHUNK):
        chunk = w[:, s0:s0 + CHUNK]
        nz = chunk != 0
        rank = np.cumsum(nz, 1) - nz
        g, jj = np.nonzero(nz)
        pos = counts[g, 0] + rank[g, jj]
        clist[g, pos] = s0 + jj
        bits[g, pos] = chunk[g, jj]
        counts[:, 0] += nz.sum(1)
    fill = np.arange(s)[None, :] >= counts
    clist[fill] = 0
    bits[fill] = 0
    assert (clist >= 0).all() and (bits >= 0).all()   # every slot written
    return tuple(torch.tensor(x, dtype=torch.int32)
                 for x in (clist, bits, counts))


@pytest.mark.parametrize("dead", ["live", "third", "all"])
@pytest.mark.parametrize("group", [8, 32, 128])
def test_two_level_cull_matches_plain_and_pallas(scenes, group, dead):
    _, ps = scenes
    _, _, sbounds, cb8, s, n_cl = tr.model_tables(ps, 0)
    assert n_cl % tr.SUPER                    # a partial last super
    assert torch.equal(tr.super_bounds(cb8, s), sbounds)
    rays8 = cull_rays(cb8, sbounds, dead)
    words, enter, tested = two_level_words(rays8, cb8, sbounds, s, group)
    assert torch.equal(words, tr._group_words(rays8, cb8, s, group, True))
    lists = chunked_lists(words)
    for a, b in zip(lists, tr.cull_pg2(rays8, cb8, s, group, sbounds)):
        assert torch.equal(a, b)
    jt = pg2_jax_tables(cb8, s, n_cl)
    ref = jax_tp._launch_cull_pg2(j(rays8), j(jt["cb8_j"]), j(jt["w_bp"]),
                                  TILE, True, group=group)
    for a, b in zip(lists, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if dead == "all":
        assert not enter.any() and not lists[2].any()
    else:
        assert int(lists[2].sum()) > 0
        assert not tested.all()               # some warps skip some supers
        c = tr._ray_cols(rays8)
        inf_inv = torch.cat(c[3:6], 1) == 0.0
        assert bool(inf_inv.any())            # infinite reciprocals ran


def test_cull_pg2_needs_the_tables_sbounds(scenes):
    """B3 takes the supers' boxes from the caller (``model_tables``'s,
    equal to ``super_bounds`` of the same cb8) and refuses a missing or
    misshapen table before it walks, on any device."""
    _, ps = scenes
    _, _, sbounds, cb8, s, _ = tr.model_tables(ps, 0)
    rays8 = cull_rays(cb8, sbounds, "live")
    with pytest.raises(TypeError):
        tr.cull_pg2(rays8, cb8, s, 32)
    for bad in (sbounds[:, :-1], sbounds[:6]):
        with pytest.raises(ValueError, match="sbounds has shape"):
            tr.cull_pg2(rays8, cb8, s, 32, bad)
    assert torch.equal(tr.super_bounds(torch.cat([cb8] * 2, 1), 2 * s),
                       torch.cat([sbounds] * 2, 1))


def test_nan_super_test_counts_as_entering():
    """A zero super bound times an infinite reciprocal gives NaN: such a
    super test counts as entering, so the warp runs the cluster tests.
    (In this FMA form a ray with a zero direction component fails every
    cluster box, so the rule is conservative, and the words stay equal.)
    One super with two real clusters, x in [-1, -0.5] and [-0.5, 0]; rays
    along +y from x = -0.25 and from x = 0."""
    cb8 = torch.full((8, tr.SUPER), float("nan"))
    cb8[6:] = 0.0
    cb8[:6, 0] = torch.tensor([-1.0, -1.0, -1.0, -0.5, 1.0, 1.0])
    cb8[:6, 1] = torch.tensor([-0.5, -1.0, -1.0, 0.0, 1.0, 1.0])
    sbounds = tr.super_bounds(cb8, 1)
    assert float(sbounds[3, 0]) == 0.0
    rays8 = torch.zeros((WARP, 8))
    rays8[:, 0] = -0.25
    rays8[::2, 0] = 0.0
    rays8[:, 1] = -3.0
    rays8[:, 4] = 1.0
    rays8[:, 6] = float("inf")
    words, enter, tested = two_level_words(rays8, cb8, sbounds, 1, WARP)
    assert torch.equal(words, tr._group_words(rays8, cb8, 1, WARP, True))
    c = tr._ray_cols(rays8)
    inv = [1.0 / c[3 + a] for a in range(3)]
    p = [c[a] * inv[a] for a in range(3)]
    tn, _, _ = tr._slab([sbounds[a] for a in range(3)],
                        [sbounds[3 + a] for a in range(3)], p, inv, True)
    assert bool(torch.isnan(tn).all())
    assert bool(enter.all()) and bool(tested.all())


# ---------------------------------------------------------------------------
# B2: the tiled walk split over lanes
# ---------------------------------------------------------------------------

def split_intersect(counts, clist, elist, rays8, cb, woop, tile, any_hit,
                    lanes):
    """The tiled walk in the kernel's order: per processed super, lane l
    slab-tests clusters k = l, l + L, ... against each ray's best t at the
    start of the super; the block ORs the words; in each admitted cluster
    lane l evaluates the pairs of triangles v = l, l + L, ... and keeps
    its own lexicographic (t, index) minimum; the lanes meet once the
    super's clusters are done, and the tile gate and any-hit test follow.
    A processed super that admits nothing leaves the minima and the gates
    as they were (once a super has been processed).  Returns (t, i, ctr)
    as ``intersect_plain(count=True)``."""
    npad = rays8.shape[0]
    n_tiles = npad // tile
    r = rays8.view(n_tiles, tile, 8)
    o = [r[..., a:a + 1] for a in range(3)]
    d = [r[..., 3 + a:4 + a] for a in range(3)]
    inv = [1.0 / x for x in d]
    t_max, t_lo = r[..., 6], r[..., 7:8]
    bt = t_max[:, None, :].repeat(1, lanes, 1)           # [tiles, L, tile]
    bi = torch.full_like(bt, tr.MISS_IDX, dtype=torch.int32)
    tbm = torch.full((n_tiles,), tr.BIG)
    done = torch.zeros(n_tiles, dtype=torch.bool)
    gated = torch.zeros(n_tiles, dtype=torch.bool)
    ctr = torch.zeros((n_tiles, 2), dtype=torch.int32)
    k_lane = torch.arange(tr.SUPER) % lanes
    tri_lane = (torch.arange(tr.CLUSTER) // 2) % lanes
    lane_idx = torch.arange(tr.CLUSTER, dtype=torch.int32)
    for jj in range(clist.shape[1]):
        gate = (jj < counts[:, 0]) & (elist[:, jj] < tbm) & ~done
        tiles = gate.nonzero()[:, 0]
        if tiles.numel() == 0:
            continue
        s_idx = clist[tiles, jj].long()
        b = cb[s_idx]
        tn, tf, sel = tr._slab([b[:, q:q + 1, :] for q in range(3)],
                               [b[:, q:q + 1, :] for q in range(3, 6)],
                               [x[tiles] for x in o], [x[tiles] for x in inv],
                               fma_form=False)
        # Every lane of a ray holds the ray's minimum at a super's start.
        enters = (tn <= tf) & (tf >= 0.0) & (sel < bt[tiles, 0][..., None])
        word = torch.zeros((tiles.numel(), tr.SUPER), dtype=torch.bool)
        for lane in range(lanes):
            word |= (enters & (k_lane == lane)).any(1)
        n = word.sum(1, dtype=torch.int32)
        ctr[tiles, 0] += 1
        ctr[tiles, 1] += n
        for k in range(tr.SUPER):
            sub = word[:, k].nonzero()[:, 0]
            if sub.numel() == 0:
                continue
            tt = tiles[sub]
            c = s_idx[sub] * tr.SUPER + k
            t, valid = tr._woop_candidates([x[tt] for x in o],
                                           [x[tt] for x in d], woop[c, :13],
                                           nested=False)
            if any_hit:
                valid = valid & (t > t_lo[tt])
            idx = (c.to(torch.int32) * tr.CLUSTER)[:, None, None] + lane_idx
            for lane in range(lanes):
                t_c, i_c = tr._lex_min_lanes(t, valid & (tri_lane == lane),
                                             idx)
                bt[tt, lane], bi[tt, lane] = tr._lex_merge(
                    bt[tt, lane], bi[tt, lane], t_c, i_c)
        met = tiles[n > 0]
        if met.numel():
            t_min = bt[met].amin(1, keepdim=True)
            i_min = torch.where(bt[met] == t_min, bi[met],
                                tr.MISS_IDX).amin(1, keepdim=True)
            bt[met], bi[met] = t_min.expand(-1, lanes, -1), i_min.expand(
                -1, lanes, -1)
        upd = tiles[(n > 0) | ~gated[tiles]]
        tbm[upd] = bt[upd, 0].amax(1)
        if any_hit:
            done[upd] = ((bt[upd, 0] < t_max[upd])
                         | (t_max[upd] <= 0.0)).all(1)
        gated[tiles] = True
    out_t, out_i = bt[:, 0], bi[:, 0]
    out_i = torch.where(out_t < t_max, out_i, torch.full_like(out_i, -1))
    return out_t.reshape(npad, 1), out_i.reshape(npad, 1), ctr


def walk_rays(scene, n, seed, any_hit, copies=1):
    """n rays from outside the sphere aimed near its centre, in a
    coherence order (sorted by direction octant, then origin), packed at
    tile 32: every live ray hits, so any-hit tiles end early.  A third
    dead.  Returns the walk operands of the sphere's tables repeated
    ``copies`` times (cluster c + 16*S*q holds cluster c)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0.0, 1.0, (n, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True)
         * rng.uniform(2.5, 4.0, (n, 1))).astype(np.float32)
    d = (rng.uniform(-0.3, 0.3, (n, 3)) - o).astype(np.float32)
    order = np.lexsort((o[:, 0], np.sign(d) @ np.array([1, 2, 4])))
    o, d = o[order], d[order]
    t = np.full(n, np.inf if not any_hit else 3.0, np.float32)
    t[::3] = 0.0
    rays8, _, _ = tr.pack_rays(scene, 0, torch.tensor(o.T.copy()),
                               torch.tensor(d.T.copy()), torch.tensor(t), 32,
                               t_lo=1e-2 if any_hit else 0.0)
    _, cb, sbounds, _, s, _ = tr.model_tables(scene, 0)
    woop = tr.stream_table(scene, 0)
    return dict(rays8=rays8, cb=torch.cat([cb] * copies),
                sbounds=torch.cat([sbounds] * copies, 1),
                woop=torch.cat([woop] * copies))


_WALK_CASES = {}


def walk_case(scenes, tile, any_hit, copies=1):
    """(operands, (JAX's tiled lists (counts, clist, elist) as torch,
    JAX's (t, i))) of 8 tiles' worth of rays (at least 1,024; JAX walks whole 8-tile windows), made
    once per module and shared by the lane counts."""
    key = (tile, any_hit, copies)
    if key not in _WALK_CASES:
        op = walk_rays(scenes[1], 8 * max(tile, 128), 3, any_hit, copies)
        clist, elist, counts = jax_tp._launch_cull(
            j(op["rays8"]), j(op["sbounds"]), tile, True)
        lists = counts, clist, elist
        ref = jax_tp._launch(*lists, j(op["rays8"]), j(op["cb"]),
                             j(op["woop"]), tile, True, any_hit=any_hit)
        _WALK_CASES[key] = op, ([torch.tensor(np.asarray(x))
                                 for x in lists], ref)
    return _WALK_CASES[key]


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("tile", [32, 256])
def test_split_walk_matches_plain_and_pallas(scenes, tile, any_hit, lanes):
    op, (lists, (ref_t, ref_i)) = walk_case(scenes, tile, any_hit)
    counts, clist, elist = lists
    t, i, ctr = split_intersect(counts, clist, elist, op["rays8"], op["cb"],
                                op["woop"], tile, any_hit, lanes)
    whole = tr.intersect_plain(counts, clist, elist, op["rays8"], op["cb"],
                               op["woop"], tile, any_hit, count=True)
    assert torch.equal(t, whole[0]) and torch.equal(i, whole[1])
    assert int((i >= 0).sum()) > op["rays8"].shape[0] // 2
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=False)
    if any_hit:          # some tile ended before the end of its list
        assert bool((ctr[:, 0] < counts[:, 0]).any())


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_split_walk_counters_equal(scenes, any_hit, lanes):
    """B2c: the split walk counts the supers processed and the clusters
    admitted exactly as the unsplit walk (the gates do not change)."""
    op, (lists, _) = walk_case(scenes, 32, any_hit)
    out = split_intersect(*lists, op["rays8"], op["cb"], op["woop"], 32,
                          any_hit, lanes)
    ref = tr.intersect_count(*lists, op["rays8"], op["cb"], op["woop"], 32,
                             any_hit, stream=True)
    assert torch.equal(out[2], ref[2])
    assert int(ref[2][:, 1].sum()) > int(ref[2][:, 0].sum()) > 0
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.parametrize("lanes", [2, 4])
def test_split_walk_exact_ties_go_to_the_smaller_index(scenes, lanes):
    """The sphere twice in one model's tables: every hit ties exactly
    between identical triangles in two clusters; the first copy's
    (smaller) index must win in the plain walk, the split and JAX."""
    single, (lists1, _) = walk_case(scenes, 32, False)
    one = tr.intersect_plain(*lists1, single["rays8"], single["cb"],
                             single["woop"], 32)
    op, (lists, (ref_t, ref_i)) = walk_case(scenes, 32, False, copies=2)
    whole = tr.intersect_plain(*lists, op["rays8"], op["cb"], op["woop"], 32)
    t, i, _ = split_intersect(*lists, op["rays8"], op["cb"], op["woop"], 32,
                              False, lanes)
    assert bool((one[1] >= 0).any())
    for got_t, got_i in (whole, (t, i)):
        assert torch.equal(got_t, one[0]) and torch.equal(got_i, one[1])
    assert (np.asarray(ref_i) < single["woop"].shape[0] * tr.CLUSTER).all()
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=False)


@pytest.mark.parametrize("tile", [32, 128, 256, 384, 512, 1024])
def test_intersect_threads(tile):
    """A whole number of lanes per ray, at most INTERSECT_LANES, at most
    1024 threads; the most lanes on few tiles, one lane on many."""
    sms = 132
    for n_rays in (tile, 8 * tile, 1 << 16, 1 << 18, 1 << 20, 1 << 23):
        threads = tr.intersect_threads(tile, n_rays, sms)
        assert threads % tile == 0 and threads <= 1024
        assert 1 <= threads // tile <= tr.INTERSECT_LANES
    few = tr.intersect_threads(tile, 8 * tile, sms) // tile
    assert few == min(tr.INTERSECT_LANES, 1024 // tile)
    assert tr.intersect_threads(tile, 1 << 23, sms) == tile
