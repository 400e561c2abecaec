"""The orders of work of B1 (``csrc/cull.cu``) and B7 (``csrc/pgwalk.cu``)
are legal.

B1: each warp takes the minimum entry bits of its rays per super, the
warps' minima are combined once, and each tile's active supers are ranked
by a bitonic sort of 64-bit keys (entry bits << 32 | index) over the next
power of two >= S, inactive supers and padding as ~0.  ``cull_twin`` runs
that order in numpy; it must equal ``cull_plain`` and the interpret-mode
Pallas launch bit for bit (-0 and +0 entries compare equal), at S = 50,
64 and 246 on random boxes, with all-dead and half-dead tiles, rays
starting on a box face and rays with zero direction components.

B7: tiles of K groups, each tile's clusters (those set in the OR of its
groups' words, ascending) cut into work items of ``chunk`` clusters; an
item evaluates its clusters for the groups whose own bit is set, and the
items' (t bits << 32 | index) keys merge by minimum (no key: t_max, -1).
``pgwalk_items_twin`` runs that order through ``pgwalk_plain`` on each
item's masks; it must equal the unsplit plain walk bit for bit and the
interpret-mode Pallas launch as ``tests/test_torch_traversal.py`` holds
it (exact reciprocal, verified 1-ulp near-ties only), closest- and
any-hit, with a group and a tile with no set bit, and on a doubled table
where every hit is an exact tie that the first copy must win.  The plan
(``traversal.pgwalk_plan``) and the launch shape (``pgwalk_shape``) are
checked on the pg frame's launch sizes."""

import numpy as np
import pytest
import torch

from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu_torch.ops import traversal as tr
from tests.test_torch_traversal import (  # noqa: F401  (fixtures)
    exact_reciprocal, scenes)
from tests.test_torch_traversal import (TILE, assert_walk_equal, j,
                                        operands, pg2_jax_tables)

torch.set_num_threads(2)

NO_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# B1
# ---------------------------------------------------------------------------

def bitonic_sort(keys):
    """Ascending bitonic network over the last axis (a power of two), as
    the kernel runs it: compare-exchange of i and i ^ j, ascending where
    i & k == 0."""
    keys = keys.copy()
    p2 = keys.shape[-1]
    i = np.arange(p2)
    k = 2
    while k <= p2:
        jj = k >> 1
        while jj > 0:
            lo = i[(i ^ jj) > i]
            hi = lo ^ jj
            a, b = keys[:, lo], keys[:, hi]
            swap = (a > b) == ((lo & k) == 0)
            keys[:, lo] = np.where(swap, b, a)
            keys[:, hi] = np.where(swap, a, b)
            jj >>= 1
        k <<= 1
    return keys


def cull_twin(rays8, sbounds, tile, rpt):
    """B1's order of work: per-warp minima of the entry bits (thread t of
    a tile's tile / rpt threads takes rays t, t + tile / rpt, ...),
    combined once; the keys sorted by ``bitonic_sort``."""
    s = sbounds.shape[1]
    e = tr._super_entries(rays8, sbounds, 1) + 0.0     # -0 -> +0
    bits = e.numpy().view(np.uint32).astype(np.uint64)
    n_tiles = rays8.shape[0] // tile
    threads = tile // rpt
    # [tile, threads / 32 warps, rpt, 32 lanes, S] -> warp minima
    per = bits.reshape(n_tiles, rpt, threads // 32, 32, s)
    wmin = per.min(axis=(1, 3))
    big = np.uint64(np.float32(tr.BIG).view(np.uint32))
    e_tile = wmin.min(1)
    p2 = 1 << (s - 1).bit_length()
    keys = np.full((n_tiles, p2), NO_KEY, np.uint64)
    idx = np.arange(s, dtype=np.uint64)
    keys[:, :s] = np.where(e_tile < big, (e_tile << np.uint64(32)) | idx,
                           NO_KEY)
    keys = bitonic_sort(keys)[:, :s]
    used = keys != NO_KEY
    clist = np.where(used, keys & np.uint64(0xFFFFFFFF), 0).astype(np.int32)
    elist = np.where(used, (keys >> np.uint64(32)).astype(np.uint32), 0)
    counts = used.sum(1, dtype=np.int32)[:, None]
    return (torch.tensor(clist), torch.tensor(elist.view(np.float32)),
            torch.tensor(counts))


def random_cull_case(s, seed):
    """1024 rays in 8 tiles of 128 against s random boxes: tile 0 dead,
    tile 1 half dead, tile 2 starting on box faces (going in, so the
    entry is -0 before the clamp), tile 3 with zero direction components
    (some from a face on the zero axis), the rest random."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3.0, 3.0, (s, 3))
    h = rng.uniform(0.05, 1.0, (s, 3))
    sb = np.zeros((8, s), np.float32)
    sb[0:3] = (c - h).T
    sb[3:6] = (c + h).T
    n = 8 * TILE
    o = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    t = np.full(n, np.inf, np.float32)
    t[:TILE] = 0.0
    t[TILE:2 * TILE:2] = 0.0
    face = np.arange(2 * TILE, 3 * TILE)
    box = face % s
    o[face] = c[box]
    o[face, 0] = sb[0, box]
    d[face, 0] = -np.abs(d[face, 0]) - 0.1
    axis = np.arange(3 * TILE, 4 * TILE)
    d[axis, (axis % 3)] = 0.0
    d[axis[::4], ((axis[::4] + 1) % 3)] = 0.0
    zero_face = axis[1::8]
    o[zero_face, zero_face % 3] = sb[zero_face % 3, zero_face % s]
    rays8 = np.zeros((n, 8), np.float32)
    rays8[:, 0:3] = o
    rays8[:, 3:6] = d
    rays8[:, 6] = t
    return torch.tensor(rays8), torch.tensor(sb)


@pytest.mark.parametrize("rpt", [1, 2])
@pytest.mark.parametrize("s", [50, 64, 246])
def test_cull_twin_matches_plain_and_pallas(s, rpt):
    rays8, sb = random_cull_case(s, s)
    got = cull_twin(rays8, sb, TILE, rpt)
    plain = tr.cull_plain(rays8, sb, TILE)
    ref = jax_tp._launch_cull(j(rays8), j(sb), TILE, True)
    counts = got[2][:, 0]
    assert counts[0] == 0 and (counts[1:] > 0).all()
    assert int(counts.max()) > 1
    for a, b, c in zip(got, plain, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    # Entries of 0 (the face tile's rays start inside or on boxes).
    assert (got[1][2][: int(counts[2])] == 0).any()


def test_bitonic_sort_orders_keys_and_padding():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 62, (5, 64)).astype(np.uint64)
    keys[:, 40:] = NO_KEY
    keys[1, :] = keys[1, 0]                       # all equal
    rng.shuffle(keys, axis=1)
    np.testing.assert_array_equal(bitonic_sort(keys), np.sort(keys, 1))


def test_cull_rays_per_thread():
    saved = tr.CULL_RAYS_PER_THREAD
    try:
        for rpt in (1, 2):
            tr.CULL_RAYS_PER_THREAD = rpt
            for tile in range(32, 1025, 32):
                got = tr.cull_rays_per_thread(tile)
                assert got in (1, rpt) and (tile // got) % 32 == 0
            assert tr.cull_rays_per_thread(256) == rpt
    finally:
        tr.CULL_RAYS_PER_THREAD = saved


# ---------------------------------------------------------------------------
# B7
# ---------------------------------------------------------------------------

def item_masks(mask, k, chunk):
    """The work items' masks, item index j of every tile stacked in one
    mask (items of different tiles touch different rays): a list over j of
    [G, S] masks holding, for each group, its own bits among the clusters
    of rank j * chunk .. (j + 1) * chunk - 1 of its tile's OR."""
    words = (mask & 0xFFFF).numpy()
    n_groups, s = words.shape
    out = []
    for t0 in range(0, n_groups, k):
        orw = np.bitwise_or.reduce(words[t0:t0 + k], axis=0)
        ids = [sup * tr.SUPER + b for sup in range(s) for b in range(tr.SUPER)
               if orw[sup] >> b & 1]
        for jj in range(0, len(ids), chunk):
            if len(out) <= jj // chunk:
                out.append(np.zeros_like(words))
            sel = np.zeros(s, np.int64)
            for cl in ids[jj:jj + chunk]:
                sel[cl // tr.SUPER] |= 1 << (cl % tr.SUPER)
            out[jj // chunk][t0:t0 + k] = words[t0:t0 + k] & sel
    return [torch.tensor(m.astype(np.int32)) for m in out]


def pgwalk_items_twin(mask, rays8, woop, any_hit, k, min_chunk, target):
    """B7's order of work through the plain walk: per item, the best key
    of each ray; keys merged by minimum; no key gives t_max and -1."""
    _, chunk, n_items = tr.pgwalk_plan(mask, k, min_chunk, target)
    keys = np.full(rays8.shape[0], NO_KEY, np.uint64)
    masks = item_masks(mask, k, chunk)
    for m in masks:
        t, i = tr.pgwalk_plain(m, rays8, woop, any_hit)
        t, i = t[:, 0].numpy(), i[:, 0].numpy()
        key = np.where(i >= 0, (t.view(np.uint32).astype(np.uint64)
                                << np.uint64(32)) | i.astype(np.uint64),
                       NO_KEY)
        keys = np.minimum(keys, key)
    hit = keys != NO_KEY
    out_t = np.where(hit, (keys >> np.uint64(32)).astype(np.uint32),
                     rays8[:, 6].numpy().view(np.uint32)).view(np.float32)
    out_i = np.where(hit, keys & np.uint64(0xFFFFFFFF), -1).astype(np.int32)
    return (torch.tensor(out_t)[:, None], torch.tensor(out_i)[:, None],
            n_items, len(masks))


def pg_masks(op, clear=True):
    """JAX's B6 masks on op's operands (numpy); with ``clear``, group 5
    and the tile of groups 16-23 cleared (no set bit)."""
    mask = np.array(jax_tp._launch_cull_gmask(j(op["rays8"]), j(op["cb8_j"]),
                                              j(op["w_bp"]), TILE, True))
    if clear:
        mask[5] = 0
        mask[16:24] = 0
    return mask


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("parts", [2, 3, 7])
def test_pgwalk_items_match_whole_and_pallas(scenes, parts, k, any_hit):
    op = operands(scenes[1], 11, True, any_hit)
    mask = pg_masks(op)
    ref_t, ref_i = jax_tp._launch_pgwalk(j(mask), j(op["rays8"]),
                                         j(op["woop"]), True,
                                         any_hit=any_hit)
    mask = torch.tensor(mask)
    cnt = tr.pgwalk_plan(mask, k, 1, 1 << 30)[0]
    chunk = -(-int(cnt.max()) // parts)           # the longest tile: P parts
    t, i, n_items, most = pgwalk_items_twin(mask, op["rays8"], op["woop"],
                                            any_hit, k, chunk, 1 << 30)
    assert most > 1 and n_items > int((cnt > 0).sum())   # tiles split
    whole = tr.pgwalk_plain(mask, op["rays8"], op["woop"], any_hit)
    assert torch.equal(t, whole[0]) and torch.equal(i, whole[1])
    empty = (mask == 0).all(1).repeat_interleave(tr.GROUP)
    assert empty.sum() >= 9 * tr.GROUP
    assert (i[empty] == -1).all()
    assert torch.equal(t[empty, 0], op["rays8"][empty, 6])
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=False)


def test_pgwalk_items_from_the_target(scenes):
    """The chunk chosen from the target, not the minimum: about ``target``
    items."""
    op = operands(scenes[1], 11, False, False)
    mask = torch.tensor(pg_masks(op))
    cnt, chunk, n_items = tr.pgwalk_plan(mask, 8, 1, 40)
    assert chunk == -(-int(cnt.sum()) // 40) and chunk > 1
    assert 40 <= n_items <= 40 + len(cnt)
    t, i, got_items, _ = pgwalk_items_twin(mask, op["rays8"], op["woop"],
                                           False, 8, 1, 40)
    assert got_items == n_items
    whole = tr.pgwalk_plain(mask, op["rays8"], op["woop"])
    assert torch.equal(t, whole[0]) and torch.equal(i, whole[1])


@pytest.mark.parametrize("parts", [2, 7])
def test_pgwalk_exact_ties_go_to_the_smaller_index(scenes, parts):
    """The sphere twice in one model's tables: every hit ties exactly; the
    first copy must win in the plain walk, the items and JAX."""
    op = operands(scenes[1], 11, True, False)
    single = tr.pgwalk_plain(torch.tensor(pg_masks(op, False)),
                             op["rays8"], op["woop"])
    woop = tr.stream_table(scenes[1], 0)
    s2 = 2 * op["s"]
    cb8 = torch.cat([op["cb8"], op["cb8"]], 1)
    twice = dict(op, woop=torch.cat([woop, woop]), cb8=cb8, s=s2,
                 **pg2_jax_tables(cb8, s2, cb8.shape[1]))
    mask = pg_masks(twice, False)
    ref_t, ref_i = jax_tp._launch_pgwalk(j(mask), j(twice["rays8"]),
                                         j(twice["woop"]), True)
    mask = torch.tensor(mask)
    cnt = tr.pgwalk_plan(mask, 8, 1, 1 << 30)[0]
    t, i, _, most = pgwalk_items_twin(mask, twice["rays8"], twice["woop"],
                                      False, 8, -(-int(cnt.max()) // parts),
                                      1 << 30)
    assert most > 1
    whole = tr.pgwalk_plain(mask, twice["rays8"], twice["woop"])
    assert (single[1] >= 0).any()
    for got_t, got_i in (whole, (t, i)):
        assert torch.equal(got_t, single[0]) and torch.equal(got_i, single[1])
    assert (np.asarray(ref_i) < woop.shape[0] * tr.CLUSTER).all()
    assert_walk_equal(ref_t, ref_i, t, i, twice, nested=False)


# The pg frame's B7 launches (1024x1024 headline): groups of 8 rays.
PG_FRAME_GROUPS = (1048576 // 8, 745472 // 8, 4096 // 8)


@pytest.mark.parametrize("n_groups", PG_FRAME_GROUPS)
def test_pgwalk_shape(n_groups):
    """Whole warps of one group (lanes a multiple of 4), at most 1024
    threads and 128 rays a block; more lanes where the groups are few."""
    sms = 132
    k, lanes, min_chunk, target = tr.pgwalk_shape(n_groups, sms)
    assert lanes % 4 == 0 and 4 <= lanes <= tr.CLUSTER // 2
    assert k * tr.GROUP <= 128 and k * tr.GROUP * lanes <= 1024
    assert min_chunk >= 1 and target >= sms
    few = n_groups * tr.GROUP * tr.PGWALK_LANES < sms * tr.PGWALK_FILL
    assert lanes == (tr.PGWALK_FEW_LANES if few else tr.PGWALK_LANES)


def test_pgwalk_plan_splits_a_few_live_groups():
    """Launch 12's shape: 93,184 groups, a handful with long masks.  The
    plan finds them on its own (no count is given) and splits each into
    items of the least chunk; dead tiles take no item."""
    n_groups, s = 745472 // 8, 50
    mask = torch.zeros((n_groups, s), dtype=torch.int32)
    live = torch.tensor([6, 7, 20_000, 93_183])   # three tiles of 8
    mask[live] = 0x7FFF
    cnt, chunk, n_items = tr.pgwalk_plan(mask, 8, 4, 132 * 8)
    assert chunk == 4
    assert int((cnt > 0).sum()) == 3 and int(cnt.sum()) == 3 * 15 * s
    assert n_items == 3 * (-(-15 * s // 4))


def test_pgwalk_device_plan_needs_cuda_tensors():
    """The device plan is read back from a launch: CPU tensors raise, and
    so does a mask of the wrong number of groups, before any launch."""
    rays8 = torch.zeros((64, 8))
    woop = torch.zeros((1, 16, tr.CLUSTER))
    before = dict(tr.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        tr.pgwalk_device_plan(torch.zeros((8, 2), dtype=torch.int32), rays8,
                              woop)
    with pytest.raises(ValueError, match="groups"):
        tr.pgwalk_device_plan(torch.zeros((7, 2), dtype=torch.int32), rays8,
                              woop)
    assert tr.launch_counts == before
