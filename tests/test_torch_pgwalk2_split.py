"""The split of B4's per-group walk (``csrc/pgwalk2.cu``) is legal.

The kernel deals each group's listed clusters round-robin in list order
over P blocks and takes the lexicographic minimum of (t, index) of their
results per ray, min(t_max, BIG) and -1 where no block found a candidate.
Here the same split runs through the plain version (``pgwalk2_plain`` on
each part's lists) and must equal the unsplit plain walk bit for bit and
the interpret-mode Pallas launch as ``tests/test_torch_traversal.py``
holds it (exact reciprocal, verified 1-ulp near-ties only).  One model's
tables holding the sphere twice make every hit an exact tie between
identical triangles in different clusters: the first copy's (smaller)
index must win in the plain walk, in the split and in JAX.  The launch
shape the wrapper picks (``pgwalk2_shape``) is checked for every group
size the wrapper takes."""

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


def split_lists(clist, bits, counts, parts):
    """Each group's listed clusters dealt round-robin in list order: part q
    takes list positions q, q + parts, ... (the kernel's block q).  Each
    part keeps clist and counts and masks the words."""
    words = bits.numpy()
    out = [np.zeros_like(words) for _ in range(parts)]
    for g in range(words.shape[0]):
        k = 0
        for e in range(int(counts[g, 0])):
            for b in range(tr.SUPER):
                if words[g, e] >> b & 1:
                    out[k % parts][g, e] |= 1 << b
                    k += 1
    return [(clist, torch.tensor(o), counts) for o in out]


def merge_parts(results, rays8):
    """Per ray, the lexicographic min of (t, index) over the parts' hits;
    min(t_max, BIG) and -1 where no part hit (the kernel's merge)."""
    best_t = torch.clamp_max(rays8[:, 6], tr.BIG).clone()
    best_i = torch.full_like(best_t, -1, dtype=torch.int32)
    for t, i in results:
        t, i = t[:, 0], i[:, 0]
        better = (i >= 0) & ((best_i < 0) | (t < best_t)
                             | ((t == best_t) & (i < best_i)))
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, i, best_i)
    return best_t[:, None], best_i[:, None]


def split_walk(lists, rays8, woop, group, any_hit, parts):
    return merge_parts([tr.pgwalk2_plain(*part, rays8, woop, group, any_hit)
                        for part in split_lists(*lists, parts)], rays8)


def pallas_walk(op, group, any_hit):
    """JAX's pg2 lists and walk on op's operands: (lists as torch, t, i)."""
    lists = jax_tp._launch_cull_pg2(j(op["rays8"]), j(op["cb8_j"]),
                                    j(op["w_bp"]), TILE, True, group=group)
    ref_t, ref_i = jax_tp._launch_pgwalk2(*lists, j(op["rays8"]),
                                          j(op["woop"]), True,
                                          any_hit=any_hit, group=group,
                                          ewidth=4)
    return [torch.tensor(np.asarray(x)) for x in lists], ref_t, ref_i


def max_listed(lists):
    clist, bits, counts = lists
    on = (((bits[..., None] >> torch.arange(tr.SUPER)) & 1) > 0)
    on &= (torch.arange(clist.shape[1])[None, :] < counts)[..., None]
    return int(on.sum((1, 2)).max())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("mixed", [False, True], ids=["live", "mixed"])
@pytest.mark.parametrize("parts", [2, 3])
def test_split_walk_matches_whole_and_pallas(scenes, parts, mixed, group,
                                             any_hit):
    op = operands(scenes[1], 11, mixed, any_hit)
    lists, ref_t, ref_i = pallas_walk(op, group, any_hit)
    assert max_listed(lists) > parts          # some group really splits
    whole = tr.pgwalk2_plain(*lists, op["rays8"], op["woop"], group, any_hit)
    t, i = split_walk(lists, op["rays8"], op["woop"], group, any_hit, parts)
    assert torch.equal(t, whole[0]) and torch.equal(i, whole[1])
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=True)


@pytest.mark.parametrize("parts", [2, 3])
def test_exact_ties_go_to_the_smaller_index(scenes, parts):
    """The sphere twice in one model's tables: the padded cluster table
    and its boxes repeated, so cluster c + 16*S holds cluster c's
    triangles.  Every hit ties exactly; the first copy must win
    everywhere, giving the single sphere's result."""
    group = 32
    op = operands(scenes[1], 11, True, False)
    woop = tr.stream_table(scenes[1], 0)
    n_first = woop.shape[0] * tr.CLUSTER
    single = pallas_walk(dict(op, woop=woop), group, False)[0]
    single = tr.pgwalk2_plain(*single, op["rays8"], woop, group)
    s2 = 2 * op["s"]
    cb8 = torch.cat([op["cb8"], op["cb8"]], 1)
    twice = dict(op, woop=torch.cat([woop, woop]), cb8=cb8, s=s2,
                 **pg2_jax_tables(cb8, s2, cb8.shape[1]))
    lists, ref_t, ref_i = pallas_walk(twice, group, False)
    whole = tr.pgwalk2_plain(*lists, twice["rays8"], twice["woop"], group)
    t, i = split_walk(lists, twice["rays8"], twice["woop"], group, False,
                      parts)
    hit = single[1] >= 0
    assert hit.any()
    for got_t, got_i in (whole, (t, i)):
        assert torch.equal(got_t, single[0]) and torch.equal(got_i, single[1])
    ref_i = np.asarray(ref_i)
    assert (ref_i < n_first).all()            # JAX: the first copy too
    assert_walk_equal(ref_t, ref_i, t, i, twice, nested=True)


@pytest.mark.parametrize("group", [1 << k for k in range(11)])
def test_pgwalk2_shape(group):
    """Threads: a whole number of lanes per ray, at most one pair of
    triangles per lane of a cluster, at most 1024.  Split: 1 when the
    groups fill the card, P > 1 when they are few, never more blocks
    than list slots."""
    sms, list_w = 132, 50
    many = tr.pgwalk2_shape((1 << 24) // group, list_w, group, sms)
    few = tr.pgwalk2_shape(max(1, 256 // group), list_w, group, sms)
    for threads, _ in (many, few):
        assert threads % group == 0 and threads <= 1024
        assert threads // group <= tr.CLUSTER // 2
        assert threads >= min(128, 64 * group)
    assert many[1] == 1
    assert 1 < few[1] <= min(tr.PGWALK2_MAX_PARTS, list_w * tr.SUPER)
    assert tr.pgwalk2_shape(1, 1, group, sms)[1] <= tr.SUPER
