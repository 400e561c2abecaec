"""The orders of work of B6 (``csrc/cull_gmask.cu``) and B5
(``csrc/cull_perray.cu``) give their functions' results.

Each kernel's order of work is written out here as a plain PyTorch twin
and held against the port's plain version and the interpret-mode Pallas
launch, bit for bit:

* B6 takes one warp per group of 8 rays (or per two consecutive groups,
  one after the other).  Each lane pre-tests a super's box (``sbounds``)
  against the group's live rays in the ``(box - o) * inv`` form, a NaN
  super test counting as entering; the group runs the 16 cluster tests of
  a super only when one of its live rays may enter it; each cluster's bit
  is the OR over the group's live rays.  ``gmask_twin`` must equal ``_group_words(..., fma_form=False)``
  and ``_launch_cull_gmask``, no cluster of a failed super may be
  entered, and some groups must skip some supers.
* B5 takes one lane per (group, super) item, a warp's items those of
  one or four consecutive groups: the minimum over the group's rays of
  each entry max(t_near, 0) that passes, else BIG, in registers.
  ``perray_twin`` must equal ``cull_perray_plain`` and
  ``_launch_cull_perray`` (-0 and +0 compare equal).

Inputs: rays aimed at a sphere, axis-parallel rays, rays starting on box
faces and at zero coordinates, all live, a third dead and all dead, on a
model whose last super is partial; and random boxes at S = 50, 64 and 246
with dead, half-dead, on-face and zero-direction tiles.  No test needs a
card; the launch shape (``group_cull_shape``) is checked on the frames'
launch sizes."""

import numpy as np
import pytest
import torch

from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu_torch.ops import traversal as tr
from tests.test_torch_cull_walk_split import cull_rays
from tests.test_torch_traversal import (  # noqa: F401  (fixtures)
    exact_reciprocal, scenes)
from tests.test_torch_traversal import TILE, j, pg2_jax_tables

torch.set_num_threads(2)

GROUP = tr.GROUP


def live_rays(rays8):
    """The kernels' per-ray liveness (t_max > 0), [Np, 1]."""
    return rays8[:, 6:7] > 0.0


def gmask_twin(rays8, cb8, sbounds, s_count):
    """B6's order of work.  Returns (words [Np/8, S], enter [Np, S] — the
    ray's super pre-test, tested [Np/8, S] — the supers whose cluster
    tests the group ran)."""
    c = tr._ray_cols(rays8)
    inv = [1.0 / c[3 + a] for a in range(3)]
    live = live_rays(rays8)
    tn, tf, sel = tr._slab([sbounds[a] for a in range(3)],
                           [sbounds[3 + a] for a in range(3)], c[0:3], inv,
                           False)
    nan = torch.isnan(tn) | torch.isnan(tf)
    enter = live & (nan | ((tn <= tf) & (tf >= 0.0) & (sel < c[6])))
    tested = enter.view(-1, GROUP, s_count).any(1)
    n_cl = s_count * tr.SUPER
    tn, tf, sel = tr._slab([cb8[a, :n_cl] for a in range(3)],
                           [cb8[3 + a, :n_cl] for a in range(3)], c[0:3],
                           inv, False)
    hit = live & (tn <= tf) & (tf >= 0.0) & (sel < c[6])
    # Exactness of the pre-test: no cluster of a failed super is entered.
    assert not (hit & ~enter.repeat_interleave(tr.SUPER, 1)).any()
    hit = hit.view(-1, GROUP, s_count, tr.SUPER) & tested[:, None, :, None]
    occ = hit.any(1)
    shifts = torch.arange(tr.SUPER, dtype=torch.int32)
    words = (occ.to(torch.int32) << shifts).sum(-1, dtype=torch.int32)
    return words, enter, tested


def perray_twin(rays8, sbounds):
    """B5's order of work: per (group, super) item, the running minimum
    over the group's rays k = 0..7, live rays only, of each passing entry
    max(t_near, 0), starting from BIG."""
    c = tr._ray_cols(rays8)
    inv = [1.0 / c[3 + a] for a in range(3)]
    tn, tf, sel = tr._slab([sbounds[a] for a in range(3)],
                           [sbounds[3 + a] for a in range(3)], c[0:3], inv,
                           False)
    ok = live_rays(rays8) & (tn <= tf) & (tf >= 0.0) & (sel < c[6])
    s = sbounds.shape[1]
    ok = ok.view(-1, GROUP, s)
    sel = sel.view(-1, GROUP, s)
    v = torch.full(ok[:, 0].shape, tr.BIG)
    for k in range(GROUP):
        v = torch.where(ok[:, k], torch.minimum(v, sel[:, k]), v)
    return v


def random_cluster_case(s, seed):
    """s supers of 16 random cluster boxes around a random centre each,
    the last super's 5 last clusters NaN padding (cb8 [8, 16*s]), and 1024
    rays in 8 tiles of 128: tile 0 dead, tile 1 half dead, tile 2
    starting on a cluster's low-x face going out, tile 3 with zero
    direction components (some from a face on the zero axis), the rest
    random.  Returns (rays8, cb8, number of real clusters)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-3.0, 3.0, (s, 1, 3))
    c = (centre + rng.uniform(-0.6, 0.6, (s, tr.SUPER, 3))).reshape(-1, 3)
    h = rng.uniform(0.02, 0.3, (s * tr.SUPER, 3))
    n_cl = s * tr.SUPER - 5
    cb8 = np.full((8, s * tr.SUPER), np.nan, np.float32)
    cb8[6:] = 0.0
    cb8[0:3, :n_cl] = (c - h)[:n_cl].T
    cb8[3:6, :n_cl] = (c + h)[:n_cl].T
    n = 8 * TILE
    o = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    t = np.where(rng.random(n) < 0.5, np.inf,
                 rng.uniform(0.5, 8.0, n)).astype(np.float32)
    t[:TILE] = 0.0
    t[TILE:2 * TILE:2] = 0.0
    face = np.arange(2 * TILE, 3 * TILE)
    box = rng.integers(0, n_cl, TILE)
    o[face] = c[box]
    o[face, 0] = cb8[0, box]
    d[face, 0] = -np.abs(d[face, 0]) - 0.1
    axis = np.arange(3 * TILE, 4 * TILE)
    d[axis, axis % 3] = 0.0
    d[axis[::4], (axis[::4] + 1) % 3] = 0.0
    zero_face = axis[1::8]
    o[zero_face, zero_face % 3] = cb8[zero_face % 3, zero_face % n_cl]
    rays8 = np.zeros((n, 8), np.float32)
    rays8[:, 0:3] = o
    rays8[:, 3:6] = d
    rays8[:, 6] = t
    return torch.tensor(rays8), torch.tensor(cb8), n_cl


def sphere_case(scenes, dead):
    _, ps = scenes
    _, _, sbounds, cb8, s, n_cl = tr.model_tables(ps, 0)
    assert n_cl % tr.SUPER                    # a partial last super
    return cull_rays(cb8, sbounds, dead), cb8, sbounds, s, n_cl


def random_case(s):
    rays8, cb8, n_cl = random_cluster_case(s, s)
    return rays8, cb8, tr.super_bounds(cb8, s), s, n_cl


def check_gmask(rays8, cb8, sbounds, s, n_cl, all_dead):
    words, enter, tested = gmask_twin(rays8, cb8, sbounds, s)
    assert torch.equal(words, tr._group_words(rays8, cb8, s, GROUP, False))
    assert torch.equal(words, tr.cull_gmask(rays8, cb8, s, sbounds))
    jt = pg2_jax_tables(cb8, s, n_cl)
    ref = jax_tp._launch_cull_gmask(j(rays8), j(jt["cb8_j"]), j(jt["w_bp"]),
                                    TILE, True)
    np.testing.assert_array_equal(words.numpy(), np.asarray(ref))
    if all_dead:
        assert not enter.any() and not words.any()
        return
    assert words.any()
    busy = tested.any(1)
    assert not tested[busy].all()             # some groups skip some supers
    c = tr._ray_cols(rays8)
    assert bool((torch.cat(c[3:6], 1) == 0.0).any())   # infinite reciprocals


def check_perray(rays8, sbounds, all_dead):
    got = perray_twin(rays8, sbounds)
    assert torch.equal(got, tr.cull_perray_plain(rays8, sbounds))
    assert torch.equal(got, tr.cull_perray(rays8, sbounds))
    ref = jax_tp._launch_cull_perray(j(rays8), j(sbounds), TILE, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if all_dead:
        assert bool((got == tr.BIG).all())
    else:
        assert (got < tr.BIG).any() and (got == tr.BIG).any()
        assert bool((got == 0.0).any())       # rays starting inside a box


@pytest.mark.parametrize("dead", ["live", "third", "all"])
def test_gmask_twin_on_the_sphere(scenes, dead):
    rays8, cb8, sbounds, s, n_cl = sphere_case(scenes, dead)
    assert torch.equal(tr.super_bounds(cb8, s), sbounds)
    check_gmask(rays8, cb8, sbounds, s, n_cl, dead == "all")


@pytest.mark.parametrize("s", [50, 64, 246])
def test_gmask_twin_on_random_boxes(s):
    check_gmask(*random_case(s), all_dead=False)


@pytest.mark.parametrize("dead", ["live", "third", "all"])
def test_perray_twin_on_the_sphere(scenes, dead):
    rays8, _, sbounds, _, _ = sphere_case(scenes, dead)
    check_perray(rays8, sbounds, dead == "all")


@pytest.mark.parametrize("s", [50, 64, 246])
def test_perray_twin_on_random_boxes(s):
    rays8, _, sbounds, _, _ = random_case(s)
    check_perray(rays8, sbounds, False)


def test_cull_gmask_needs_the_tables_sbounds(scenes):
    """B6 takes the supers' boxes from the caller (``model_tables``'s,
    equal to ``super_bounds`` of the same cb8) and refuses a missing or
    misshapen table before it culls, on any device."""
    rays8, cb8, sbounds, s, _ = sphere_case(scenes, "live")
    with pytest.raises(TypeError):
        tr.cull_gmask(rays8, cb8, s)
    for bad in (sbounds[:, :-1], sbounds[:6], sbounds.T):
        with pytest.raises(ValueError, match="sbounds has shape"):
            tr.cull_gmask(rays8, cb8, s, bad)
        with pytest.raises(ValueError, match="sbounds has shape"):
            tr.cull_gmask(rays8, cb8, s, bad, plain=True)


def test_nan_super_test_counts_as_entering():
    """In B6's form a super test is NaN where the ray starts on the
    super's bound with a zero direction component on that axis (0 * inf);
    it counts as entering, so the group runs the cluster tests.  One
    super of two real clusters, x in [-1, -0.5] and [-0.5, 0]; rays along
    +y from x = 0 (the super's high x: NaN) and from x = -0.25 (inside:
    no NaN).  The words equal the plain version's either way.

    The rule is conservative, not what makes the words exact: a NaN super
    test puts the ray in the plane of the super's bound with no motion
    across it, so each cluster either shares that bound (its own test is
    NaN and fails) or lies off the plane (fails).  No cluster of such a
    super passes, so a rule counting NaN as not entering would give the
    same words; what this checks is the pre-test's verdict (``enter``)
    and that the NaN group's word is 0."""
    cb8 = torch.full((8, tr.SUPER), float("nan"))
    cb8[6:] = 0.0
    cb8[:6, 0] = torch.tensor([-1.0, -1.0, -1.0, -0.5, 1.0, 1.0])
    cb8[:6, 1] = torch.tensor([-0.5, -1.0, -1.0, 0.0, 1.0, 1.0])
    sbounds = tr.super_bounds(cb8, 1)
    rays8 = torch.zeros((2 * GROUP, 8))
    rays8[:, 0] = -0.25
    rays8[:GROUP, 0] = 0.0
    rays8[:, 1] = -3.0
    rays8[:, 4] = 1.0
    rays8[:, 6] = float("inf")
    words, enter, tested = gmask_twin(rays8, cb8, sbounds, 1)
    assert torch.equal(words, tr._group_words(rays8, cb8, 1, GROUP, False))
    c = tr._ray_cols(rays8)
    tn, _, _ = tr._slab([sbounds[a] for a in range(3)],
                        [sbounds[3 + a] for a in range(3)], c[0:3],
                        [1.0 / c[3 + a] for a in range(3)], False)
    assert bool(torch.isnan(tn[:GROUP]).all())
    assert not torch.isnan(tn[GROUP:]).any()
    assert bool(enter.all()) and bool(tested.all())
    assert int(words[0]) == 0                 # no cluster passes on x = 0
    assert int(words[1]) == 0b10              # inside cluster 1's x range


@pytest.mark.parametrize("n_rays, many", [(4096, False), (65536, False),
                                          (745472, True), (1048576, True)])
def test_group_cull_shape_on_the_frames_launches(n_rays, many):
    """On 132 SMs, the binned and pg frames' 4,096-ray launches (a few
    live groups among 512) take one group a warp, so the live ones run
    side by side; their 745,472- and 1,048,576-ray launches take
    ``CULL_WARP_GROUPS`` (B5) or ``CULL_GMASK_WARP_GROUPS`` (B6), whose
    rays load together.  A warp's groups are at most its 32 lanes' rays,
    a block at most 16 warps."""
    for groups in (tr.CULL_WARP_GROUPS, tr.CULL_GMASK_WARP_GROUPS):
        gpw, warps = tr.group_cull_shape(n_rays // GROUP, 132, groups)
        assert gpw == (groups if many else 1)
        assert 1 <= gpw * GROUP <= 32 and 1 <= warps <= 16
