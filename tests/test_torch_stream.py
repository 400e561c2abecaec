"""PyTorch port vs JAX package: the streamed walks (B2s, B4s), the tiled
walk's eval counters (B2c) and the stream dispatch of ``model_hit``.

The plain versions of B2s/B4s are B2's/B4's on the table padded to whole
supers (``traversal.stream_table``); they are held against the
interpret-mode Pallas launches with ``stream=True`` on the same operands.
The model, ``uv_sphere(40, 60)``, has 37 clusters, so the padded tail
super is exercised.  The exact-reciprocal patch and the near-tie rule
(winner ids exact up to verified 1-ulp near-ties, hit masks exact) are
those of ``tests/test_torch_traversal.py``."""

import numpy as np
import pytest
import torch

from srt_tpu.ops import traversal_pallas as jax_tp
from srt_tpu_torch.ops import traversal as tr
from tests.test_torch_traversal import (  # noqa: F401  (fixtures)
    exact_reciprocal, scenes)
from tests.test_torch_traversal import (TILE, assert_walk_equal,
                                        assert_winners_equal, j, operands,
                                        ray_batch)

torch.set_num_threads(2)


def stream_operands(scene, seed, mixed, any_hit):
    op = operands(scene, seed, mixed, any_hit)
    op["woop_s"] = tr.stream_table(scene, 0)
    return op


def test_stream_table_pads_once(scenes):
    _, ps = scenes
    woop = tr.model_tables(ps, 0)[0]
    ws = tr.stream_table(ps, 0)
    assert woop.shape[0] == 37 and ws.shape[0] == 48
    assert torch.equal(ws[:37], woop) and not ws[37:].any()
    assert tr.stream_table(ps, 0) is ws      # built once per table
    with pytest.raises(ValueError, match="whole supers"):
        tr.intersect_stream(*(torch.zeros((8, 1), dtype=torch.int32),) * 2,
                            torch.zeros((8, 1)), torch.zeros((8 * 128, 8)),
                            torch.zeros((3, 8, 16)), woop, 128)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("mixed", [False, True], ids=["live", "mixed"])
def test_intersect_stream_matches_pallas(scenes, mixed, any_hit):
    op = stream_operands(scenes[1], 7, mixed, any_hit)
    clist, elist, counts = jax_tp._launch_cull(j(op["rays8"]),
                                               j(op["sbounds"]), TILE, True)
    ref_t, ref_i = jax_tp._launch(counts, clist, elist, j(op["rays8"]),
                                  j(op["cb"]), j(op["woop_s"]), TILE, True,
                                  any_hit=any_hit, stream=True)
    t, i = tr.intersect_stream(*(torch.tensor(np.asarray(x))
                                 for x in (counts, clist, elist)),
                               op["rays8"], op["cb"], op["woop_s"], TILE,
                               any_hit)
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=False)


@pytest.mark.parametrize("group,any_hit", [(16, False), (32, True)],
                         ids=["16-closest", "32-any"])
def test_pgwalk2_stream_matches_pallas(scenes, group, any_hit):
    op = stream_operands(scenes[1], 11, True, any_hit)
    lists = jax_tp._launch_cull_pg2(j(op["rays8"]), j(op["cb8_j"]),
                                    j(op["w_bp"]), TILE, True, group=group)
    ref_t, ref_i = jax_tp._launch_pgwalk2(*lists, j(op["rays8"]),
                                          j(op["woop_s"]), True,
                                          any_hit=any_hit, group=group,
                                          ewidth=4, stream=True)
    t, i = tr.pgwalk2_stream(*(torch.tensor(np.asarray(x)) for x in lists),
                             op["rays8"], op["woop_s"], group, any_hit)
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=True)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
def test_intersect_count_matches_pallas(scenes, stream, any_hit):
    """B2c counters equal the Pallas ``count_evals=True`` counters exactly,
    and counting leaves the walk's result unchanged."""
    op = stream_operands(scenes[1], 7, True, any_hit)
    woop = op["woop_s"] if stream else op["woop"]
    clist, elist, counts = jax_tp._launch_cull(j(op["rays8"]),
                                               j(op["sbounds"]), TILE, True)
    ref_t, ref_i, ref_c = jax_tp._launch(
        counts, clist, elist, j(op["rays8"]), j(op["cb"]), j(woop), TILE,
        True, any_hit=any_hit, stream=stream, count_evals=True)
    lists = tuple(torch.tensor(np.asarray(x)) for x in (counts, clist, elist))
    t, i, ctr = tr.intersect_count(*lists, op["rays8"], op["cb"], woop,
                                   TILE, any_hit, stream)
    np.testing.assert_array_equal(ctr.numpy(), np.asarray(ref_c))
    assert int(ctr[:, 1].sum()) > int(ctr[:, 0].sum()) > 0
    assert_walk_equal(ref_t, ref_i, t, i, op, nested=False)
    t0, i0 = tr.intersect(*lists, op["rays8"], op["cb"], woop, TILE, any_hit)
    assert torch.equal(t, t0) and torch.equal(i, i0)


def test_model_hit_count_evals(scenes):
    """``model_hit(count_evals=True)`` returns the counters as a fifth
    output, equal to ``pallas_model_hit``'s on the port's tiles (the JAX
    package pads to 8-tile windows; its extra tiles count nothing)."""
    js, ps = scenes
    (o, d, t), (po, pd, pt) = ray_batch(3, True)
    ref = jax_tp.pallas_model_hit(js, 0, o, d, t, tile=TILE,
                                  count_evals=True)
    got = tr.model_hit(ps, 0, po, pd, pt, tile=TILE, count_evals=True)
    assert len(got) == len(ref) == 5
    n_tiles = got[4].shape[0]
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4])[:n_tiles])
    assert not np.asarray(ref[4])[n_tiles:].any()
    np.testing.assert_array_equal(got[1].numpy() >= 0, np.asarray(ref[1]) >= 0)
    with pytest.raises(ValueError, match="tiled walk only"):
        tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned="pg2:32:4",
                     count_evals=True)


@pytest.mark.parametrize("walk", [False, "pg2:32:4"], ids=["tiled", "pg2"])
def test_stream_dispatch_follows_threshold(scenes, monkeypatch, walk):
    """The repaired dispatch: ``stream=None`` takes the streamed walk
    exactly when the model has more than ``STREAM_THRESHOLD_CLUSTERS``
    clusters, as ``pallas_model_hit`` does, and then matches
    ``pallas_model_hit(stream=True)``."""
    js, ps = scenes
    calls = []
    for name in ("intersect", "intersect_stream", "pgwalk2",
                 "pgwalk2_stream"):
        def spy(*a, _fn=getattr(tr, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tr, name, spy)
    resident = "pgwalk2" if walk else "intersect"
    (o, d, t), (po, pd, pt) = ray_batch(3, True)

    assert tr.STREAM_THRESHOLD_CLUSTERS == 1700
    tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk)
    assert calls == [resident]

    calls.clear()
    monkeypatch.setattr(tr, "STREAM_THRESHOLD_CLUSTERS", 36)   # 37 clusters
    got = tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk)
    assert calls == [resident + "_stream"]
    ref = jax_tp.pallas_model_hit(js, 0, o, d, t, tile=TILE, binned=walk,
                                  stream=True)
    rays8, _, _ = tr.pack_rays(ps, 0, po, pd, pt, TILE)
    assert_winners_equal(ref[1], got[1], rays8, ps.woop, bool(walk))
    same = (np.asarray(ref[1]) >= 0) & (np.asarray(ref[1]) == got[1].numpy())
    np.testing.assert_allclose(got[0].numpy()[same], np.asarray(ref[0])[same],
                               rtol=1e-6)

    calls.clear()
    monkeypatch.setattr(tr, "STREAM_THRESHOLD_CLUSTERS", 37)
    tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk)
    assert calls == [resident]
    calls.clear()
    tr.model_hit(ps, 0, po, pd, pt, tile=TILE, binned=walk, stream=True)
    assert calls == [resident + "_stream"]


def test_stream_cpu_launches_no_kernel(scenes):
    _, ps = scenes
    _, (o, d, t) = ray_batch(5, True)
    tr.reset_launch_counts()
    for walk in (False, "pg2:16:4"):
        for any_hit in (False, True):
            tr.model_hit(ps, 0, o, d, t, tile=TILE, binned=walk,
                         any_hit=any_hit, stream=True)
    tr.model_hit(ps, 0, o, d, t, tile=TILE, count_evals=True)
    assert all(v == 0 for v in tr.launch_counts.values())
