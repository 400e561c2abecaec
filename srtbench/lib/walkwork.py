"""The work that any correct walk of the scene's tables must do for one
call, counted by plain code from the call's rays (frozen).

The tables are the scene's clusters (their boxes, ``tris`` triangles
each) grouped into supers of ``per_super`` consecutive clusters.  A live
ray (t_hi > t_lo) costs the slab tests of every super; the slab tests of
the clusters of each super whose box it enters before its final distance;
and the Woop evaluations of every triangle of each cluster whose box it
enters before its final distance.  The final distance is the call's own
answer for a closest-hit ray that hit, else the end of its segment.  An
any-hit ray that is occluded is held to the least any walk can do: one
cluster box and one triangle past the supers.  Boxes that a NaN slab
leaves undecided count as missed.  The count never reads a kernel's
counters or a cull's output.

Bytes: each ray's origin, direction and segment end in (28 B), its t and
triangle out (8 B); the tables read once: 13 float rows of 128 lanes for
each cluster that some ray enters, a box (24 B) for each cluster of an
entered super and for each super.
"""

from __future__ import annotations

import torch

from srtbench.lib import peaks

RAY_BLOCK = 16384


def _enter(o, d, lo, hi, t_lo, t_end):
    """[R, K]: the ray's segment meets box k before ``t_end`` [R]."""
    inv = 1.0 / d[:, None, :]
    t0 = (lo[None] - o[:, None, :]) * inv
    t1 = (hi[None] - o[:, None, :]) * inv
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    return (near <= far) & (far >= t_lo) & (near <= t_end[:, None])


def count_call(cmin, cmax, tris: int, per_super: int, origins, dirs,
               t_lo: float, t_hi, t_out, found, any_hit: bool) -> dict:
    """Work of one walk call: ``origins``/``dirs`` [3, N], ``t_hi`` [N]
    segment ends, ``t_out`` [N] the answers' distances, ``found`` [N]
    whether each ray hit.  Returns rays, slab tests, Woop evaluations and
    bytes."""
    with torch.no_grad():
        c = cmin.shape[0]
        s = -(-c // per_super)
        sid = torch.arange(c, device=cmin.device) // per_super
        smin = torch.full((s, 3), float("inf"), device=cmin.device)
        smax = torch.full((s, 3), -float("inf"), device=cmin.device)
        smin = smin.scatter_reduce(0, sid[:, None].expand(c, 3), cmin,
                                   "amin")
        smax = smax.scatter_reduce(0, sid[:, None].expand(c, 3), cmax,
                                   "amax")
        per = torch.bincount(sid, minlength=s).to(torch.float64)
        o = origins.T.float()
        d = dirs.T.float()
        t_hi = t_hi.float()
        live = t_hi > t_lo
        occluded = live & found if any_hit else torch.zeros_like(live)
        final = t_hi if any_hit else torch.where(found, t_out.float(), t_hi)
        full = live & ~occluded
        n = o.shape[0]
        slab = float(live.sum()) * s + float(occluded.sum())
        woop = float(occluded.sum())
        hit_clusters = torch.zeros(c, dtype=torch.bool, device=o.device)
        hit_supers = torch.zeros(s, dtype=torch.bool, device=o.device)
        idx = full.nonzero()[:, 0]
        for a in range(0, idx.shape[0], RAY_BLOCK):
            r = idx[a:a + RAY_BLOCK]
            es = _enter(o[r], d[r], smin, smax, t_lo, final[r])
            ec = _enter(o[r], d[r], cmin, cmax, t_lo, final[r])
            slab += float((es.to(torch.float64) * per).sum())
            woop += float(ec.sum()) * tris
            hit_clusters |= ec.any(0)
            hit_supers |= es.any(0)
        clusters_of_supers = float(per[hit_supers].sum())
        nbytes = (n * 36 + float(hit_clusters.sum()) * 13 * tris * 4
                  + clusters_of_supers * 24 + s * 24)
        return {"rays": n, "slab": slab, "woop": woop, "bytes": nbytes}


def bound_s(work: dict) -> float:
    """The least time the card could take for the work: the larger of its
    bytes at the HBM peak and its instructions on the busier pipe."""
    alu = (peaks.UNIT_OPS["slab"][0] * work["slab"]
           + peaks.UNIT_OPS["woop"][0] * work["woop"])
    fma = (peaks.UNIT_OPS["slab"][1] * work["slab"]
           + peaks.UNIT_OPS["woop"][1] * work["woop"])
    return max(work["bytes"] / peaks.PEAK_BYTES_S,
               alu / peaks.PEAK_ALU_INSTR_S, fma / peaks.PEAK_FMA_INSTR_S)
