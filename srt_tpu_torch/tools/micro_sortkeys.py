"""Candidate wavefront sort keys on real dumped bounce rays
(``tools/micro_sortkeys.py``'s counterpart): for each key, the per-group
union cluster footprint and a pg2 walk cost model (cluster evaluations a
ray) at G = 8, 16 and 32, for the bounce's rays and for its shadow batch.

It reads a ``--dump`` file of ``micro_pg2_split`` (``dump_waves``:
``b{k}_o``, ``b{k}_d``, ``b{k}_alive``, ``b{k}_pix``, ``spp``).  JAX's
numpy (``occupancy``, ``part1by2``, ``keys``, ``group_cost`` and the
main loop) is carried over unchanged; the cluster boxes come from the
port's ``mesh.upload`` of the headline sphere and the lights from
``scene.model_scene_lights``, in place of the JAX package's.

Run as ``python3 -m srt_tpu_torch.tools.micro_sortkeys DUMP [BOUNCE]
[--device DEV] [--rows R] [--cols C]`` (BOUNCE: the dump's bounce index,
default 2, as in JAX's tool; ``SRT_BENCH_ROWS`` / ``COLS`` as there).
It prints JAX's lines; it times nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common

SUPER, W = 16, 4
GROUPS = (8, 16, 32)


def occupancy(o, d, cmin, cmax, chunk=8192):
    """[N, C] bool cluster occupancy (slab test, t_max = root box exit)."""
    n = o.shape[0]
    c = cmin.shape[0]
    root_lo, root_hi = cmin.min(0), cmax.max(0)
    occ = np.zeros((n, c), bool)
    inv = 1.0 / d
    tb0 = (root_lo[None, :] - o) * inv
    tb1 = (root_hi[None, :] - o) * inv
    bt_near = np.minimum(tb0, tb1).max(1)
    bt_far = np.maximum(tb0, tb1).min(1)
    t_max = np.where((bt_near <= bt_far) & (bt_far >= 0.0),
                     bt_far * 1.0001 + 1e-3, 0.0)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        oo, ii = o[lo:hi], inv[lo:hi]
        t_near = np.full((hi - lo, c), -np.inf, np.float32)
        t_far = np.full((hi - lo, c), np.inf, np.float32)
        for ax in range(3):
            t0 = (cmin[None, :, ax] - oo[:, ax:ax + 1]) * ii[:, ax:ax + 1]
            t1 = (cmax[None, :, ax] - oo[:, ax:ax + 1]) * ii[:, ax:ax + 1]
            t_near = np.maximum(t_near, np.minimum(t0, t1))
            t_far = np.minimum(t_far, np.maximum(t0, t1))
        sel = np.maximum(t_near, 0.0)
        occ[lo:hi] = ((t_near <= t_far) & (t_far >= 0.0)
                      & (sel < t_max[lo:hi, None]))
    return occ


def part1by2(x):
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def keys(o, d, alive, pix, spp):
    """Candidate orderings -> dict name -> argsort permutation."""
    ot = o                                         # [N, 3]
    lo, hi = ot.min(0), ot.max(0)
    q = np.clip((ot - lo) / np.maximum(hi - lo, 1e-6) * 31.0,
                0, 31).astype(np.uint32)
    morton = ((part1by2(q[:, 0]) << 2) | (part1by2(q[:, 1]) << 1)
              | part1by2(q[:, 2]))
    dt = d                                         # [N, 3]
    dn = dt / np.maximum(np.linalg.norm(dt, axis=1, keepdims=True), 1e-9)
    qd = np.clip((dn + 1.0) * 2.0, 0, 3).astype(np.uint32)      # 2b/axis
    dm = (((qd[:, 0] >> 1) << 5) | ((qd[:, 1] >> 1) << 4)
          | ((qd[:, 2] >> 1) << 3) | ((qd[:, 0] & 1) << 2)
          | ((qd[:, 1] & 1) << 1) | (qd[:, 2] & 1))
    qd3 = np.clip((dn + 1.0) * 4.0, 0, 7).astype(np.uint32)     # 3b/axis
    dm3 = ((part1by2(qd3[:, 0]) << 2) | (part1by2(qd3[:, 1]) << 1)
           | part1by2(qd3[:, 2])) & np.uint32(0x1FF)
    dead = (~alive).astype(np.uint64) << np.uint64(40)
    out = {
        "current(cell,cone2)": dead | (morton.astype(np.uint64) << 6)
        | dm.astype(np.uint64),
        "cone2,cell": dead | (dm.astype(np.uint64) << 15)
        | morton.astype(np.uint64),
        "cell,cone3": dead | (morton.astype(np.uint64) << 9)
        | dm3.astype(np.uint64),
        "cone3,cell": dead | (dm3.astype(np.uint64) << 15)
        | morton.astype(np.uint64),
        "sampleid": dead | pix.astype(np.uint64),
    }
    # Finer direction cells and a 6-D interleave.
    qd4 = np.clip((dn + 1.0) * 8.0, 0, 15).astype(np.uint32)    # 4b/axis
    dm4 = ((part1by2(qd4[:, 0]) << 2) | (part1by2(qd4[:, 1]) << 1)
           | part1by2(qd4[:, 2])) & np.uint32(0xFFF)
    qd5 = np.clip((dn + 1.0) * 16.0, 0, 31).astype(np.uint32)   # 5b/axis
    dm5 = ((part1by2(qd5[:, 0]) << 2) | (part1by2(qd5[:, 1]) << 1)
           | part1by2(qd5[:, 2]))
    out["cone4,cell"] = dead | (dm4.astype(np.uint64) << 15) \
        | morton.astype(np.uint64)
    out["cone5,cell"] = dead | (dm5.astype(np.uint64) << 15) \
        | morton.astype(np.uint64)
    # Bitwise interleave of the 15-bit direction code and the 15-bit
    # origin code (6-D Morton): locality in both at every scale.
    inter = np.zeros(dn.shape[0], np.uint64)
    for i in range(15):
        inter |= (((dm5 >> i) & 1).astype(np.uint64) << (2 * i + 1))
        inter |= (((morton >> i) & 1).astype(np.uint64) << (2 * i))
    out["interleave6d"] = dead | inter
    if spp > 1:
        out["pixel,cone2"] = dead | (
            (pix // spp).astype(np.uint64) << 6) | dm.astype(np.uint64)
    return {k: np.argsort(v, kind="stable") for k, v in out.items()}


def group_cost(occ_sup, rows, g, w=4):
    """(mean union footprint, walk evals/ray) for G-ray groups of ``rows``
    (row indices into occ_sup [m, S, 16])."""
    mg = (rows.shape[0] // g) * g
    grp = occ_sup[rows[:mg]].reshape(mg // g, g, occ_sup.shape[1], 16)
    u = grp.any(1)
    pc = u.sum(2)
    union = pc.sum(1)
    iters = np.maximum(-(-pc // w), (pc > 0)).sum(1)
    return union.mean(), iters.sum() * w / mg


def sort_keys(z, b: int, cmin, cmax, light_pos):
    """JAX's ``main`` on the loaded dump ``z`` at bounce index ``b``:
    records ``case`` "footprint" (``bounce``, ``live``, ``rays``,
    ``spp``, ``clusters``, ``mean``, ``p50``, ``p90``), "shadow"
    (``rays``, ``mean``; when the dump holds bounce b + 1) and one "key"
    a sort key (``key``, ``groups`` {G: (fp, ev/ray)}, ``shadow``: (fp,
    ev/ray) at G = 32, or None)."""
    spp = int(z["spp"])
    o, d = z[f"b{b}_o"].T, z[f"b{b}_d"].T          # [N, 3]
    alive = z[f"b{b}_alive"]
    pix = z[f"b{b}_pix"]
    m = alive.sum()
    occ_all = occupancy(o[alive], d[alive], cmin, cmax)
    per_ray = occ_all.sum(1)
    records = [dict(case="footprint", bounce=b + 1, live=int(m),
                    rays=o.shape[0], spp=spp, clusters=cmin.shape[0],
                    mean=float(per_ray.mean()),
                    p50=float(np.median(per_ray)),
                    p90=float(np.percentile(per_ray, 90)))]
    idx_alive = np.where(alive)[0]
    rank_of = np.full(o.shape[0], -1, np.int64)
    rank_of[idx_alive] = np.arange(m)

    c = cmin.shape[0]
    s_count = -(-c // SUPER)

    def to_sup(occ):
        mm = occ.shape[0]
        occ_pad = np.zeros((mm, s_count * SUPER), bool)
        occ_pad[:, :c] = occ
        return occ_pad.reshape(mm, s_count, SUPER)

    occ_sup = to_sup(occ_all)

    # Shadow batch for this wavefront order: rays that hit cast p -> light
    # (nearest light as the RIS-pick stand-in).  Hit points come from the
    # next bounce's origins, mapped back via sample ids.
    occ_sh_sup = None
    if f"b{b + 1}_o" in z:
        o_next, pix_next = z[f"b{b + 1}_o"].T, z[f"b{b + 1}_pix"]
        hit_next = z[f"b{b + 1}_alive"]
        lp = light_pos                                      # [L, 3]
        pos_of_sid = np.full(pix_next.max() + 1, -1, np.int64)
        pos_of_sid[pix_next] = np.arange(pix_next.shape[0])
        nxt = pos_of_sid[pix]                               # [N]
        sh_mask = alive & (nxt >= 0) & hit_next[nxt]
        p = o_next[nxt[sh_mask]]                            # [Msh, 3]
        d2 = ((lp[None, :, :] - p[:, None, :]) ** 2).sum(2)
        pick = d2.argmin(1)
        delta = lp[pick] - p
        dist = np.linalg.norm(delta, axis=1)
        sdir = delta / np.maximum(dist, 1e-9)[:, None]
        occ_sh = occupancy(p, sdir, cmin, cmax)
        occ_sh_sup = to_sup(occ_sh)
        rank_sh = np.full(o.shape[0], -1, np.int64)
        rank_sh[np.where(sh_mask)[0]] = np.arange(sh_mask.sum())
        records.append(dict(case="shadow", rays=int(sh_mask.sum()),
                            mean=float(occ_sh.sum(1).mean())))

    for name, perm in keys(o, d, alive, pix, spp).items():
        rows = rank_of[perm[rank_of[perm] >= 0]]
        rec = dict(case="key", key=name, groups={}, shadow=None)
        for g in GROUPS:
            fp, ev = group_cost(occ_sup, rows, g, W)
            rec["groups"][g] = (float(fp), float(ev))
        if occ_sh_sup is not None:
            rows_sh = rank_sh[perm[rank_sh[perm] >= 0]]
            fp, ev = group_cost(occ_sh_sup, rows_sh, 32, W)
            rec["shadow"] = (float(fp), float(ev))
        records.append(rec)
    return records


def line(rec) -> str:
    """JAX's printed line of a record."""
    if rec["case"] == "footprint":
        return (f"bounce {rec['bounce']}: {rec['live']} live of "
                f"{rec['rays']}, spp={rec['spp']}, {rec['clusters']} "
                f"clusters\n  per-ray footprint: mean {rec['mean']:.1f} "
                f"p50 {rec['p50']:.0f} p90 {rec['p90']:.0f}")
    if rec["case"] == "shadow":
        return (f"  shadow batch: {rec['rays']} rays, per-ray fp "
                f"mean {rec['mean']:.1f}")
    text = f"  {rec['key']:22s}"
    for g, (fp, ev) in rec["groups"].items():
        text += f" | G={g}: fp {fp:5.1f} ev/ray {ev:5.2f}"
    if rec["shadow"] is not None:
        fp, ev = rec["shadow"]
        text += f" | SH G=32: fp {fp:5.1f} ev/ray {ev:5.2f}"
    return text


def run(device=None, scene=None, dump: str = None, bounce: int = 2,
        rows: int = 160, cols: int = 320, verbose: bool = True):
    """``sort_keys``' records of the ``dump`` file at ``bounce``, each
    with the card's line as ``device``; the cluster boxes are ``scene``'s
    (default: the headline sphere of ``rows`` x ``cols``, uploaded to the
    device)."""
    dev = resolve(device)
    if dump is None:
        raise ValueError("micro_sortkeys reads a micro_pg2_split dump")
    card = common.header("micro_sortkeys", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    z = np.load(dump if dump.endswith(".npz") else dump + ".npz")
    records = sort_keys(z, bounce, scene.cluster_min.cpu().numpy(),
                        scene.cluster_max.cpu().numpy(),
                        model_scene_lights(dev).position.cpu().numpy())
    for rec in records:
        rec["device"] = card
        if verbose:
            print(line(rec), flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    d = common.headline_defaults()
    common.add_device(ap)
    ap.add_argument("dump", nargs="?", help="a micro_pg2_split --dump file")
    ap.add_argument("bounce", nargs="?", type=int, default=2)
    ap.add_argument("--rows", type=int, default=d["rows"])
    ap.add_argument("--cols", type=int, default=d["cols"])
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_sortkeys", args.device)
    if dev is None:
        return 2
    if args.dump is None:
        ap.error("a dump file is required")
    run(dev, None, args.dump, args.bounce, args.rows, args.cols)
    return 0


if __name__ == "__main__":
    sys.exit(main())
