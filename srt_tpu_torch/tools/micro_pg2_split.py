"""The per-group walk split into its two kernels on the real bounce
wavefronts of the headline frame (``tools/micro_pg2_split.py``'s
counterpart): for each bounce after the first and each group size G, the
wall ms of B3 (``traversal.cull_pg2``) and of B4 (``traversal.pgwalk2``)
and, on the card, each one's device ms (``common.device_ms``),
the live groups, their list entries and the clusters a group walks; then
shadow-style any-hit rays from the same origins toward the nearest light
through the tiled walk and ``pg2:32:4`` / ``pg2:64:4`` / ``pg2:128:4``,
with their agreement.

Run as ``python3 -m srt_tpu_torch.tools.micro_pg2_split [--device DEV]
[--rows R] [--cols C] [--size N] [--spp S] [--groups 16,32,64,128]
[--widths 4] [--reps R] [--dump PATH [--dump-only]]`` (``SRT_SPP``,
``SRT_GLIST``, ``SRT_WLIST`` as in JAX's tool).  W is a TPU unroll width:
B4 takes it and computes the same, so each W repeats the same walk.
``--dump PATH`` writes every bounce's rays (``b{k}_o``, ``b{k}_d``,
``b{k}_alive``, and ``b{k}_pix``, the sample ids) to a compressed numpy
file, as JAX's ``SRT_DUMP`` does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.ops import traversal
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common, wavefronts

PACK = 1024     # rays8 rows pad to a multiple of every G (JAX's 128 * 8)


def shadow_rays(lights, o_b, t_max):
    """Segments from each origin toward its nearest light, live where
    ``t_max`` > 0: (dirs [3, W], t_max [W])."""
    lp = lights.position.T                                    # [3, L]
    d2 = ((lp[:, None, :] - o_b[:, :, None]) ** 2).sum(0)
    delta = lp[:, d2.argmin(1)] - o_b
    dist = torch.sqrt((delta * delta).sum(0))
    sdir = delta / torch.clamp_min(dist, 1e-9)[None, :]
    return sdir, torch.where(t_max > 0, dist, 0.0)


def dump_waves(path, waves, spp):
    np.savez_compressed(
        path, spp=spp,
        **{f"b{b}_{k}": v.cpu().numpy()
           for b, (o, d, a) in enumerate(waves.work)
           for k, v in (("o", o), ("d", d), ("alive", a))},
        **{f"b{b}_pix": p.cpu().numpy() for b, p in enumerate(waves.pix)})


def run(device=None, scene=None, rows: int = 160, cols: int = 320,
        size: int = 1024, spp: int = 1, groups=(16, 32, 64, 128),
        widths=(4,), reps: int = 10, dump=None, dump_only: bool = False,
        verbose: bool = True):
    """Records: ``case`` "split" (``bounce``, ``live``, ``group``,
    ``width``, ``cull_ms``, ``walk_ms``, ``total_ms`` (wall),
    ``cull_device_ms``, ``walk_device_ms`` (None on the CPU), ``mrays_s``,
    ``groups_live``, ``groups``, ``entries_mean``, ``clusters_mean``,
    ``clusters_p90``) and "shadow" (``bounce``, ``occluded``,
    ``tiled_ms``, then ``ms``, ``speedup``, ``agree`` a mode under
    ``modes``)."""
    dev = resolve(device)
    card = common.header("micro_pg2_split", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    lights = model_scene_lights(dev)
    waves = wavefronts.headline(scene, size, spp=spp, uniform_use_spec=True)
    if dump:
        dump_waves(dump, waves, spp)
        if verbose:
            print(f"dumped {len(waves.work)} bounces to {dump}", flush=True)
        if dump_only:
            return []
    n = size * size * spp
    woop, _, sbounds, cb8, s_count, _ = traversal.model_tables(scene, 0)
    records = []
    for b, (origins, dirs, alive) in enumerate(waves.work):
        n_alive = int(alive.sum())
        if n_alive == 0 or b == 0:
            continue
        width = common.live_width(n_alive, n)
        o_b, d_b = origins[:, :width], dirs[:, :width]
        t_max = torch.where(alive[:width], float("inf"), 0.0)
        rays8 = traversal.pack_rays(scene, 0, o_b, d_b, t_max, PACK)[0]
        if verbose:
            print(f"--- bounce {b + 1}: {n_alive} live (width {width}) ---",
                  flush=True)
        for g in groups:
            def cull(g=g):
                return traversal.cull_pg2(rays8, cb8, s_count, g, sbounds)
            dt_c = common.wall_s(cull, dev=dev, reps=reps)
            cull_dev = common.device_ms(cull, dev)[0]
            clist, bits, counts = cull()
            cnt = counts[:, 0].cpu().numpy()
            pc = common.popcount16(bits.cpu().numpy().astype(np.int64))
            listed = np.arange(pc.shape[1])[None, :] < cnt[:, None]
            cl_grp = np.where(listed, pc, 0).sum(1)
            live = cl_grp[cnt > 0]
            for w in widths:
                def walk(g=g):
                    return traversal.pgwalk2(clist, bits, counts, rays8, woop,
                                             g)
                dt_w = common.wall_s(walk, dev=dev, reps=reps)
                rec = dict(
                    case="split", bounce=b + 1, live=n_alive, group=g,
                    width=w, cull_ms=dt_c * 1e3, walk_ms=dt_w * 1e3,
                    cull_device_ms=cull_dev,
                    walk_device_ms=common.device_ms(walk, dev)[0],
                    total_ms=(dt_c + dt_w) * 1e3,
                    mrays_s=n_alive / (dt_c + dt_w) / 1e6,
                    groups_live=int((cnt > 0).sum()), groups=int(cnt.size),
                    entries_mean=float(cnt[cnt > 0].mean()) if live.size
                    else 0.0,
                    clusters_mean=float(live.mean()) if live.size else 0.0,
                    clusters_p90=float(np.percentile(live, 90))
                    if live.size else 0.0, device=card)
                records.append(rec)
                if verbose:
                    print(f"  pg2:{g}:{w}  cull {dt_c * 1e3:7.3f} ms  walk "
                          f"{dt_w * 1e3:7.3f} ms  total "
                          f"{rec['total_ms']:7.3f} ms  "
                          f"({rec['mrays_s']:6.1f} Mrays/s)  groups live "
                          f"{rec['groups_live']}/{rec['groups']} entries "
                          f"mean {rec['entries_mean']:.1f} clusters/grp "
                          f"mean {rec['clusters_mean']:.1f} p90 "
                          f"{rec['clusters_p90']:.0f}"
                          f"{_device_note(rec)}", flush=True)

        sdir, s_tm = shadow_rays(lights, o_b, t_max)

        def shadow(mode=False):
            return traversal.model_hit(scene, 0, o_b, sdir, s_tm, tile=128,
                                       any_hit=True, t_min=1e-3, binned=mode)
        dt_st = common.wall_s(shadow, dev=dev, reps=reps)
        occ_t = shadow()[1] >= 0
        rec = dict(case="shadow", bounce=b + 1,
                   occluded=float(occ_t.float().mean()),
                   tiled_ms=dt_st * 1e3, modes={}, device=card)
        line = (f"  shadow (occl {rec['occluded']:.2f}): tiled "
                f"{dt_st * 1e3:7.3f} ms")
        for mode in ("pg2:32:4", "pg2:64:4", "pg2:128:4"):
            dt_sp = common.wall_s(lambda m=mode: shadow(m), dev=dev,
                                  reps=reps)
            agree = float((occ_t == (shadow(mode)[1] >= 0)).float().mean())
            rec["modes"][mode] = dict(ms=dt_sp * 1e3, speedup=dt_st / dt_sp,
                                      agree=agree)
            line += (f"  {mode} {dt_sp * 1e3:7.3f} ms "
                     f"({dt_st / dt_sp:4.2f}x ag={agree:.4f})")
        records.append(rec)
        if verbose:
            print(line, flush=True)
    return records


def _device_note(rec) -> str:
    if rec["cull_device_ms"] is None:
        return ""
    return (f"  (device: cull {rec['cull_device_ms']:.4f} ms, walk "
            f"{rec['walk_device_ms']:.4f} ms)")


def _ints(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_headline(ap, reps=10)
    ap.add_argument("--spp", type=int, default=common.env_int("SRT_SPP", 1))
    ap.add_argument("--groups", type=_ints,
                    default=os.environ.get("SRT_GLIST", "16,32,64,128"))
    ap.add_argument("--widths", type=_ints,
                    default=os.environ.get("SRT_WLIST", "4"))
    ap.add_argument("--dump", help="write the bounces' rays here (.npz)")
    ap.add_argument("--dump-only", action="store_true")
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_pg2_split", args.device)
    if dev is None:
        return 2
    run(dev, None, args.rows, args.cols, args.size, args.spp, args.groups,
        args.widths, args.reps, args.dump, args.dump_only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
