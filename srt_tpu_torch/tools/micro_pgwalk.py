"""The tiled walk against the per-group walks on the real wavefronts of
the headline frame (``tools/micro_pgwalk.py``'s counterpart): for each
bounce, the closest-hit wall ms of the tiled walk (B1 + B2), the pg v1
walk (``binned="pg"``: B6's 16-bit cluster words per 8-ray group, then
B7's scan of them) and the pg2 walks at G = 8, 16, 32 (B3 + B4), each
with its speed-up and its agreement on the winning triangle; shadow-style
any-hit rays from the same origins toward a random light through the
tiled, pg and pg2 walks; B6's own ms (wall, and device on the card) and
the footprint its words give
(clusters and supers a live group enters).

Run as ``python3 -m srt_tpu_torch.tools.micro_pgwalk [--device DEV]
[--rows R] [--cols C] [--size N] [--reps R]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.ops import traversal
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common, wavefronts

CLOSEST_MODES = ("pg", "pg2:8", "pg2:16", "pg2:32")
SHADOW_MODES = ("pg", "pg2:16", "pg2:32")


def _compare(label, run_mode, modes, baseline_ms, ref_idx, reps, dev,
             hit_of):
    """Time each mode against the tiled walk; (line, {mode: ...})."""
    line, out = f"  {label}: tiled {baseline_ms:8.3f} ms", {}
    for mode in modes:
        dt = common.wall_s(lambda m=mode: run_mode(m), dev=dev, reps=reps)
        agree = float((hit_of(run_mode(mode)) == ref_idx).float().mean())
        out[mode] = dict(ms=dt * 1e3, speedup=baseline_ms / (dt * 1e3),
                         agree=agree)
        line += (f"  {mode} {dt * 1e3:7.3f} ms "
                 f"({out[mode]['speedup']:4.2f}x ag={agree:.4f})")
    return line, out


def run(device=None, scene=None, rows: int = 160, cols: int = 320,
        size: int = 1024, reps: int = 5, verbose: bool = True):
    """Records: ``case`` "closest" and "shadow" (``bounce``, ``tiled_ms``,
    ``modes``: {mode: ``ms``, ``speedup``, ``agree``}) and "gmask"
    (``bounce``, ``ms``, ``device_ms`` (None on the CPU), ``live_groups``,
    ``groups``, ``clusters_mean``, ``clusters_p90``, ``clusters_max``,
    ``supers_mean``)."""
    dev = resolve(device)
    card = common.header("micro_pgwalk", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    lights = model_scene_lights(dev)
    if verbose:
        print(f"scene: {scene.model_tri_count[0]} tris, {scene.woop.shape[0]} "
              f"clusters; {size}x{size}", flush=True)
    waves = wavefronts.headline(scene, size)
    n = size * size
    _, _, sbounds, cb8, s_count, _ = traversal.model_tables(scene, 0)
    records = []
    for b, (origins, dirs, alive) in enumerate(waves.work):
        n_alive = int(alive.sum())
        if n_alive == 0:
            continue
        width = common.live_width(n_alive, n)
        o_b, d_b = origins[:, :width], dirs[:, :width]
        t_max = torch.where(alive[:width], float("inf"), 0.0)
        if verbose:
            print(f"--- bounce {b + 1}: {n_alive} live (width {width}) ---",
                  flush=True)

        def closest(mode=False):
            return traversal.model_hit(scene, 0, o_b, d_b, t_max, tile=128,
                                       refine=False, binned=mode)
        dt_t = common.wall_s(closest, dev=dev, reps=reps) * 1e3
        line, modes = _compare("closest", closest, CLOSEST_MODES, dt_t,
                               closest()[1], reps, dev, lambda r: r[1])
        records.append(dict(case="closest", bounce=b + 1, tiled_ms=dt_t,
                            modes=modes, device=card))
        if verbose:
            print(line, flush=True)

        if b > 0:
            gen = np.random.default_rng(b)
            lp = lights.position.T
            pick = torch.as_tensor(gen.integers(0, lp.shape[1], width),
                                   device=dev)
            delta = lp[:, pick] - o_b
            dist = torch.sqrt((delta * delta).sum(0))
            sdir = delta / torch.clamp_min(dist, 1e-9)[None, :]
            s_tm = torch.where(t_max > 0, dist, 0.0)

            def shadow(mode=False):
                return traversal.model_hit(scene, 0, o_b, sdir, s_tm,
                                           tile=128, any_hit=True,
                                           t_min=1e-3, binned=mode)
            dt_s = common.wall_s(shadow, dev=dev, reps=reps) * 1e3
            line, modes = _compare("shadow ", shadow, SHADOW_MODES, dt_s,
                                   shadow()[1] >= 0, reps, dev,
                                   lambda r: r[1] >= 0)
            records.append(dict(case="shadow", bounce=b + 1, tiled_ms=dt_s,
                                modes=modes, device=card))
            if verbose:
                print(line, flush=True)

        rays8 = traversal.pack_rays(scene, 0, o_b, d_b, t_max, 128 * 8)[0]

        def gmask():
            return traversal.cull_gmask(rays8, cb8, s_count, sbounds)
        dt_g = common.wall_s(gmask, dev=dev, reps=reps)
        g_dev = common.device_ms(gmask, dev)[0]
        m = gmask().cpu().numpy().astype(np.int64)
        grp_cl = common.popcount16(m).sum(1)
        grp_sp = (m != 0).sum(1)
        live = grp_cl[grp_cl > 0]
        rec = dict(case="gmask", bounce=b + 1, ms=dt_g * 1e3, device_ms=g_dev,
                   live_groups=int(live.size), groups=int(grp_cl.size),
                   clusters_mean=float(live.mean()) if live.size else 0.0,
                   clusters_p90=float(np.percentile(live, 90))
                   if live.size else 0.0,
                   clusters_max=int(live.max()) if live.size else 0,
                   supers_mean=float(grp_sp[grp_cl > 0].mean())
                   if live.size else 0.0, device=card)
        records.append(rec)
        if verbose:
            note = "" if g_dev is None else f" (device {g_dev:.4f} ms)"
            print(f"  gmask cull (B6): {dt_g * 1e3:7.3f} ms{note}; live "
                  f"groups {rec['live_groups']}/{rec['groups']}; "
                  f"clusters/group "
                  f"mean {rec['clusters_mean']:.1f} p90 "
                  f"{rec['clusters_p90']:.0f} max {rec['clusters_max']}; "
                  f"supers/group mean {rec['supers_mean']:.1f}", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_headline(ap, reps=5)
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_pgwalk", args.device)
    if dev is None:
        return 2
    run(dev, None, args.rows, args.cols, args.size, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
