"""The tiled walk on the real bounce wavefronts of the headline frame
(``tools/micro_bounce_real.py``'s counterpart): for the rays entering
each bounce after the first, the closest-hit walk's wall ms and live
Mrays/s at tiles 256 and 128, and B1's active-super histogram at tile 128
(how many supers each live tile's union enters: what drives B2's cost).

Run as ``python3 -m srt_tpu_torch.tools.micro_bounce_real [--device DEV]
[--rows R] [--cols C] [--size N] [--reps R]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.ops import traversal
from srt_tpu_torch.tools import common, wavefronts


def run(device=None, scene=None, rows: int = 160, cols: int = 320,
        size: int = 1024, reps: int = 5, verbose: bool = True):
    """Records: ``case`` "walk" (``bounce``, ``live``, ``width``,
    ``tile``, ``ms``, ``mrays_s``) and "cull" (``bounce``, ``supers``,
    ``live_tiles``, ``tiles``, ``mean``, ``p50``, ``p90``, ``max``)."""
    dev = resolve(device)
    card = common.header("micro_bounce_real", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    waves = wavefronts.headline(scene, size)
    n = size * size
    n_b = len(waves.work)
    sbounds = traversal.model_tables(scene, 0)[2]
    records = []
    for b, (origins, dirs, alive) in enumerate(waves.work[1:], start=1):
        n_alive = int(alive.sum())
        if n_alive == 0:
            continue
        width = common.live_width(n_alive, n)
        o_b, d_b = origins[:, :width], dirs[:, :width]
        t_max = torch.where(alive[:width], float("inf"), 0.0)
        if verbose:
            print(f"--- rays entering bounce {b + 1}/{n_b}: {n_alive} live "
                  f"(sliced to {width}) ---", flush=True)
        for tile in (256, 128):
            dt = common.wall_s(lambda t=tile: traversal.model_hit(
                scene, 0, o_b, d_b, t_max, tile=t, refine=False), dev=dev,
                reps=reps)
            records.append(dict(case="walk", bounce=b + 1, live=n_alive,
                                width=width, tile=tile, ms=dt * 1e3,
                                mrays_s=n_alive / dt / 1e6, device=card))
            if verbose:
                print(f"  closest-hit tile={tile}: {dt * 1e3:8.3f} ms "
                      f"({n_alive / dt / 1e6:7.1f} Mrays/s live)", flush=True)
        rays8 = traversal.pack_rays(scene, 0, o_b, d_b, t_max, 128)[0]
        counts = traversal.cull(rays8, sbounds, 128)[2]
        c = counts.view(-1).cpu().numpy()
        live = c[c > 0]
        stat = dict(case="cull", bounce=b + 1, supers=sbounds.shape[1],
                    live_tiles=int(live.size), tiles=int(c.size),
                    mean=float(live.mean()) if live.size else 0.0,
                    p50=float(np.percentile(live, 50)) if live.size else 0.0,
                    p90=float(np.percentile(live, 90)) if live.size else 0.0,
                    max=int(live.max()) if live.size else 0, device=card)
        records.append(stat)
        if verbose:
            print(f"  cull tile=128: {stat['supers']} supers total; live "
                  f"tiles {stat['live_tiles']}/{stat['tiles']}; active "
                  f"supers/live tile: mean {stat['mean']:.1f}, p50 "
                  f"{stat['p50']:.0f}, p90 {stat['p90']:.0f}, max "
                  f"{stat['max']}", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_headline(ap, reps=5)
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_bounce_real", args.device)
    if dev is None:
        return 2
    run(dev, None, args.rows, args.cols, args.size, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
