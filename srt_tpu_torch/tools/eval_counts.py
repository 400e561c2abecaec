"""Roofline of the tiled walk (B1 + B2) on the real wavefronts of the
headline frame (``tools/eval_counts.py``'s counterpart).

For each bounce's live rays (``wavefronts.headline``) it reports the
supers processed and clusters evaluated (B2c's counters,
``traversal.model_hit(count_evals=True)``), the wall ms of a call without
counters (JAX's number) and, on the card, the device ms of its B1 and B2
launches (CUDA events around each launch: the wall time of a call holds
the host's dispatch of the whole ``model_hit``), then ns a cluster
evaluation, the FP32 operations a second and their share of the card's
peak, from the device time where there is one, and a least-squares fit

    time = a * supers + b * clusters + c * tiles

of the same time, with its largest relative residual.  The yardstick is
the card's: a cluster evaluation is ``tile`` rays x 128 triangles x 52
FP32 operations (PERF.md's kernel table), at 67 TFLOP/s (NVIDIA's H100
SXM data sheet).  The headline's sphere is convex: past bounce 2 only a
few rays stay alive, so the fit also takes each live wavefront's first
half and quarter as rows.  On the card it fits only the launches of at
least one tile an SM: a launch of fewer tiles runs them side by side and
takes the time of its longest tile, which no sum over tiles describes (a
single tile of 91 bounce rays entering 49 of the 50 supers takes as long
as a million primaries).

Run as ``python3 -m srt_tpu_torch.tools.eval_counts [--device DEV]
[--rows R] [--cols C] [--size N] [--tile T] [--reps R]`` (``SRT_TILE``,
default 128, as JAX's tool).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.ops import traversal
from srt_tpu_torch.tools import common, wavefronts

WALK_KERNELS = ("cull", "intersect")


def fit(rows):
    """Least squares of ``seconds = a*supers + b*clusters + c*tiles`` over
    rows (supers, clusters, tiles, seconds, ...): ((a, b, c) in seconds,
    the largest |relative residual|)."""
    x = np.array([[r[0], r[1], r[2]] for r in rows], float)
    y = np.array([r[3] for r in rows], float)
    coef, *_ = np.linalg.lstsq(x, y, rcond=None)
    return coef, float(np.abs((x @ coef - y) / y).max())


def measure(scene, o, d, alive, tile: int, reps: int, dev):
    """One launch's row on the live prefix of a wavefront: (supers,
    clusters, tiles, seconds, device seconds) of the walk at ``tile``.
    Seconds are the wall time of a ``model_hit`` call (JAX's); device
    seconds the card's time of its B1 and B2 launches (CUDA events around
    each, None on the CPU)."""
    t_max = torch.where(alive, float("inf"), 0.0)

    def walk():
        return traversal.model_hit(scene, 0, o, d, t_max, tile=tile,
                                   refine=False)

    secs = common.wall_s(walk, dev=dev, reps=reps)
    with common.kernel_times(dev, WALK_KERNELS) as kt:
        for _ in range(reps):
            walk()
    dev_s = None
    if dev.type == "cuda":
        dev_s = sum(kt.ms(k) for k in WALK_KERNELS) / reps / 1e3
    ctr = traversal.model_hit(scene, 0, o, d, t_max, tile=tile, refine=False,
                              count_evals=True)[4]
    return (int(ctr[:, 0].sum()), int(ctr[:, 1].sum()), ctr.shape[0], secs,
            dev_s)


def run(device=None, scene=None, rows: int = 160, cols: int = 320,
        size: int = 1024, tile: int = 128, reps: int = 5,
        verbose: bool = True):
    """One record a live bounce (``bounce``, ``live``, ``supers``,
    ``clusters``, ``tiles``, ``ms``, ``device_ms`` (None on the CPU),
    ``ns_per_ceval``, ``gflops``,
    ``peak_share``, ``mrays_s``), then one ``fit`` record (``a_ns``,
    ``b_ns``, ``c_ns``, ``residual``, ``b_bound_ns``, ``rows``,
    ``min_tiles``)."""
    dev = resolve(device)
    card = common.header("eval_counts", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    n_super = -(-scene.woop.shape[0] // traversal.SUPER)
    if verbose:
        print(f"scene: {scene.model_tri_count[0]} tris, {scene.woop.shape[0]} "
              f"clusters, {n_super} supers; {size}x{size}; tile={tile}",
              flush=True)
    waves = wavefronts.headline(scene, size)
    n = size * size
    eval_ops = tile * traversal.CLUSTER * common.WOOP_OPS
    records, fit_rows = [], []
    for b, (o, d, alive) in enumerate(waves.work):
        n_alive = int(alive.sum())
        if n_alive == 0:
            continue
        width = common.live_width(n_alive, n)
        row = measure(scene, o[:, :width], d[:, :width], alive[:width], tile,
                      reps, dev)
        sp, ce, n_tiles, wall, dev_s = row
        fit_rows.append(row)
        # The card's own time where there is one: the wall time of a call
        # holds the host's dispatch of the whole model_hit.
        dt = wall if dev_s is None else dev_s
        gf = ce * eval_ops / dt / 1e9
        rec = dict(bounce=b + 1, live=n_alive, supers=sp, clusters=ce,
                   tiles=n_tiles, ms=wall * 1e3,
                   device_ms=None if dev_s is None else dev_s * 1e3,
                   ns_per_ceval=dt / max(ce, 1) * 1e9, gflops=gf,
                   peak_share=gf * 1e9 / common.PEAK_FP32_OPS_S,
                   mrays_s=n_alive / dt / 1e6, device=card)
        records.append(rec)
        if verbose:
            print(f"bounce {b + 1}: {n_alive:8d} live | supers proc {sp:7d} "
                  f"({sp / n_tiles:6.1f}/tile) | clusters {ce:8d} "
                  f"({ce * traversal.CLUSTER / n_alive:7.0f} tri-evals/ray) "
                  f"| {wall * 1e3:8.3f} ms wall, "
                  f"{'-' if dev_s is None else f'{dev_s * 1e3:8.3f}'} ms "
                  f"B1+B2  {rec['ns_per_ceval']:6.0f} "
                  f"ns/ceval | {gf:7.0f} GF/s = "
                  f"{100 * rec['peak_share']:5.2f}% of FP32 peak | "
                  f"{rec['mrays_s']:6.1f} Mrays/s", flush=True)
        for part in (2, 4):
            m = max(tile, n_alive // part // tile * tile)
            fit_rows.append(measure(scene, o[:, :m], d[:, :m], alive[:m],
                                    tile, reps, dev))
    min_tiles = (torch.cuda.get_device_properties(dev).multi_processor_count
                 if dev.type == "cuda" else 1)
    fit_rows = [r[:3] + (r[3] if r[4] is None else r[4],) for r in fit_rows
                if r[2] >= min_tiles]
    if len(fit_rows) >= 3:
        coef, resid = fit(fit_rows)
        b_bound = eval_ops / common.PEAK_FP32_OPS_S
        rec = dict(bounce="fit", a_ns=coef[0] * 1e9, b_ns=coef[1] * 1e9,
                   c_ns=coef[2] * 1e9, residual=resid,
                   b_bound_ns=b_bound * 1e9, rows=len(fit_rows),
                   min_tiles=min_tiles, device=card)
        records.append(rec)
        if verbose:
            print(f"fit {'wall' if dev.type != 'cuda' else 'B1+B2 device'}"
                  f" time = a*supers + b*clusters + c*tiles over "
                  f"{len(fit_rows)} launches of {min_tiles} tiles or "
                  f"more:\n"
                  f"  a = {rec['a_ns']:10.1f} ns/super\n"
                  f"  b = {rec['b_ns']:10.1f} ns/cluster-eval\n"
                  f"  c = {rec['c_ns']:10.1f} ns/tile\n"
                  f"  residual: {100 * resid:.1f}% max\n"
                  f"  FP32 bound b = {rec['b_bound_ns']:.1f} ns/cluster-eval "
                  f"(measured {rec['b_ns']:.1f})", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_headline(ap, reps=5)
    ap.add_argument("--tile", type=int, default=common.env_int("SRT_TILE",
                                                               128))
    args = ap.parse_args(argv)
    dev = common.cli_device("eval_counts", args.device)
    if dev is None:
        return 2
    run(dev, None, args.rows, args.cols, args.size, args.tile, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
