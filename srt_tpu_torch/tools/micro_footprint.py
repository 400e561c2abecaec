"""Per-ray against per-group cluster footprints on the headline's real
bounce wavefronts (``tools/micro_footprint.py``'s counterpart): whether
the traversal's waste is the grouping of rays (the union of a group's
clusters far above one ray's) or the 128-triangle clustering itself (one
ray's footprint already large).

The wavefronts are the headline frame's (``wavefronts.headline``:
``max_depth=4``, ``sort_bounces=True``, key 0, the walk); the rest is
JAX's numpy, unchanged: per bounce, a sample of up to 16,384 live rays
slab-tested against every cluster box up to the root box's exit, the
per-ray footprint and the mean union over groups of 4 to 128 consecutive
rays; from bounce 2 on, shadow rays from the same origins toward a light
picked by ``np.random.default_rng(bounce index)`` from
``model_scene_lights``, clipped to the light's distance.

Run as ``python3 -m srt_tpu_torch.tools.micro_footprint [--device DEV]
[--rows R] [--cols C] [--size N]`` (``SRT_BENCH_*`` as in JAX's tool).
It prints JAX's lines; it times nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common, wavefronts

SAMPLE = 16384
GROUPS = (4, 8, 16, 32, 64, 128)
SHADOW_GROUPS = (8, 16, 32, 128)


def footprints(cmin, cmax, light_pos, work):
    """JAX's numpy part on ``work`` (per bounce: origins [3, N], dirs,
    alive, numpy or tensors) and the cluster boxes ``cmin``, ``cmax`` [C,
    3]: one record a bounce with live rays (``bounce``, ``live``,
    ``sampled``, ``mean``, ``p50``, ``p90``, ``unions`` {group: mean},
    ``shadow``: the same four of the shadow rays, or None at bounce 1)."""
    root_lo, root_hi = cmin.min(0), cmax.max(0)
    records = []
    for b, (origins, dirs, alive) in enumerate(work):
        n_alive = int(np.asarray(alive).sum())
        if n_alive == 0:
            continue
        take = min(SAMPLE, n_alive)
        o_b = np.asarray(origins[:, :take]).T    # [S, 3]
        d_b = np.asarray(dirs[:, :take]).T
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d_b                       # [S, 3]
            b0 = (root_lo[None] - o_b) * inv
            b1 = (root_hi[None] - o_b) * inv
            btn = np.minimum(b0, b1).max(1)
            btf = np.maximum(b0, b1).min(1)
            t_clip = np.where((btn <= btf) & (btf >= 0),
                              btf * (1 + 1e-4) + 1e-3, 0.0)
            t0 = (cmin[None] - o_b[:, None]) * inv[:, None]   # [S, C, 3]
            t1 = (cmax[None] - o_b[:, None]) * inv[:, None]
            tn = np.minimum(t0, t1).max(2)
            tf = np.maximum(t0, t1).min(2)
        sel = np.where(tn >= 0, tn, tf)
        occ = (tn <= tf) & (tf >= 0) & (sel < t_clip[:, None])  # [S, C]
        rec = dict(bounce=b + 1, live=n_alive, sampled=take,
                   **_stats(occ, take, GROUPS), shadow=None)
        records.append(rec)

        # Shadow-ray analog: these origins are the previous bounce's hit
        # points; cast to a random one of the scene's lights with the
        # segment-clipped t_max (the _occluded construction).
        if b == 0:
            continue
        lp = light_pos                                       # [L, 3]
        pick = np.random.default_rng(b).integers(0, lp.shape[0], take)
        delta = lp[pick] - o_b
        dist = np.sqrt((delta ** 2).sum(1))
        sd = delta / np.maximum(dist[:, None], 1e-9)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / sd
            b0 = (root_lo[None] - o_b) * inv
            b1 = (root_hi[None] - o_b) * inv
            btn = np.minimum(b0, b1).max(1)
            btf = np.maximum(b0, b1).min(1)
            t_clip = np.where((btn <= btf) & (btf >= 0),
                              btf * (1 + 1e-4) + 1e-3, 0.0)
            t_eff = np.minimum(dist, t_clip)
            t0 = (cmin[None] - o_b[:, None]) * inv[:, None]
            t1 = (cmax[None] - o_b[:, None]) * inv[:, None]
            tn = np.minimum(t0, t1).max(2)
            tf = np.maximum(t0, t1).min(2)
        sel = np.where(tn >= 0, tn, tf)
        occ = (tn <= tf) & (tf >= 0) & (sel < t_eff[:, None])
        rec["shadow"] = _stats(occ, take, SHADOW_GROUPS)
    return records


def _stats(occ, take, groups) -> dict:
    per_ray = occ.sum(1)
    return dict(mean=float(per_ray.mean()),
                p50=float(np.percentile(per_ray, 50)),
                p90=float(np.percentile(per_ray, 90)),
                unions={gs: float(occ[: take - take % gs].reshape(
                    -1, gs, occ.shape[1]).any(1).sum(1).mean())
                    for gs in groups})


def lines(rec) -> list:
    """JAX's printed lines of one bounce's record."""
    def unions(u):
        return " ".join(f"{gs}:{v:.1f}" for gs, v in u.items())
    out = [f"bounce {rec['bounce']} ({rec['live']} live, {rec['sampled']} "
           f"sampled): clusters/ray mean {rec['mean']:.1f} p50 "
           f"{rec['p50']:.0f} p90 {rec['p90']:.0f} | unions "
           + unions(rec["unions"])]
    sh = rec["shadow"]
    if sh is not None:
        out.append(f"  shadow rays from these origins: clusters/ray mean "
                   f"{sh['mean']:.1f} p50 {sh['p50']:.0f} p90 "
                   f"{sh['p90']:.0f} | unions " + unions(sh["unions"]))
    return out


def run(device=None, scene=None, rows: int = 160, cols: int = 320,
        size: int = 1024, waves=None, verbose: bool = True):
    """``footprints``' records of the headline's wavefronts at ``size``
    (``waves``: a ``wavefronts.headline`` capture of ``scene`` at that
    size to reuse), each with the card's line as ``device``."""
    dev = resolve(device)
    card = common.header("micro_footprint", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    if waves is None:
        waves = wavefronts.headline(scene, size)
    work = [tuple(x.cpu().numpy() for x in w) for w in waves.work]
    records = footprints(scene.cluster_min.cpu().numpy(),
                         scene.cluster_max.cpu().numpy(),
                         model_scene_lights(dev).position.cpu().numpy(),
                         work)
    for rec in records:
        rec["device"] = card
        if verbose:
            for ln in lines(rec):
                print(ln, flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_headline(ap, reps=1)
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_footprint", args.device)
    if dev is None:
        return 2
    run(dev, None, args.rows, args.cols, args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
