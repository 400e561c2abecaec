"""Group-binned against tiled traversal on incoherent rays
(``tools/micro_binned.py``'s counterpart): the per-group (8 sorted rays)
super footprints and the binned pipeline's stage costs on the headline
mesh.

Rays: N origins on the radius-2 sphere and N unit directions, both from
normal draws (a seeded ``torch.Generator`` on the device, not
``jax.random``), and the same rays ordered by
``pathtracer._bounce_sort_keys`` (origin cell, direction cone) with a
stable argsort, so that 8 consecutive rays are coherent, as in a sorted
wavefront.

Printed, as in JAX's tool: the tiled walk against the pair-binned walk
(``traversal.model_hit(tile=128)`` with ``binned`` False and True) on
the unsorted and the sorted rays, with the binned walk's branch (pairs,
or the tiled fallback when the pairs outgrow their capacity, where JAX's
``lax.cond`` falls back); then the binned stages on the sorted rays:
``front`` (the rays operand at tile x 8 padding and the super bounds),
``cull`` (B5, ``traversal.cull_perray``), the supers a group enters,
``pairs`` (``pair_capacity``, ``binned_pairs``: total, capacity,
overflow), the pair gather (``pair_rays``) and ``kern`` (B2 on the pair
tiles, ``traversal.intersect`` with zero entry distances).  The stages
run the pair walk's own functions; none is written anew.

Times: wall ms (JAX's ``timeit``: a warm call, then calls each
synchronised) and device ms.  A stage's device ms is ``common.device_ms``
(5 calls queued behind a spin: "events"); the pair stages synchronise (a
masked scatter, a table sent from the host), as does a hit call (it
reads the pair total on the host), so those calls cannot be queued: their
device ms and operations are the summed device operations of one call in
a ``torch.profiler`` trace (``common.device_ops``: "profiler").  A
stage's operations also come from that trace; a window may miss the
kernels launched through ``cuda_lib`` (B5's stage read 0 late in a long
process) or hold extra ones, so they are approximate.  B5's and B2's own ms are CUDA
events around their launches in one call (``common.kernel_times``).
None of these exists on the CPU.

JAX's ``front`` repeats ``pallas_model_hit``'s packing
(``traversal_pallas.py:1508-1545``); ``traversal.pack_rays`` is its
counterpart and packs every ray the same (root-box ``t_clip``, ``t_eff``
= min(t_max, t_clip), padding rays with direction 1.0, t 0 and a zero
t_lo column).  JAX's ``front`` takes the root box and super bounds over
the whole scene's clusters, ``pack_rays`` and ``model_tables`` over
model 0's: the same on this one-model scene.

Run as ``python3 -m srt_tpu_torch.tools.micro_binned [--device DEV]
[--rows R] [--cols C] [--n N] [--reps R]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models.pathtracer import _bounce_sort_keys
from srt_tpu_torch.ops import traversal
from srt_tpu_torch.tools import common

N = 262144
TILE = 128
PAIR_FACTOR = 8


def random_rays(n: int, dev, seed: int = 0):
    """(o, d, o_sorted, d_sorted) [3, n]: origins on the radius-2 sphere,
    unit directions, and both ordered by ``_bounce_sort_keys`` (JAX's
    ``_setup``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn((3, n), generator=gen, device=dev)
    o = 2.0 * u / torch.linalg.vector_norm(u, dim=0)
    v = torch.randn((3, n), generator=gen, device=dev)
    d = v / torch.linalg.vector_norm(v, dim=0)
    order = sort_order(o, d)
    return o, d, o[:, order], d[:, order]


def sort_order(o, d):
    """The stable argsort of the rays' bounce sort keys (all alive)."""
    alive = torch.ones((o.shape[1],), dtype=torch.bool, device=o.device)
    return torch.argsort(_bounce_sort_keys(o, d, alive), stable=True)


def front(scene, o, d):
    """(rays8 [Np, 8] at tile x 8 padding, sbounds [8, S]) of rays with
    t_max = inf (JAX's ``front``)."""
    t_max = torch.full((o.shape[1],), float("inf"), device=o.device)
    rays8 = traversal.pack_rays(scene, 0, o, d, t_max, TILE * 8)[0]
    return rays8, traversal.model_tables(scene, 0)[2]


def pair_tables(e):
    """(p_cap, (pair_grp, tile_super, tile_counts, total)) of B5's
    entries ``e`` [G, S] at JAX's 8 pair slots a group."""
    n_groups, s_count = e.shape
    gpt = TILE // traversal.GROUP
    p_cap = traversal.pair_capacity(n_groups, s_count, gpt, PAIR_FACTOR)
    return p_cap, traversal.binned_pairs(e, gpt, p_cap)


def pair_kern(scene, tile_counts, tile_super, pr):
    """B2 on the pair tiles ``pr`` as one-entry lists (JAX's ``kern``):
    (t [P*8, 1], i [P*8, 1])."""
    woop, cb = traversal.model_tables(scene, 0)[:2]
    elist0 = torch.zeros((tile_counts.shape[0], 1), dtype=torch.float32,
                         device=pr.device)
    return traversal.intersect(tile_counts, tile_super, elist0, pr, cb, woop,
                               TILE)


def pipeline(scene, rays8, sbounds) -> dict:
    """One pass of the binned stages after ``front``: ``e`` (B5),
    ``p_cap``, ``pairs`` (``binned_pairs``' four outputs), ``pr`` (the
    pair rays) and ``hit`` (B2's (t, i) on them)."""
    e = traversal.cull_perray(rays8, sbounds)
    p_cap, pairs = pair_tables(e)
    pair_grp, tile_super, tile_counts, _ = pairs
    pr = traversal.pair_rays(rays8, pair_grp)
    return dict(e=e, p_cap=p_cap, pairs=pairs, pr=pr,
                hit=pair_kern(scene, tile_counts, tile_super, pr))


def group_supers(e) -> dict:
    """Supers each 8-ray group enters: mean, p90, p99, max (numpy's
    percentiles, as JAX's tool prints them)."""
    occ = (e < traversal.BIG).sum(1).cpu().numpy()
    return dict(groups=int(occ.size), mean=float(occ.mean()),
                p90=float(np.percentile(occ, 90)),
                p99=float(np.percentile(occ, 99)), max=int(occ.max()))


def _branch(fn):
    """Run ``fn()`` and name the pair walk's branch it took."""
    before = (traversal.launch_counts["binned_pairs"],
              traversal.launch_counts["binned_fallback"])
    fn()
    pairs = traversal.launch_counts["binned_pairs"] - before[0]
    fallback = traversal.launch_counts["binned_fallback"] - before[1]
    return "pairs" if pairs and not fallback else (
        "tiled fallback" if fallback and not pairs else "none")


def _ms(x, ops=None):
    if x is None:
        return "not measured"
    return f"{x:.4f} ms" + ("" if ops is None else f" in {ops} operations")


def run(device=None, scene=None, rows: int = 160, cols: int = 320,
        n: int = N, reps: int = 5, verbose: bool = True):
    """Records: ``case`` "scene" (``clusters``, ``supers``), "hit"
    (``order``, ``tiled_ms``, ``binned_ms`` wall; ``tiled_device_ms``,
    ``binned_device_ms``, ``tiled_launches``, ``binned_launches``;
    ``tiled_mrays_s``, ``binned_mrays_s``; ``branch``), "stage"
    (``stage``, ``ms`` wall, ``device_ms``, ``device_source`` ("events"
    or "profiler"), ``launches``, ``kernel_ms``: B5's or B2's own, None
    for the stages without a kernel), "supers" (per group:
    ``groups``, ``mean``, ``p90``, ``p99``, ``max``) and "pairs"
    (``total``, ``capacity``, ``overflow``)."""
    dev = resolve(device)
    card = common.header("micro_binned", dev, verbose)
    scene = scene if scene is not None else common.headline_scene(
        dev, rows, cols)
    clusters = scene.woop.shape[0]
    supers = -(-clusters // traversal.SUPER)
    records = [dict(case="scene", clusters=clusters, supers=supers,
                    device=card)]
    if verbose:
        print(f"clusters {clusters} supers {supers}", flush=True)
    o, d, o_s, d_s = random_rays(n, dev)
    t_max = torch.full((n,), float("inf"), device=dev)

    def timeit(fn):
        # JAX's timeit here waits for each call.
        return common.wall_s(lambda: (fn(), common.sync(dev)), dev=dev,
                             reps=reps) * 1e3

    for order, oo, dd in (("unsorted", o, d), ("sorted", o_s, d_s)):
        rec = dict(case="hit", order=order, device=card)
        for walk, binned in (("tiled", False), ("binned", True)):
            def hit(oo=oo, dd=dd, binned=binned):
                return traversal.model_hit(scene, 0, oo, dd, t_max,
                                           tile=TILE, binned=binned)[0:2]
            ms = timeit(hit)
            launches, d_ms = common.device_ops(hit, dev)
            rec.update({f"{walk}_ms": ms, f"{walk}_device_ms": d_ms,
                        f"{walk}_launches": launches,
                        f"{walk}_mrays_s": n / ms / 1e3})
            if binned:
                rec["branch"] = _branch(hit)
        records.append(rec)
        if verbose:
            print(f"{order}: tiled {rec['tiled_ms']:.1f} ms "
                  f"({rec['tiled_mrays_s']:.2f} Mrays/s)  binned "
                  f"{rec['binned_ms']:.1f} ms ({rec['binned_mrays_s']:.2f} "
                  f"Mrays/s; {rec['branch']})  device: tiled "
                  f"{_ms(rec['tiled_device_ms'], rec['tiled_launches'])}, "
                  f"binned "
                  f"{_ms(rec['binned_device_ms'], rec['binned_launches'])}",
                  flush=True)

    # --- sorted-case stage breakdown ---
    def stage(name, fn, kernel=None):
        ms = timeit(fn)
        d_ms, queued = common.device_ms(fn, dev, n=5)
        launches, p_ms = common.device_ops(fn, dev)
        source = "events" if queued else "profiler"
        if d_ms is not None and not queued:
            d_ms = p_ms
        k_ms = None
        if kernel is not None:
            with common.kernel_times(dev, (kernel,)) as kt:
                fn()
            k_ms = kt.ms(kernel)
        records.append(dict(case="stage", stage=name, ms=ms, device_ms=d_ms,
                            device_source=source if d_ms else None,
                            launches=launches, kernel=kernel, kernel_ms=k_ms,
                            device=card))
        if verbose:
            own = f", {kernel} {_ms(k_ms)}" if kernel else ""
            how = ("" if d_ms is None else f" ({source}), {launches} "
                   f"operations in a profiler window")
            print(f"stage {name:5s} {ms:.1f} ms  (device {_ms(d_ms)}{how}"
                  f"{own})", flush=True)

    stage("front", lambda: front(scene, o_s, d_s))
    rays8, sbounds = front(scene, o_s, d_s)
    stage("cull", lambda: traversal.cull_perray(rays8, sbounds),
          "cull_perray")
    e = traversal.cull_perray(rays8, sbounds)
    sup = dict(case="supers", **group_supers(e), device=card)
    records.append(sup)
    if verbose:
        print(f"per-GROUP supers (sorted): mean {sup['mean']:.2f} p90 "
              f"{sup['p90']:.0f} p99 {sup['p99']:.0f} max {sup['max']}",
              flush=True)
    stage("pairs", lambda: pair_tables(e))
    p_cap, (pair_grp, tile_super, tile_counts, total) = pair_tables(e)
    total = int(total)
    records.append(dict(case="pairs", total=total, capacity=p_cap,
                        overflow=total > p_cap, device=card))
    if verbose:
        print(f"pairs: total {total}, cap {p_cap}, overflow="
              f"{total > p_cap}", flush=True)
    stage("gather", lambda: traversal.pair_rays(rays8, pair_grp))
    pr = traversal.pair_rays(rays8, pair_grp)
    stage("kern", lambda: pair_kern(scene, tile_counts, tile_super, pr),
          "intersect")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    d = common.headline_defaults()
    common.add_device(ap)
    ap.add_argument("--rows", type=int, default=d["rows"])
    ap.add_argument("--cols", type=int, default=d["cols"])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_binned", args.device)
    if dev is None:
        return 2
    run(dev, None, args.rows, args.cols, args.n, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
