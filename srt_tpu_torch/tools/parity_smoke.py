"""The walk (the kernels) against the dense sweep on the card, at full
scale (``tools/tpu_parity_smoke.py``'s counterpart): an independent check
of the compiled kernels that the kernel-vs-plain comparisons cannot give,
since those hold a kernel against its own plain version.

Cases, as JAX's: the Rubik grid with camera and random 64k rays; the
101,760-triangle headline with camera and random 256k rays, through the
tiled walk and the per-group walk (``pg2:32:4`` on random rays,
``pg2:128:4`` on camera rays); the 502,600-triangle ``uv_sphere(360,
700)`` with camera and random 64k rays through the streamed walks (B2s,
and B4s at ``pg2:32:4``).  Each case records JAX's keys: hit rates of
the walk (``hit_rate_pallas``, JAX's name) and of the sweep, their hit
agreement, the share of common hits on the same triangle, the share not
farther than the sweep, the largest relative t error on the same
triangle, and ``pass`` under JAX's thresholds (hit agreement above
0.995, same id above 0.98, never farther, t error below 2e-4).

Run as ``python3 -m srt_tpu_torch.tools.parity_smoke [--device DEV]
[--out PATH]``: prints one JSON line a case and PASS or FAIL, writes
the results to PATH when given, and exits 1 on a failed case.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh
from srt_tpu_torch.ops import traversal
from srt_tpu_torch.ops.morton import morton_perm, permute_rays
from srt_tpu_torch.tools import common

THRESH_HIT_AGREE = 0.995   # the walk accepts grazing EDGE_EPS supersets
THRESH_SAME_ID = 0.98      # ties at shared edges may resolve differently
# Scenes (uv_sphere rows, cols) and rays: camera side, random count.
HEADLINE, BIG = (160, 320), (360, 700)
SIZES = dict(rubik=(256, 65536), headline=(512, 262144), big=(256, 65536))


def camera_rays(n_side: int, origin, look_at, dev):
    """Pixel-centre rays of an n_side x n_side camera, Morton ordered."""
    cam = CameraConfig(width=n_side, height=n_side, origin=origin,
                       look_at=look_at)
    o, d = generate_rays(derive_viewport(cam, device=dev), n_side, n_side,
                         torch.full((2, n_side * n_side), 0.5, device=dev))
    return permute_rays(o, d, morton_perm(n_side, n_side)[0])


def random_rays(n: int, seed: int, spread: float, dev):
    """JAX's random rays: uniform origins, normal directions pulled back
    toward the origin (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (3, n)).astype(np.float32)
    d = (rng.normal(size=(3, n)) - o * 0.2).astype(np.float32)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


def dense(scene, o, d):
    """The dense sweep's (t, triangle) of [3, N] rays (numpy)."""
    inf = torch.full((o.shape[1],), float("inf"), device=o.device)
    td_, id_, _, _ = mesh._dense_model_hit(scene, 0, o, d, inf)
    return td_.cpu().numpy(), id_.cpu().numpy()


def check(name, scene, o, d, ref, binned=False, stream=None, verbose=True):
    """One case's record (JAX's keys and thresholds); ``ref`` is
    ``dense(scene, o, d)``."""
    n = o.shape[1]
    inf = torch.full((n,), float("inf"), device=o.device)
    tp_, ip_, _, _ = traversal.model_hit(scene, 0, o, d, inf,
                                         tile=128 if binned else 512,
                                         binned=binned, stream=stream)
    tp_, ip_ = tp_.cpu().numpy(), ip_.cpu().numpy()
    td_, id_ = ref
    hit_p = ip_ >= 0
    hit_d = np.isfinite(td_)
    agree = float((hit_p == hit_d).mean())
    both = hit_p & hit_d
    same = float((ip_[both] == id_[both]).mean()) if both.any() else 1.0
    # The walk's winners must never be farther than the exact sweep's.
    not_farther = float((tp_[both] <= td_[both] * (1 + 2e-4) + 1e-5).mean()
                        ) if both.any() else 1.0
    m = ip_[both] == id_[both]
    t_err = float(np.max(np.abs(tp_[both][m] - td_[both][m])
                         / np.maximum(td_[both][m], 1e-3))) if m.any() else 0.0
    rec = {
        "case": name, "rays": int(n),
        "hit_rate_pallas": round(float(hit_p.mean()), 4),
        "hit_rate_dense": round(float(hit_d.mean()), 4),
        "hit_agree": round(agree, 5),
        "same_id": round(same, 5),
        "not_farther": round(not_farther, 5),
        "t_rel_err_same_id": t_err,
        "pass": bool(agree > THRESH_HIT_AGREE and same > THRESH_SAME_ID
                     and not_farther == 1.0 and t_err < 2e-4),
    }
    if verbose:
        print(json.dumps(rec), flush=True)
    return rec


def run(device=None, scene=None, big=None, rubik=None, sizes=None,
        out=None, verbose: bool = True):
    """Every case; returns the records.  ``scene`` is the headline mesh,
    ``big`` the streamed one, ``rubik`` the grid (each built when None);
    ``sizes`` maps "rubik", "headline", "big" to (camera side, random
    rays).  The streamed cases force the streamed walks; at full size
    ``big`` has more than ``traversal.STREAM_THRESHOLD_CLUSTERS`` clusters
    and the dispatch would pick them anyway."""
    dev = resolve(device)
    card = common.header("parity_smoke", dev, verbose)
    sizes = dict(SIZES, **(sizes or {}))
    rubik = rubik if rubik is not None else common.rubik_scene(dev)
    scene = scene if scene is not None else common.headline_scene(
        dev, *HEADLINE)
    big = big if big is not None else common.headline_scene(dev, *BIG)
    cases = []

    def cases_on(label, sc, rays, walks, **kw):
        ref = dense(sc, *rays)
        for suffix, binned in walks:
            cases.append(check(label + suffix, sc, *rays, ref, binned=binned,
                               verbose=verbose, **kw))

    side, count = sizes["rubik"]
    cases_on(f"rubik/camera {side * side}", rubik,
             camera_rays(side, (0.0, 4.0, 8.0), (0.0, 0.0, 0.0), dev),
             [("", False)])
    cases_on(f"rubik/random {count}", rubik, random_rays(count, 3, 4.0, dev),
             [("", False)])
    side, count = sizes["headline"]
    tag = f"{scene.model_tri_count[0]}"
    cases_on(f"{tag}/camera {side * side}", scene,
             camera_rays(side, (0.0, 1.0, 5.0), (0.0, 0.0, 0.0), dev),
             [("", False), (" pg2:128:4", "pg2:128:4")])
    cases_on(f"{tag}/random {count}", scene, random_rays(count, 5, 4.0, dev),
             [("", False), (" pg2:32:4", "pg2:32:4")])
    side, count = sizes["big"]
    tag = f"{big.model_tri_count[0]}-streamed"
    cases_on(f"{tag}/camera {side * side}", big,
             camera_rays(side, (0.0, 1.0, 5.0), (0.0, 0.0, 0.0), dev),
             [("", False)], stream=True)
    cases_on(f"{tag}/random {count}", big, random_rays(count, 7, 4.0, dev),
             [("", False), (" pg2:32:4", "pg2:32:4")], stream=True)

    ok = all(c["pass"] for c in cases)
    if out:
        with open(out, "w") as f:
            json.dump({"device": card, "cases": cases, "pass": ok}, f,
                      indent=1)
    if verbose:
        print(f"{'PASS' if ok else 'FAIL'}"
              f"{f' -> {out}' if out else ''}", flush=True)
    for c in cases:
        c["device"] = card
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    dev = common.cli_device("parity_smoke", args.device)
    if dev is None:
        return 2
    cases = run(dev, out=args.out)
    return 0 if all(c["pass"] for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
