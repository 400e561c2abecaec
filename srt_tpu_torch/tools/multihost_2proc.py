"""A real multi-process render (``tools/multihost_2proc.py``'s
counterpart): two ranks, each a process of its own, render their tile of
a mesh scene through ``parallel/multihost.render_multihost`` and
all-gather the image; the parent checks that both ranks assembled the
same image, that it equals a one-process render of the whole frame, and
reports the scaling efficiency t1 / (2 t2).

The ranks are started by ``parallel/launch.spawn_world`` on gloo: CPU
ranks with ``--device cpu``, else both ranks on the one card (NCCL
refuses two ranks on one card).  Each rank has one device (JAX's
processes had four virtual CPU devices each).  ``--method walk`` runs the
walk's kernels on the card (JAX's ``SRT_MH_METHOD=pallas``; the scene
then has walk tables, ``pad_to=128``), ``dense`` the dense sweep
(``pad_to=1``).  The report has JAX's keys, and ``device`` (the card's
line); each rank's entry also has ``launches`` (its kernel launches in
the warm-up render).  It is written only to ``--out``.  The images must
be equal, or within 1e-6 (JAX's gate), or the call raises.

Run as ``python3 -m srt_tpu_torch.tools.multihost_2proc [--device DEV]
[--method dense|walk] [--out PATH]``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch.distributed as dist

from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh
from srt_tpu_torch.ops import rng, traversal
from srt_tpu_torch.parallel.launch import spawn_world
from srt_tpu_torch.parallel.mesh import device_mesh, rank_device
from srt_tpu_torch.parallel.multihost import render_multihost
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common
from srt_tpu_torch.utils.flatten import flatten_models
from srt_tpu_torch.utils.procgen import uv_sphere

NPROC = 2
SIZE = (64, 32)          # W, H
SEED = 11
METHODS = ("dense", "walk")


def scene_setup(dev, method: str):
    """(scene, lights, cam, cfg) of JAX's ``_scene_setup``."""
    scene = mesh.upload(flatten_models(
        [uv_sphere(12, 18)], pad_to=128 if method == "walk" else 1), dev)
    cam = CameraConfig(width=SIZE[0], height=SIZE[1],
                       **common.HEADLINE_CAMERA)
    cfg = RenderConfig(max_depth=2, rr_bounces=1, spp=1)
    return scene, model_scene_lights(dev), cam, cfg


def render(dev, method: str, m):
    """``render_multihost`` of the scene at key ``SEED`` over mesh ``m``:
    the [H, W, 3] numpy image."""
    scene, lights, cam, cfg = scene_setup(dev, method)
    return render_multihost(
        lambda s: mesh.mesh_hit_fn(s, method=method, kernel_tile=128),
        scene, lights, cam, cfg, rng.key(SEED, dev), m)


def timed_render(dev, method, m):
    """(image, seconds of the second of two renders, kernel launches of
    the first)."""
    traversal.reset_launch_counts()
    render(dev, method, m)                       # warm-up
    common.sync(dev)
    launches = {k: v for k, v in traversal.launch_counts.items() if v}
    t0 = time.perf_counter()
    img = render(dev, method, m)
    common.sync(dev)
    return img, time.perf_counter() - t0, launches


def image_sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def rank_main(rank, world, device, method):
    """One rank (JAX's ``child``): its entry of ``per_process`` and, in
    ``image``, the assembled image."""
    dev = rank_device(device)
    m = device_mesh(world, 1, device=device)
    img, dt, launches = timed_render(dev, method, m)
    return dict(proc=rank, method=method,
                process_count=dist.get_world_size(), local_devices=1,
                tile_seconds=dt,
                image_sum=float(np.asarray(img, np.float64).sum()),
                image_sha=image_sha(img), launches=launches, image=img)


def single_process(dev, method):
    """JAX's reference: the same render in this process (a world of 1,
    started here and ended after, unless one exists)."""
    started = not dist.is_initialized()
    try:
        m = device_mesh(1, 1, device=None if dev.type == "cuda" else dev)
        img, secs, _ = timed_render(dev, method, m)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return img, secs


def run(device=None, method: str = "dense", out=None,
        workdir=None, timeout: float = 300.0, threads: int = 0,
        verbose: bool = True):
    """Spawn the world of 2, render the one-process reference, compare;
    returns [report] (JAX's keys and ``device``).  ``workdir``: the
    world's store and results (a temporary directory when None);
    ``timeout`` bounds the world (seconds); ``threads`` > 0 sets each
    rank's torch threads."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} is not one of {METHODS}")
    dev = resolve(device)
    card = common.header("multihost_2proc", dev, verbose)
    rank_dev = None if dev.type == "cuda" else dev
    with tempfile.TemporaryDirectory(prefix="srt_mh_") as tmp:
        ranks = spawn_world(rank_main, NPROC, (rank_dev, method),
                            workdir=workdir or tmp, backend="gloo",
                            device=rank_dev, timeout=timeout,
                            threads=threads)
    images = [r.pop("image") for r in ranks]
    counts = [r["process_count"] for r in ranks]
    if counts != [NPROC] * NPROC:
        raise RuntimeError(f"process counts {counts}")
    shas = {r["image_sha"] for r in ranks}
    if len(shas) != 1:
        raise RuntimeError(f"processes assembled different images: {shas}")
    for r in ranks if verbose else ():
        print(f"proc {r['proc']}: ok ({r['tile_seconds'] * 1e3:.0f} "
              "ms/frame local tile)", flush=True)

    ref, t1 = single_process(dev, method)
    max_diff = float(np.abs(ref - images[0]).max())
    bit_equal = bool((ref == images[0]).all())
    t2 = max(r["tile_seconds"] for r in ranks)
    where = "card" if dev.type == "cuda" else "host"
    report = {
        "method": method,
        "processes": NPROC,
        "devices_per_process": 1,
        "note": (f"both ranks share one {where} and talk through gloo, so "
                 "scaling_efficiency is bounded by that sharing, not by "
                 "the tile split; the point is that the all-gather "
                 "assembly and the rank-aware tile ownership run in "
                 "several processes and assemble bit-identically"),
        "host_cpus": os.cpu_count(),
        "scene": f"uv_sphere(12,18) mesh, {method} strategy",
        "image": f"{SIZE[0]}x{SIZE[1]}",
        "bit_equal_to_single_process": bit_equal,
        "max_abs_diff": max_diff,
        "assembled_identically_on_all_processes": True,
        "single_process_frame_s": t1,
        "multi_process_tile_s": t2,
        "scaling_efficiency": t1 / (NPROC * t2),
        "per_process": ranks,
        "device": card,
    }
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    if verbose:
        print(json.dumps(report, indent=1), flush=True)
    if not (bit_equal or max_diff < 1e-6):
        raise RuntimeError(f"multi-process image diverged: {max_diff}")
    if verbose:
        print(f"multihost_2proc: OK{f' -> {out}' if out else ''}",
              flush=True)
    return [report]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--method", choices=METHODS, default="dense")
    ap.add_argument("--out", help="write the report here (JSON)")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    dev = common.cli_device("multihost_2proc", args.device)
    if dev is None:
        return 2
    run(dev, args.method, out=args.out, timeout=args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
