"""Interactive frame rates of ``RenderSession`` (``app.py``) on the fast
path (``tools/interactive_session.py``'s counterpart): progressive frames
at several resolutions, the analog of the reference's 1000x800
interactive frame loop (src/main.cpp:600-769).

Run as ``python3 -m srt_tpu_torch.tools.interactive_session [--device
DEV] [--sizes 1024,512,256] [--frames 12] [--out PATH]`` (default: the
card).  Cases: the 101,760-triangle headline mesh at each size, then the
Rubik grid (``procgen.rubik_grid()``: the reference's OBJ is not in the
repository) at the first size by 800/1024 of it (1024x800, the
reference's interactive resolution).  Each case runs a warm frame and
``frames`` timed accumulation frames, then a camera move (the
accumulation resets) and ``frames`` more, then one frame with the host
fetch.  A frame's time ends when the card has finished it
(``step(fetch=False)`` synchronizes); fps = 1000 / median frame ms.
Prints one JSON line a case, and writes them to ``--out`` only where it
is given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from srt_tpu_torch.app import RenderSession
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.utils.flatten import flatten_models
from srt_tpu_torch.utils.procgen import rubik_grid, uv_sphere

SIZES = (1024, 512, 256)  # the headline cases' widths and heights


def run_case(name, scene, lights, cam, cfg, frames=12) -> dict:
    s = RenderSession(None, lights, cam, cfg, scene=scene, fast=True)
    s.step()                                 # probe + warm
    ms = []
    for _ in range(frames):
        t0 = time.perf_counter()
        s.step(fetch=False)
        ms.append((time.perf_counter() - t0) * 1e3)
    s.rotate(5.0, -2.0)                      # interaction: reset + retime
    s.move(forward=0.3)
    ms_moved = []
    for _ in range(frames):
        t0 = time.perf_counter()
        s.step(fetch=False)
        ms_moved.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    s.step(fetch=True)
    ms_fetch = (time.perf_counter() - t0) * 1e3
    med = statistics.median(ms)
    med2 = statistics.median(ms_moved)
    out = {
        "case": name, "width": cam.width, "height": cam.height,
        "median_frame_ms": round(med, 1), "fps": round(1000.0 / med, 1),
        "median_frame_ms_after_move": round(med2, 1),
        "fps_after_move": round(1000.0 / med2, 1),
        "frame_plus_host_fetch_ms": round(ms_fetch, 1),
        "frames_accumulated": s.frames_accumulated,
    }
    print(json.dumps(out), flush=True)
    return out


def run(device=None, sizes=SIZES, frames=12, out=None) -> list:
    """Every case on ``device``; returns their records (also written to
    ``out``, one JSON line each, where it is given)."""
    dev = resolve(device)
    lights = model_scene_lights(dev)
    cfg = RenderConfig(max_depth=4, rr_bounces=0)
    hp_scene = mesh.upload(flatten_models([uv_sphere(160, 320, radius=2.0)],
                                          pad_to=128), dev)
    results = []
    for size in sizes:
        cam = CameraConfig(width=size, height=size, origin=(0.0, 1.0, 5.0),
                           look_at=(0.0, 0.0, 0.0))
        results.append(run_case(f"headline-102k-{size}", hp_scene, lights,
                                cam, cfg, frames))
    rk_scene = mesh.upload(flatten_models([rubik_grid()], pad_to=128), dev)
    width = sizes[0]
    cam = CameraConfig(width=width, height=width * 800 // 1024,
                       origin=(0.0, 20.0, 20.0), look_at=(0.0, 1.0, -1.0))
    results.append(run_case(f"rubik-{cam.width}x{cam.height}", rk_scene,
                            lights, cam, cfg, frames))
    if out:
        with open(out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="default: the card")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="headline sizes, comma-separated")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    try:
        dev = resolve(args.device)
    except RuntimeError as e:
        print(f"interactive_session: {e}", file=sys.stderr)
        return 2
    run(dev, tuple(int(s) for s in args.sizes.split(",")), args.frames,
        args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
