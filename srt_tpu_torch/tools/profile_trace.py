"""``torch.profiler`` trace of one frame on the Rubik grid through the
walk, and its top device operations (``tools/profile_trace.py``'s
counterpart).

Run as ``python3 -m srt_tpu_torch.tools.profile_trace [--device DEV]
[--size N] [--trace-dir DIR] [--top K]``: one untimed frame, then one
frame under the profiler (``utils/profiling.profile_trace``, which writes
``DIR/trace.json``; a new temporary directory by default), summed by
``parse_trace``.  The scene is ``procgen.rubik_grid()`` (JAX's tool loads
the reference's Rubik OBJ, which the repository does not hold).
"""

from __future__ import annotations

import argparse
import sys

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import common, parse_trace


def run(device=None, scene=None, size: int = 512, trace_dir=None,
        top: int = 40, verbose: bool = True):
    """Returns one record: ``frame_ms`` (the untimed frame's wall),
    ``device_ms`` (the traced frame's device operations; None on the
    CPU), ``events``, ``top`` and ``trace`` (the file's path)."""
    dev = resolve(device)
    card = common.header("profile_trace", dev, verbose)
    scene = scene if scene is not None else common.rubik_scene(dev)
    lights = model_scene_lights(dev)
    cam = common.camera(size, common.RUBIK_CAMERA)
    cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=1)
    hit_fn = mesh.mesh_hit_fn(scene, method="walk")
    n = size * size
    vp = derive_viewport(cam, device=dev)

    def frame(key):
        s = rng.KeyStream(key, n)
        o, d = generate_rays(vp, size, size, s.take(2))
        return pathtracer.trace_wavefront(hit_fn, lights, o, d, s, cfg)

    secs = common.wall_s(lambda: frame(rng.key(0, dev)), dev=dev, reps=1,
                         warm=0)
    summary, path = common.profiled(lambda: frame(rng.key(1, dev)), dev,
                                    trace_dir, top)
    rec = dict(frame_ms=secs * 1e3, device_ms=summary["total_ms"],
               events=summary["events"], top=summary["top"], trace=path,
               device=card)
    if verbose:
        print(f"frame (untimed warm-up): {secs * 1e3:.3f} ms; trace {path}",
              flush=True)
        parse_trace.print_summary(summary)
    return [rec]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--trace-dir")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    dev = common.cli_device("profile_trace", args.device)
    if dev is None:
        return 2
    run(dev, None, args.size, args.trace_dir, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
