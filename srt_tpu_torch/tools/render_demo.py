"""Render the two flagship scenes to images: the one-command visual check
(``tools/render_demo.py``'s counterpart).

Run as ``python3 -m srt_tpu_torch.tools.render_demo [--out DIR] [--size
N] [--spp S] [--device DEV]`` (default: the card, 512x512, 4 samples, into
``srt_demo`` under the temporary directory).  Writes ``rubik`` (the Rubik
grid, ``procgen.rubik_grid()``: the reference's OBJ is not in the
repository) and ``highpoly`` (the 101,760-triangle headline mesh) through
the walk, as PNG where PIL is installed and as PPM otherwise, rows top
down.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.ops import rng, tonemap
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.utils.flatten import flatten_models
from srt_tpu_torch.utils.image import write_png, write_ppm
from srt_tpu_torch.utils.procgen import rubik_grid, uv_sphere


def run(out: str, size: int = 512, spp: int = 4, device=None) -> dict:
    """Render both scenes into ``out``; returns {name: (path, sRGB [H, W,
    3] numpy)}."""
    dev = resolve(device)
    os.makedirs(out, exist_ok=True)
    lights = model_scene_lights(dev)
    scenes = [
        ("rubik", rubik_grid(), (0.0, 20.0, 20.0), (0.0, 1.0, -1.0)),
        ("highpoly", uv_sphere(160, 320, radius=2.0),
         (0.0, 1.0, 5.0), (0.0, 0.0, 0.0)),
    ]
    results = {}
    for name, mesh_data, origin, look_at in scenes:
        scene = mesh.upload(flatten_models([mesh_data], pad_to=128), dev)
        cam = CameraConfig(width=size, height=size, origin=origin,
                           look_at=look_at)
        cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=spp,
                           sort_bounces=True)
        t0 = time.time()
        img = pathtracer.render(
            mesh.mesh_hit_fn(scene, method="walk", ray_tile=4096), lights,
            cam, cfg, rng.key(0, dev))
        srgb = tonemap.resolve(img, 1).cpu().numpy()
        path = os.path.join(out, f"{name}.png")
        if not write_png(path, srgb):
            path = path[:-4] + ".ppm"
            write_ppm(path, srgb)
        print(f"{name}: {mesh_data.num_triangles} tris, "
              f"{time.time() - t0:.1f}s (walk, {dev.type}) -> {path}  "
              f"srgb mean {srgb.mean():.3f}", flush=True)
        results[name] = (path, srgb)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "srt_demo"))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--device", help="default: the card")
    args = ap.parse_args(argv)
    try:
        dev = resolve(args.device)
    except RuntimeError as e:
        print(f"render_demo: {e}", file=sys.stderr)
        return 2
    run(args.out, args.size, args.spp, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
