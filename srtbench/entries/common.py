"""What the entries share: the port's scene made from the configuration's
inputs, the device record, and the traced reading handed to the
per-layer metrics."""

from __future__ import annotations

import dataclasses
import gc
from typing import Optional

import numpy as np
import torch

from srtbench.lib import config as config_mod
from srtbench.lib.spans import Spans

# Warm-up frames draw from the top of the frame index range, away from
# the window's frames 0, 1, 2, ...
WARM_BASE = 2 ** 32 - 1


def device_for(rank: int = 0, cpu: bool = False) -> torch.device:
    return torch.device("cpu") if cpu else torch.device("cuda", rank)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_scene(cfg: dict, dev: torch.device, spans: Spans):
    """(mesh arrays, the port's MeshScene, its Lights): the mesh is made
    here from the configuration; the port flattens and uploads it inside
    the ``srtbench.scene_build`` span."""
    from srt_tpu_torch.models import mesh as mesh_mod
    from srt_tpu_torch.scene import lights_from_arrays
    from srt_tpu_torch.utils.flatten import flatten_models
    from srt_tpu_torch.utils.obj_loader import MaterialDef, MeshData

    arrays = config_mod.make_mesh(cfg["mesh"])
    pos, uvs, vidx = arrays
    m = cfg["material"]
    data = MeshData(positions=pos, uvs=uvs, tri_vidx=vidx,
                    tri_mat=np.zeros(vidx.shape[0], np.uint32),
                    materials=[MaterialDef(
                        diffuse=tuple(m["diffuse"]),
                        specular=tuple(m["specular"]),
                        specular_ex=float(m["specular_ex"]))],
                    name="srtbench")
    with spans.span("srtbench.scene_build"):
        flat = flatten_models([data], pad_to=int(cfg["pad_to"]))
        scene = mesh_mod.upload(flat, dev)
        sync(dev)
    lights = lights_from_arrays(cfg["lights"], dev)
    return arrays, scene, lights


def camera_and_render(cfg: dict):
    from srt_tpu_torch.config import CameraConfig, RenderConfig

    c, r = cfg["camera"], cfg["render"]
    cam = CameraConfig(width=int(c["width"]), height=int(c["height"]),
                       origin=tuple(c["origin"]), look_at=tuple(c["look_at"]),
                       v_up=tuple(c.get("v_up", (0.0, 1.0, 0.0))),
                       focus_dist=float(c.get("focus_dist", 1.0)),
                       viewport_mode=c.get("viewport_mode", "reference"))
    rc = RenderConfig(max_depth=int(r["max_depth"]),
                      rr_bounces=int(r["rr_bounces"]), spp=int(r["spp"]),
                      t_min=float(r["t_min"]),
                      sky_color=tuple(r["sky_color"]),
                      sort_bounces=bool(r.get("sort_bounces", False)))
    return cam, rc


def device_record(dev: torch.device, chips: int, peak: int) -> dict:
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": kind, "count": chips, "memory_peak_bytes": int(peak)}


def peak_bytes(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Reading:
    """What the per-layer metrics read in a traced run: the profiler
    window, the benchmark's host spans (seconds by name), the work counted
    for the walk calls of one traced frame, and the traced steps."""
    trace: Optional[object]
    spans: dict
    work: list
    steps: int
    extra: dict

