"""Progressive interactive-style render session (counterpart of
``srt_tpu/app.py``).

The reference's app layer (src/main.cpp frame loop and InputHandler): a
``RenderSession`` owns the accumulation state, traces one 1-spp frame per
``step()`` (raytrace_compute.glsl:400-406), offers the reference's camera
verbs (WASD movement, mouse-style rotation, reset: input_handler.cpp:
30-138), and clears the accumulation buffer on every camera change, as
the ``resetAccumBuffer`` protocol does (src/main.cpp:622-647).

No window system: a frame resolves to an sRGB image the caller can save
(``utils/image.py``) or display.  The session's key and accumulation
buffer live on the device of the ``lights`` it is given, which is where
the caller put the scene.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from srt_tpu_torch.camera import FPSCamera
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh as mesh_mod
from srt_tpu_torch.models.fastpath import build_hit_fns, default_walks
from srt_tpu_torch.models.pathtracer import trace_image_sample
from srt_tpu_torch.models.wavefront_compact import (discover_schedule,
                                                    trace_image_compact)
from srt_tpu_torch.ops import rng, tonemap
from srt_tpu_torch.utils.validate import (heal_accumulation,
                                          validate_render_state)


class RenderSession:
    """Progressive accumulation renderer with FPS camera controls."""

    def __init__(self, closest_hit, lights, cam: CameraConfig,
                 cfg: Optional[RenderConfig] = None, seed: int = 0,
                 show_model: bool = False, validate_every: int = 0,
                 log_fn=None, scene=None, fast: bool = False):
        """``validate_every > 0`` runs the render-state validator every N
        frames and heals corrupted accumulation texels
        (``utils/validate.py``, the ``ValidateRenderState`` analog,
        src/main.cpp:358-379).  ``log_fn(metrics_dict)`` receives each
        frame's metrics (frame index, wall ms, accumulation depth, healed
        texels).

        ``fast=True`` (requires ``scene``, a MeshScene) traces each frame
        through the library fast path: the default walk schedule and the
        width-compacted driver (``models/fastpath.py``), with the camera
        pose passed per frame.  The width schedule is probed at ``cam``'s
        pose with extra margin; a frame that overflows it (the camera
        moved somewhere with more live paths) is traced again at full
        width and the schedule stays widened: frames are never silently
        wrong.  Scenes of at most 8 superclusters take the scan
        integrator over the walk instead, as the JAX session does; then,
        and on the fast path, ``closest_hit`` is not used, and neither is
        ``cfg.nee`` (no emitter tables are passed), also as in JAX."""
        self.cfg = dataclasses.replace(cfg or RenderConfig(), spp=1)
        self.cam_cfg = cam
        self.camera = FPSCamera(position=tuple(cam.origin))
        self._show_model = show_model
        dev = lights.position.device
        self._key = rng.key(seed, dev)
        self._accum = torch.zeros((cam.height, cam.width, 3),
                                  dtype=torch.float32, device=dev)
        self.frames_accumulated = 0
        self._frame_index = 0
        self._validate_every = validate_every
        self._log_fn = log_fn
        self._lights = lights
        self.metrics = {
            "frames": 0, "last_frame_ms": 0.0, "avg_frame_ms": 0.0,
            "healed_texels": 0, "last_report": None,
        }

        self._fast = bool(fast)
        if fast:
            if scene is None:
                raise ValueError("fast=True needs the MeshScene (scene=)")
            if mesh_mod.n_superclusters(scene) <= 8:
                closest_hit = mesh_mod.mesh_hit_fn(scene, method="walk")
                self._fast = False
        self._closest_hit = closest_hit
        self.schedule = None
        if self._fast:
            n_b = self.cfg.max_depth + self.cfg.rr_bounces
            fcfg = dataclasses.replace(self.cfg, sort_bounces=n_b > 1,
                                       uniform_use_spec=True)
            if fcfg.sort_shadows_from is None:
                fcfg = dataclasses.replace(fcfg, sort_shadows_from=2)
            self._fast_cfg = fcfg
            self._hit_fns = build_hit_fns(scene, *default_walks(scene, n_b))
            # Extra margin over the plan's: the schedule must survive
            # camera motion, not just the random numbers.
            self.schedule = discover_schedule(self._hit_fns, lights, cam,
                                              fcfg, self._key, margin=1.6)

    # -- camera verbs (InputHandler analog) --------------------------------

    def move(self, forward=0.0, strafe=0.0, vertical=0.0):
        """WASD/Space/Shift (input_handler.cpp:30-78); resets accumulation."""
        self.camera.move(forward, strafe, vertical)
        self.reset_accumulation()

    def rotate(self, yaw_offset: float, pitch_offset: float):
        """Mouse-drag look (input_handler.cpp:81-138); resets accumulation."""
        self.camera.rotate(yaw_offset, pitch_offset)
        self.reset_accumulation()

    def reset_camera(self):
        """'R' key (input_handler.cpp:62-66): the per-scene default pose."""
        self.camera.reset(self._show_model)
        self.reset_accumulation()

    def reset_accumulation(self):
        """``resetAccumBuffer`` protocol (main.cpp:622-647)."""
        self._accum = torch.zeros_like(self._accum)
        self.frames_accumulated = 0

    # -- frame loop --------------------------------------------------------

    def _sample(self, key, origin, look_at):
        """One linear 1-spp frame [H, W, 3] at the given pose."""
        n = self.cam_cfg.height * self.cam_cfg.width
        stream = rng.KeyStream(key, n)
        if not self._fast:
            return trace_image_sample(self._closest_hit, self._lights,
                                      self.cam_cfg, self.cfg, stream,
                                      origin=origin, look_at=look_at)
        sample, _, ovf = trace_image_compact(
            self._hit_fns, self._lights, self.cam_cfg, self._fast_cfg,
            stream, self.schedule, origin=origin, look_at=look_at,
            return_stats=True)
        if int(ovf) != 0:
            # The pose outgrew the probed width schedule: trace this frame
            # again at full width (always enough) and keep that schedule.
            self.schedule = (n,) * len(self.schedule)
            sample = trace_image_compact(
                self._hit_fns, self._lights, self.cam_cfg, self._fast_cfg,
                rng.KeyStream(key, n), self.schedule, origin=origin,
                look_at=look_at)
        return sample

    def step(self, fetch: bool = True):
        """Trace one 1-spp frame, accumulate, and return the sRGB display
        image (float [H, W, 3] in [0, 1]): a numpy array, or with
        ``fetch=False`` the tensor on the session's device once the card
        has finished it (no host copy, the analog of the reference's
        on-GPU blit, src/main.cpp:600-769)."""
        t0 = time.perf_counter()
        key = rng.fold_in(self._key, self._frame_index)
        self._frame_index += 1
        sample = self._sample(key, self.camera.position,
                              self.camera.look_at())
        self._accum, display = tonemap.accumulate(
            self._accum, sample, self.frames_accumulated)
        self.frames_accumulated += 1

        if (self._validate_every
                and self._frame_index % self._validate_every == 0):
            report = validate_render_state(sample, self._accum, self.camera)
            self.metrics["last_report"] = report
            if not report.ok:
                self._accum, healed = heal_accumulation(self._accum)
                self.metrics["healed_texels"] += healed

        if fetch:
            display = display.cpu().numpy()
        elif display.is_cuda:
            torch.cuda.synchronize(display.device)
        dt_ms = (time.perf_counter() - t0) * 1e3
        m = self.metrics
        m["frames"] += 1
        m["last_frame_ms"] = dt_ms
        m["avg_frame_ms"] += (dt_ms - m["avg_frame_ms"]) / m["frames"]
        if self._log_fn is not None:
            self._log_fn({"frame": self._frame_index, "ms": dt_ms,
                          "accumulated": self.frames_accumulated,
                          "healed_texels": m["healed_texels"]})
        return display

    def run(self, frames: int, callback: Optional[Callable] = None):
        """Accumulate ``frames`` frames; returns the last display image.
        ``callback(i, display)`` runs after each frame (for example to
        save a turntable)."""
        display = None
        for i in range(frames):
            display = self.step()
            if callback is not None:
                callback(i, display)
        return display

    def snapshot(self) -> np.ndarray:
        """The current resolved sRGB image, without tracing a frame."""
        return tonemap.resolve(self._accum,
                               self.frames_accumulated).cpu().numpy()
