"""Camera: viewport derivation, batched primary rays and the interactive
session's ``FPSCamera`` (counterpart of ``srt_tpu/camera.py``; reference
``GetCamera``/``GetRay``, raytrace_compute.glsl:47-90).  All tensor
arithmetic is float32, in the JAX package's operation order."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from srt_tpu_torch.config import CameraConfig
from srt_tpu_torch.devices import resolve


@dataclasses.dataclass(frozen=True)
class Viewport:
    """Derived per-frame camera frame: ``pixel00`` is the center of pixel
    (0, 0), ``delta_u``/``delta_v`` step one pixel in x/y.  [3] tensors."""

    center: torch.Tensor
    pixel00: torch.Tensor
    delta_u: torch.Tensor
    delta_v: torch.Tensor
    defocus_u: torch.Tensor
    defocus_v: torch.Tensor


def _normalize(v):
    return v / torch.sqrt((v * v).sum())


def camera_basis(origin, look_at, v_up):
    """Right-handed (u, v, w) basis with w pointing away from the view."""
    front = _normalize(look_at - origin)
    right = _normalize(torch.linalg.cross(front, v_up))
    up = _normalize(torch.linalg.cross(right, front))
    return right, up, -front


def derive_viewport(cfg: CameraConfig, origin=None, look_at=None,
                    device=None) -> Viewport:
    """Build the Viewport from a CameraConfig (``GetCamera`` analog) on
    ``device`` (None: the card, ``devices.resolve``).  ``origin`` /
    ``look_at`` ([3] tensors or sequences, for example a camera pose that
    takes gradients) override the config's."""
    device = resolve(device)

    def vec3(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    origin = vec3(cfg.origin if origin is None else origin)
    look_at = vec3(cfg.look_at if look_at is None else look_at)
    u, v, w = camera_basis(origin, look_at, vec3(cfg.v_up))

    if cfg.viewport_mode == "reference":
        view_u = u * cfg.focus_dist
        view_v = v * cfg.focus_dist
    elif cfg.viewport_mode == "vfov":
        h = math.tan(math.radians(cfg.vfov) / 2.0)
        view_h = 2.0 * h * cfg.focus_dist
        view_w = view_h * cfg.aspect
        view_u = u * view_w
        view_v = v * view_h
    else:
        raise ValueError(f"unknown viewport_mode: {cfg.viewport_mode}")

    delta_u = view_u / cfg.width
    delta_v = view_v / cfg.height
    lower_left = origin - cfg.focus_dist * w - view_u / 2.0 - view_v / 2.0
    pixel00 = lower_left + 0.5 * (delta_u + delta_v)

    defocus_radius = cfg.focus_dist * math.tan(
        math.radians(cfg.defocus_angle / 2.0))
    return Viewport(center=origin, pixel00=pixel00, delta_u=delta_u,
                    delta_v=delta_v, defocus_u=u * defocus_radius,
                    defocus_v=v * defocus_radius)


def generate_rays(vp: Viewport, width: int, height: int,
                  jitter: torch.Tensor, defocus: torch.Tensor = None):
    """Primary rays for the full image as a wavefront batch.

    ``jitter``: [2, N] uniforms in [0, 1) (the pixel-area sample, centered
    to [-0.5, 0.5)); with N = K * H * W each pixel's K samples are
    adjacent.  ``defocus``: optional [2, N] thin-lens uniforms.  Returns
    (origins [3, N], directions [3, N]), directions unnormalized, pixels
    in row-major (y, x) order.
    """
    dev = jitter.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    i = xs.reshape(-1)
    j = ys.reshape(-1)
    if jitter.shape[1] != i.shape[0]:
        k, rem = divmod(jitter.shape[1], i.shape[0])
        if rem:
            raise ValueError(f"jitter width {jitter.shape[1]} is not a "
                             f"multiple of the pixel count {i.shape[0]}")
        i = torch.repeat_interleave(i, k)
        j = torch.repeat_interleave(j, k)
    off = jitter - 0.5
    px = vp.pixel00[:, None] \
        + (i + off[0])[None, :] * vp.delta_u[:, None] \
        + (j + off[1])[None, :] * vp.delta_v[:, None]
    origins = vp.center[:, None].expand(px.shape)
    if defocus is not None:
        r = torch.sqrt(defocus[0])
        theta = 2.0 * math.pi * defocus[1]
        origins = origins \
            + (r * torch.cos(theta))[None, :] * vp.defocus_u[:, None] \
            + (r * torch.sin(theta))[None, :] * vp.defocus_v[:, None]
    return origins, px - origins


# ---------------------------------------------------------------------------
# FPS-style camera state (host-side analog of Camera/InputHandler:
# src/raytracer/camera.cpp:138-212, src/input_handler.cpp:30-138).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FPSCamera:
    """Mutable yaw/pitch camera of the interactive session (``app.py``),
    plain ``math`` on Python tuples, as the JAX package's.

    Yaw -90 looks down -z; pitch is clamped to +/-89 degrees
    (camera.cpp:106-117); the basis is recomputed from a fixed world up,
    so it does not drift (camera.cpp:173-184)."""

    position: Tuple[float, float, float] = (0.0, 1.0, 4.0)
    yaw: float = -90.0
    pitch: float = 0.0

    def basis(self):
        cy, sy = (math.cos(math.radians(self.yaw)),
                  math.sin(math.radians(self.yaw)))
        cp, sp = (math.cos(math.radians(self.pitch)),
                  math.sin(math.radians(self.pitch)))
        front = (cy * cp, sp, sy * cp)
        n = math.sqrt(sum(c * c for c in front))
        front = tuple(c / n for c in front)
        right = (
            front[1] * 0.0 - front[2] * 1.0,
            front[2] * 0.0 - front[0] * 0.0,
            front[0] * 1.0 - front[1] * 0.0,
        )
        rn = math.sqrt(sum(c * c for c in right)) or 1.0
        right = tuple(c / rn for c in right)
        up = (
            right[1] * front[2] - right[2] * front[1],
            right[2] * front[0] - right[0] * front[2],
            right[0] * front[1] - right[1] * front[0],
        )
        return front, right, up

    def move(self, forward=0.0, strafe=0.0, vertical=0.0):
        """WASD/Space/Shift movement (input_handler.cpp:30-78)."""
        front, right, up = self.basis()
        self.position = tuple(
            p + forward * f + strafe * r + vertical * u
            for p, f, r, u in zip(self.position, front, right, up))

    def rotate(self, yaw_offset: float, pitch_offset: float):
        """Mouse-drag rotation with the pitch clamp (camera.cpp:106-117)."""
        self.yaw += yaw_offset
        self.pitch = max(-89.0, min(89.0, self.pitch + pitch_offset))

    def reset(self, show_model: bool = False):
        """Per-scene default pose (camera.cpp:187-212)."""
        self.position = (0.0, 9.0, 40.0) if show_model else (0.0, 1.0, 4.0)
        self.yaw, self.pitch = -90.0, 0.0

    def look_at(self) -> Tuple[float, float, float]:
        front, _, _ = self.basis()
        return tuple(p + f for p, f in zip(self.position, front))

    def config(self, base: CameraConfig) -> CameraConfig:
        return dataclasses.replace(base, origin=tuple(self.position),
                                   look_at=self.look_at())
