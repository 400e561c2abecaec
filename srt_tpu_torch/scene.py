"""Scene data: materials and point lights (counterpart of
``srt_tpu/scene.py``), structure-of-arrays tensors on an explicit device."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from srt_tpu_torch.devices import resolve


@dataclasses.dataclass(frozen=True)
class Materials:
    """Shading materials (GLSL ``Material``).  As a table: albedo/specular
    [M, 3], roughness/metalness/use_spec [M]; per ray (the ``Hit`` record):
    [3, N] and [N]."""

    albedo: torch.Tensor
    specular: torch.Tensor
    roughness: torch.Tensor
    metalness: torch.Tensor
    use_spec: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Lights:
    """Point lights (reference ``PointLight``, light.h:8-17)."""

    position: torch.Tensor   # [L, 3]
    color: torch.Tensor      # [L, 3]
    intensity: torch.Tensor  # [L]

    @property
    def count(self) -> int:
        return self.intensity.shape[0]


def lights_from_arrays(d: dict, device) -> Lights:
    """Build ``Lights`` from numpy arrays keyed by field name (for example
    the leaves of the JAX ``Lights``, taken with ``np.asarray``)."""
    return Lights(**{
        k: torch.tensor(np.asarray(d[k], np.float32), device=device)
        for k in ("position", "color", "intensity")
    })


def model_scene_lights(device=None) -> Lights:
    """Six-light rig of the model scene (src/main.cpp:584-589), on
    ``device`` (None: the card, ``devices.resolve``)."""
    pos = [
        (1.0, 10.0, 10.0),
        (-5.0, 15.0, 10.0),
        (5.0, 15.0, 10.0),
        (-5.0, 5.0, 10.0),
        (5.0, 5.0, 10.0),
        (0.0, 21.0, 17.0),
    ]
    col = [
        (1.0, 1.0, 1.0),
        (1.0, 0.2, 0.2),
        (0.2, 1.0, 0.2),
        (0.2, 0.2, 1.0),
        (1.0, 1.0, 0.1),
        (1.0, 1.0, 1.0),
    ]
    inten = [50.0, 15.0, 15.0, 15.0, 15.0, 50.0]
    return lights_from_arrays(
        {"position": pos, "color": col, "intensity": inten}, resolve(device))
