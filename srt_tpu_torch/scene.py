"""Scene data: materials, spheres, point lights and the default scenes
(counterpart of ``srt_tpu/scene.py``), structure-of-arrays tensors on an
explicit device.  Every constructor takes ``device=None``, the card
(``devices.resolve``)."""

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
class Spheres:
    """Sphere primitives (reference ``Sphere``, raytrace_types.glsl):
    center [S, 3], radius [S], one material per sphere."""

    center: torch.Tensor
    radius: torch.Tensor
    materials: Materials

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@dataclasses.dataclass(frozen=True)
class Lights:
    """Point lights (reference ``PointLight``, light.h:8-17)."""

    position: torch.Tensor   # [L, 3]
    color: torch.Tensor      # [L, 3]
    intensity: torch.Tensor  # [L]

    @property
    def count(self) -> int:
        return self.intensity.shape[0]


MATERIAL_FIELDS = ("albedo", "specular", "roughness", "metalness", "use_spec")


def _f32(x, device):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _materials(albedo, specular, rough, metal, use_spec, device) -> Materials:
    return Materials(
        albedo=_f32(albedo, device), specular=_f32(specular, device),
        roughness=_f32(rough, device), metalness=_f32(metal, device),
        use_spec=torch.tensor(np.asarray(use_spec, bool), device=device))


def make_materials(rows, device=None) -> Materials:
    """Materials from a list of (albedo, specular, rough, metal, use_spec)
    rows, on ``device`` (None: the card)."""
    return _materials(*zip(*rows), device=resolve(device))


def spheres_from_arrays(d: dict, device) -> Spheres:
    """Build ``Spheres`` from numpy arrays keyed by field name: ``center``,
    ``radius`` and the material fields (``MATERIAL_FIELDS``), for example
    the leaves of the JAX ``Spheres`` and its ``materials``."""
    return Spheres(
        center=_f32(d["center"], device), radius=_f32(d["radius"], device),
        materials=_materials(*(d[k] for k in MATERIAL_FIELDS),
                             device=device))


def default_sphere_scene(device=None) -> Spheres:
    """The 5-sphere demo scene (raytrace_compute.glsl:299-364), in the
    reference ``world[]`` order: blue, ground, green, red, yellow."""
    device = resolve(device)
    mats = make_materials([
        ((0.2, 0.4, 1.0), (0.8, 0.8, 0.9), 0.01, 0.9, False),    # blue
        ((0.2, 0.8, 0.8), (0.2, 0.4, 0.4), 0.01, 0.99, False),   # ground
        ((0.2, 0.9, 0.3), (0.2, 0.9, 0.9), 0.3, 0.95, True),     # green
        ((0.8, 0.3, 0.3), (0.9, 0.7, 0.7), 0.1, 0.5, True),      # red
        ((0.9, 0.8, 0.1), (0.3, 0.3, 0.1), 0.7, 0.3, False),     # yellow
    ], device)
    center = [(1.8, 0.0, -2.0), (0.0, -100.5, -1.0), (0.55, 0.0, -2.0),
              (-0.55, 0.0, -2.0), (-1.8, 0.0, -2.0)]
    return Spheres(center=_f32(center, device),
                   radius=_f32([0.5, 100.0, 0.5, 0.5, 0.5], device),
                   materials=mats)


def sphere_scene_lights(device=None) -> Lights:
    """Two-light rig of the sphere scene (src/main.cpp:592-595)."""
    return lights_from_arrays({
        "position": [(1.0, 2.0, 0.0), (-2.5, 2.0, 0.0)],
        "color": [(1.0, 1.0, 1.0), (1.0, 1.0, 1.0)],
        "intensity": [10.0, 3.0]}, resolve(device))


def random_sphere_scene(n: int, seed: int = 0, device=None) -> Spheres:
    """A procedural n-sphere scene; the same numpy draws, in the same
    order, as the JAX package's, so both build the same spheres."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-4.0, 4.0, size=(n, 3)).astype(np.float32)
    center[:, 2] -= 4.0
    radius = rng.uniform(0.2, 0.6, size=(n,)).astype(np.float32)
    device = resolve(device)
    mats = _materials(
        rng.uniform(0.1, 0.9, size=(n, 3)), rng.uniform(0.1, 0.9, size=(n, 3)),
        rng.uniform(0.01, 0.9, size=(n,)), rng.uniform(0.0, 1.0, size=(n,)),
        rng.uniform(size=(n,)) < 0.5, device)
    return Spheres(center=_f32(center, device), radius=_f32(radius, device),
                   materials=mats)


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
