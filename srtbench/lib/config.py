"""Configurations and traffic mixes as data (frozen): the cell's merged
settings and the mesh made from them.

A configuration file may name another of ``configs/`` as its ``base``
and hold only what differs from it: the base's groups, with the file's
own laid over them (``merged``), so that one scene is written once."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np

from srtbench.lib import uvsphere


def merged(config: dict, traffic: dict) -> dict:
    """The configuration with the traffic's ``overrides`` laid over it,
    group by group (one level deep)."""
    out = copy.deepcopy(config)
    for group, values in traffic.get("overrides", {}).items():
        if isinstance(values, dict):
            out.setdefault(group, {}).update(values)
        else:
            out[group] = values
    return out


def load(path) -> dict:
    """The configuration in ``path``, its ``base`` (a name in the same
    folder) resolved first."""
    path = Path(path)
    with open(path) as f:
        config = json.load(f)
    base = config.pop("base", None)
    if base is None:
        return config
    return merged(load(path.parent / f"{base}.json"),
                  {"overrides": config})


def make_mesh(spec: dict):
    """(positions [V, 3] float32, uvs [V, 2] float32, tri_vidx [T, 3]
    uint32) of the configuration's mesh."""
    if spec["generator"] != "uv_sphere":
        raise ValueError(f"unknown mesh generator {spec['generator']!r}")
    return uvsphere.uv_sphere(int(spec["rows"]), int(spec["cols"]),
                              float(spec["radius"]),
                              tuple(spec.get("center", (0.0, 0.0, 0.0))))


def bounding_sphere(positions: np.ndarray):
    lo, hi = positions.min(0), positions.max(0)
    c = (lo.astype(np.float64) + hi) / 2
    return c, float(np.sqrt(((positions - c) ** 2).sum(1)).max()) * 1.001
