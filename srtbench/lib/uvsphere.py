"""The headline mesh, made in bulk (numpy): a UV sphere with the vertex
order, per-corner vertices and float32 rounding of the port's
``procgen.uv_sphere``, without its Python loop per triangle."""

from __future__ import annotations

import numpy as np


def uv_sphere(rows: int, cols: int, radius: float = 1.0,
              center=(0.0, 0.0, 0.0)):
    """(positions [3T, 3] float32, uvs [3T, 2] float32, tri_vidx [T, 3]
    uint32): quad (r, s) of the rows x cols grid gives the triangle
    (r, s), (r+1, s), (r+1, s+1) unless r is the top row and the triangle
    (r, s), (r+1, s+1), (r, s+1) unless r is the bottom row, each corner
    its own vertex, in row-major quad order."""
    c = np.asarray(center, np.float32)
    r, s = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    cr = np.stack([r, r + 1, r + 1, r], -1)            # quad corners
    cs = np.stack([s, s, s + 1, s + 1], -1)
    corners = np.array([[0, 1, 2], [0, 2, 3]])         # the two triangles
    keep = np.stack([r > 0, r < rows - 1], -1)         # [rows, cols, 2]
    tr = cr[:, :, corners][keep]                       # [T, 3]
    ts = cs[:, :, corners][keep]
    rr = tr.reshape(-1).astype(np.float64)
    ss = ts.reshape(-1).astype(np.float64)
    theta = np.pi * rr / rows
    phi = 2 * np.pi * ss / cols
    unit = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                     np.sin(theta) * np.sin(phi)], -1).astype(np.float32)
    positions = c + radius * unit
    uvs = np.stack([ss / cols, 1.0 - rr / rows], -1).astype(np.float32)
    n_tri = tr.shape[0]
    tri_vidx = np.arange(3 * n_tri, dtype=np.uint32).reshape(n_tri, 3)
    return positions.astype(np.float32), uvs, tri_vidx
