"""Triangle intersection constants and the dense Moller-Trumbore sweep
(counterpart of ``srt_tpu/ops/intersect.py``; reference
``IntersectsTriangle``, ray_intersects.glsl:61-96)."""

from __future__ import annotations

import torch

from srt_tpu_torch.ops.vec import cross, dot

MT_PARALLEL_EPS = 1e-4   # ray-parallel epsilon (ray_intersects.glsl:73)
MT_HIT_EPS = 1e-5        # minimum hit distance  (ray_intersects.glsl:89)


def mt_refine(origins, dirs, v0, e1, e2):
    """Exact Moller-Trumbore of one triangle per ray (the walk's winner):
    [3, N] operands, e1 = v1 - v0, e2 = v2 - v0.  Returns (t, u, v) [N],
    without the hit tests (the walk already made them)."""
    h = cross(dirs, e2)
    a = dot(e1, h)
    parallel = a.abs() < MT_PARALLEL_EPS
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = origins - v0
    q = cross(s, e1)
    return f * dot(e2, q), f * dot(s, h), f * dot(dirs, q)


def _cross_last(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def moller_trumbore(origins, dirs, v0, v1, v2):
    """Dense ray x triangle Moller-Trumbore.

    origins/dirs: [N, 3]; v0/v1/v2: [T, 3].  Returns (t [N, T] with inf
    for a miss, u [N, T], v [N, T]); the caller takes the min over T.
    """
    e1 = v1 - v0                                             # [T, 3]
    e2 = v2 - v0
    h = _cross_last(dirs[:, None, :], e2[None, :, :])        # [N, T, 3]
    a = (e1[None] * h).sum(-1)                               # [N, T]
    parallel = a.abs() < MT_PARALLEL_EPS
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = origins[:, None, :] - v0[None, :, :]                 # [N, T, 3]
    u = f * (s * h).sum(-1)
    q = _cross_last(s, e1[None, :, :])                       # [N, T, 3]
    v = f * (dirs[:, None, :] * q).sum(-1)
    t = f * (e2[None] * q).sum(-1)
    miss = parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0) \
        | (t <= MT_HIT_EPS)
    return torch.where(miss, torch.full_like(t, float("inf")), t), u, v
