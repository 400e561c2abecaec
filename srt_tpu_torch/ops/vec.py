"""Component-first vector math for ray wavefronts (counterpart of
``srt_tpu/ops/vec.py``).

The port keeps the JAX package's public layout: a batch of N 3-vectors is
``[3, N]``, per-ray scalars are ``[N]``.  The operation order of each
helper matches the JAX one so the two packages round alike.
"""

from __future__ import annotations

import torch


def bc(s):
    """Broadcast a per-ray scalar [N] against vectors [3, N]."""
    return s[None, :]


def dot(a, b):
    """Component-axis dot: [3, N] x [3, N] -> [N]."""
    return (a * b).sum(0)


def cross(a, b):
    """Cross product along axis 0: [3, N] x [3, N] -> [3, N]."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def norm2(v):
    """Squared length [N]."""
    return (v * v).sum(0)


def normalize(v, fallback=None):
    """Unit vector along axis 0; zero-length vectors pass through (or take
    ``fallback``)."""
    s = norm2(v)
    ok = s > 0.0
    inv = torch.rsqrt(torch.where(ok, s, torch.ones_like(s)))
    out = v * torch.where(ok, inv, torch.ones_like(inv))[None, :]
    if fallback is not None:
        out = torch.where(ok[None, :], out, fallback)
    return out


def col(v, device=None):
    """[3] table row -> [3, 1] broadcast column (float32)."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(3, 1)
