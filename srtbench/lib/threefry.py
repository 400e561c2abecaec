"""Threefry-2x32 uniforms (frozen, plain PyTorch on any device): the
lattice that the port's frames draw from, worked out again for the
reference.

A key is two uint32 words in an int64 tensor [2].  ``key(seed)`` is
``(0, seed mod 2**32)``; ``fold_in(k, x)`` is both words of
``threefry2x32(k, (0, x))``.  A ``[rows, n]`` block at key ``k`` has
element (r, c) = ``w0 ^ w1`` of ``threefry2x32(k, (0, r * n + c))``
(uint32 arithmetic), mapped to a float in [0, 1) as
``((bits >> 9) | 0x3F800000) - 1``.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for rot in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << rot) & _M32) | (x1 >> (32 - rot))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    x = torch.tensor([int(data) & _M32], dtype=torch.int64, device=k.device)
    y0, y1 = _threefry(k[0], k[1], torch.zeros_like(x), x)
    return torch.cat([y0, y1])


def uniforms_at(k: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """float32 uniforms at lattice points ``points`` (int64, any shape)."""
    j = points.to(torch.int64) & _M32
    y0, y1 = _threefry(k[0], k[1], torch.zeros_like(j), j)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def block_columns(k: torch.Tensor, rows, n: int, cols) -> torch.Tensor:
    """Rows ``rows`` (a sequence of ints) and columns ``cols`` (int64 [m])
    of the ``[*, n]`` block at ``k``: float32 [len(rows), m]."""
    r = torch.as_tensor(list(rows), dtype=torch.int64, device=k.device)
    return uniforms_at(k, r[:, None] * n + cols.to(torch.int64)[None, :])
