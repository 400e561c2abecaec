"""Morton (Z-order) ray permutation (counterpart of ``srt_tpu/ops/morton.py``).

Primary rays are traced in Z-order so a kernel tile covers a compact pixel
block instead of an image row.  The permutation is a host numpy table.  The
compact driver keeps the uniforms in pixel order and each ray carries its
pixel id; the scan integrator permutes every uniform block the same way
(``PermutedStream``).  Either way the image is bit-identical.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of x so there is a 0 between each bit."""
    x = x.astype(np.uint32) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


@functools.lru_cache(maxsize=32)
def morton_perm(height: int, width: int):
    """Pixel permutation along the Z-order curve for an H x W image.

    Returns (perm, inv) int32 numpy arrays of length H*W such that
    ``rays_morton = rays[:, perm]`` and ``image = out[:, inv]`` (stable
    argsort of the codes, so any H, W works).  The cached arrays are
    shared: callers must not write to them.
    """
    ys, xs = np.meshgrid(
        np.arange(height, dtype=np.uint32),
        np.arange(width, dtype=np.uint32),
        indexing="ij",
    )
    code = (_part1by1(ys) << 1) | _part1by1(xs)
    perm = np.argsort(code.reshape(-1), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def permute_rays(origins, dirs, perm):
    """Apply a ray permutation to [3, N] origin/direction pairs."""
    idx = torch.as_tensor(perm, device=origins.device).long()
    return origins[:, idx], dirs[:, idx]


class PermutedStream:
    """Wraps a stream so its ``take`` blocks come out in ray (permuted)
    order while the base stream stays in pixel order: pixel p consumes the
    same numbers either way.  Only ``take`` is forwarded, so no other draw
    can bypass the permutation."""

    def __init__(self, base, perm):
        self._base = base
        self._perm = perm
        self._idx = None

    def take(self, k: int):
        u = self._base.take(k)
        if self._idx is None:
            self._idx = torch.as_tensor(self._perm, device=u.device).long()
        return u[:, self._idx]

    def __getattr__(self, name):
        raise AttributeError(
            f"PermutedStream forwards only take(); draw method {name!r} "
            "would bypass the ray permutation")


def unpermute_image(radiance, inv):
    """Inverse-permute [3, N] radiance back to pixel order."""
    return radiance[:, torch.as_tensor(inv, device=radiance.device).long()]
