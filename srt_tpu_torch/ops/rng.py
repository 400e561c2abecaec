"""Uniform streams for path tracing (counterpart of ``srt_tpu/ops/rng.py``).

Streams yield slot-major ``[k, N]`` blocks.  The slot protocol is the JAX
package's: pixel jitter (2 slots) first, then per bounce
``[ris_idx x L | ris_sel x L | lobe | rr | diff_r1 | diff_r2 | h_r1 | h_r2]``
(``2*L + 6`` slots).

* ``KeyStream`` draws from JAX's threefry lattice, bit for bit: ``key``,
  ``fold_in`` and ``split`` give the key data of ``jax.random.key`` /
  ``jax.random.fold_in`` / ``jax.random.split``, and a ``SlotBlock`` gives
  ``jax.random.uniform(key, (k, n))`` under the partitionable threefry
  layout (``jax_threefry_partitionable=True``, JAX's default): element j
  is ``w0 ^ w1`` of ``threefry2x32(key, (0, j))``, mapped to a float as
  ``((bits >> 9) | 0x3F800000) - 1``.  So a port frame and a JAX frame
  rendered with the same key draw the same numbers.
* ``ArrayStream`` slices an injected ``[N, D]`` uniform array: both
  packages consume the same array in the same slot order.

A key is an explicit int64 tensor of two uint32 values on the device that
will use it; there is no global random state.  The lattice is one CUDA
kernel (``csrc/threefry.cu``) on CUDA keys and its plain int64-emulated
version on CPU keys; ``plain=True`` forces the plain version on CUDA keys
(kernel-vs-plain comparisons only).  Each kernel launch adds one to
``launch_counts["threefry"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.ops import cuda_lib

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def bounce_slots(n_lights: int, nee: bool = False) -> int:
    """Uniform slots consumed per bounce; ``nee`` appends 3 slots after
    the base block."""
    return 2 * n_lights + 6 + (3 if nee else 0)


def total_slots(n_lights: int, n_bounces: int, nee: bool = False) -> int:
    """Total slots per path: pixel jitter + all bounces."""
    return 2 + n_bounces * bounce_slots(n_lights, nee)


# ---------------------------------------------------------------------------
# Threefry-2x32 and the lattice
# ---------------------------------------------------------------------------

def _threefry2x32_plain(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values;
    returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def threefry_plain(key, lo: int, rows: int, n: int, cols=None,
                   raw: bool = False):
    """Plain version of ``threefry``: lattice points
    ``j = (lo + r) * n + col`` (uint32 arithmetic) for r < ``rows`` and
    col in ``cols`` (default ``arange(n)``)."""
    dev = key.device
    col = (torch.arange(n, dtype=torch.int64, device=dev) if cols is None
           else cols.to(torch.int64))
    r = torch.arange(lo, lo + rows, dtype=torch.int64, device=dev)
    j = (r[:, None] * n + col[None, :]) & _M32
    y0, y1 = _threefry2x32_plain(key[0], key[1], torch.zeros_like(j), j)
    if raw:
        return torch.stack([y0.reshape(-1)[0], y1.reshape(-1)[0]])
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def threefry(key, lo: int, rows: int, n: int, cols=None, raw: bool = False,
             plain: bool = False):
    """The threefry lattice block at rows ``lo .. lo + rows`` of a
    ``[*, n]`` block and columns ``cols`` (int tensor [m], default all n):
    float32 uniforms [rows, m]; with ``raw`` (one element) the two words
    ``(w0, w1)`` as an int64 [2] tensor (``fold_in``).  Runs
    ``csrc/threefry.cu`` on CUDA keys (no memory read but the key, the
    column indices and the output), the plain version on CPU keys."""
    if not 0 <= lo < 2 ** 32 or not 0 <= n < 2 ** 32:
        raise ValueError(f"lattice offsets lo={lo}, n={n} exceed uint32")
    if key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise TypeError(f"a key is an int64 tensor of 2, got {key.dtype} "
                        f"{tuple(key.shape)}")
    if plain or key.device.type == "cpu":
        return threefry_plain(key, lo, rows, n, cols, raw)
    if key.device.type != "cuda":
        raise ValueError(f"threefry needs a CPU or CUDA key, got {key.device}")
    m = n if cols is None else cols.shape[0]
    if raw:
        if rows * m != 1:
            raise ValueError("raw output is one lattice point")
        out = torch.empty((2,), dtype=torch.int64, device=key.device)
    else:
        out = torch.empty((rows, m), dtype=torch.float32, device=key.device)
    if cols is not None:
        cols = cols.to(device=key.device, dtype=torch.int64).contiguous()
    cuda_lib.launch("threefry", key.contiguous(), cols, m, lo, rows, n,
                    int(raw), out)
    return out


# ---------------------------------------------------------------------------
# Keys and streams
# ---------------------------------------------------------------------------

def key(seed: int, device=None) -> torch.Tensor:
    """The key data of ``jax.random.key(seed)``: ``(0, seed mod 2**32)``,
    on ``device`` (None: the card, ``devices.resolve``)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=resolve(device))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """The key data of ``jax.random.fold_in(key, data)``: both words of
    ``threefry2x32(key, (0, data))``; ``data`` must fit in uint32."""
    if not 0 <= int(data) < 2 ** 32:
        raise ValueError(f"fold_in data {data} out of bounds for uint32")
    return threefry(key, int(data), 1, 1, raw=True)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """The key data of ``jax.random.split(key, num)``: [num, 2] int64, row
    i both words of ``threefry2x32(key, (0, i))``, which is ``fold_in(key,
    i)``.  That is JAX's split under the partitionable threefry layout
    (``jax_threefry_partitionable=True``, its default); the other layout
    splits to other bits."""
    return torch.stack([fold_in(key, i) for i in range(num)])


class SlotBlock:
    """A reserved [k, n] uniform block: ``full()`` equals
    ``jax.random.uniform(key, (k, n))``; ``rows_at`` evaluates the lattice
    directly at the requested (slot, column) points, without a gather."""

    def __init__(self, key: torch.Tensor, k: int, n: int):
        if k * n >= 2 ** 32:
            raise ValueError(f"a [{k}, {n}] block exceeds the uint32 lattice")
        self._key = key
        self._k = k
        self._n = n

    def full(self) -> torch.Tensor:
        return threefry(self._key, 0, self._k, self._n)

    def rows_at(self, lo: int, hi: int, cols: torch.Tensor) -> torch.Tensor:
        """``full()[lo:hi, cols]``; ``cols`` [m] int."""
        return threefry(self._key, lo, hi - lo, self._n, cols)


class KeyStream:
    """Threefry uniform stream over ``n_rays`` columns: each ``take`` /
    ``take_block`` consumes one counter, folded into the key."""

    def __init__(self, key: torch.Tensor, n_rays: int):
        self._key = key
        self._n = n_rays
        self._counter = 0

    def take_block(self, k: int) -> SlotBlock:
        """Reserve the next [k, n_rays] block without materialising it."""
        sub = fold_in(self._key, self._counter)
        self._counter += 1
        return SlotBlock(sub, k, self._n)

    def take(self, k: int) -> torch.Tensor:
        """[k, n_rays] uniforms in [0, 1)."""
        return self.take_block(k).full()


class _Block:
    """A materialized [k, n] uniform block with the SlotBlock API."""

    def __init__(self, u: torch.Tensor):
        self._u = u

    def full(self) -> torch.Tensor:
        return self._u

    def rows_at(self, lo: int, hi: int, cols: torch.Tensor) -> torch.Tensor:
        """``full()[lo:hi, cols]``."""
        return self._u[lo:hi][:, cols.long()]


class ArrayStream:
    """Slices a precomputed [N, D] uniform array by static offsets,
    yielding slot-major [k, N] blocks."""

    def __init__(self, uniforms: torch.Tensor):
        self._u = uniforms
        self._off = 0

    def take(self, k: int) -> torch.Tensor:
        u = self._u[:, self._off:self._off + k]
        self._off += k
        if u.shape[1] != k:
            raise ValueError(
                f"uniform array exhausted: need {k} slots at offset "
                f"{self._off - k}, have {self._u.shape[1]}")
        return u.T

    def take_block(self, k: int) -> _Block:
        return _Block(self.take(k))


def host_uniforms(seed: int, n_rays: int, n_slots: int) -> np.ndarray:
    """Host-side uniforms for parity runs (numpy, same as the JAX
    package's ``host_uniforms``)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n_rays, n_slots)).astype(np.float32)
