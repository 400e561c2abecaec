"""Uniform streams for path tracing (counterpart of ``srt_tpu/ops/rng.py``).

Streams yield slot-major ``[k, N]`` blocks.  The slot protocol is the JAX
package's: pixel jitter (2 slots) first, then per bounce
``[ris_idx x L | ris_sel x L | lobe | rr | diff_r1 | diff_r2 | h_r1 | h_r2]``
(``2*L + 6`` slots).

* ``ArrayStream`` slices an injected ``[N, D]`` uniform array: both
  packages consume the same array in the same slot order, which makes
  port-vs-JAX comparisons sample for sample.
* ``GeneratorStream`` draws blocks with ``torch.rand`` from an explicit
  ``torch.Generator``.  Its numbers differ from JAX's threefry
  ``KeyStream``; a bit-exact threefry stream is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def bounce_slots(n_lights: int, nee: bool = False) -> int:
    """Uniform slots consumed per bounce; ``nee`` appends 3 slots after
    the base block."""
    return 2 * n_lights + 6 + (3 if nee else 0)


def total_slots(n_lights: int, n_bounces: int, nee: bool = False) -> int:
    """Total slots per path: pixel jitter + all bounces."""
    return 2 + n_bounces * bounce_slots(n_lights, nee)


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


class GeneratorStream:
    """``torch.Generator``-backed uniform stream over ``n_rays`` columns.

    Each ``take``/``take_block`` draws one fresh ``[k, n_rays]`` block in
    [0, 1) on the generator's device."""

    def __init__(self, generator: torch.Generator, n_rays: int):
        self._g = generator
        self._n = n_rays

    def take(self, k: int) -> torch.Tensor:
        return torch.rand((k, self._n), generator=self._g,
                          device=self._g.device, dtype=torch.float32)

    def take_block(self, k: int) -> _Block:
        return _Block(self.take(k))


def host_uniforms(seed: int, n_rays: int, n_slots: int) -> np.ndarray:
    """Host-side uniforms for parity runs (numpy, same as the JAX
    package's ``host_uniforms``)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n_rays, n_slots)).astype(np.float32)
