"""Small-table gathers into the component-first layout (counterpart of
``srt_tpu/ops/gather.py``).

The JAX package unrolls small-table lookups into select chains because
row gathers are slow on the TPU; on the GPU a gather is one cheap kernel,
so the port indexes directly.  Indices outside ``[0, K)`` take row 0, as
the select chain does.
"""

from __future__ import annotations

import torch


def take_small_t(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Component-first gather: table [K, C], idx [N] -> [C, N]."""
    k = table.shape[0]
    safe = torch.where((idx >= 0) & (idx < k), idx, torch.zeros_like(idx))
    return table[safe.long()].T
