"""Small-table gathers into the component-first layout (counterpart of
``srt_tpu/ops/gather.py``), and the row gather with a hand-written
backward.

The JAX package unrolls small-table lookups into select chains because
row gathers are slow on the TPU; on the GPU a gather is one cheap kernel,
so the port indexes directly.  Indices outside ``[0, K)`` take row 0, as
the select chain does.

``gather_rows`` is ``table[idx]`` for the mesh's record and table lookups.
Its backward is a sum by row over duplicated indices, which PyTorch's
``index_put_`` walks one entry at a time per row: the path tracer sends
every missed ray to row 0, a million entries a bounce.  The gather is the
``GatherRows`` Function: autograd records its node only under grad mode
for a table that requires grad (otherwise the call is ``table[idx]`` with
no node).  Its backward sorts the indices and launches
``csrc/gather_bwd.cu`` on CUDA tensors (two launches,
``cuda_lib.launch_counts["gather_bwd"]`` and ``["gather_bwd_merge"]``), or
runs the plain version on CPU tensors.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from srt_tpu_torch.ops import cuda_lib
from srt_tpu_torch.utils.profiling import span

# Sorted entries a block of csrc/gather_bwd.cu (CHUNK there): the scratch
# holds two rows a chunk, and the kernel refuses a scratch of another size.
CHUNK = 2048


def take_small_t(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Component-first gather: table [K, C], idx [N] -> [C, N]."""
    k = table.shape[0]
    safe = torch.where((idx >= 0) & (idx < k), idx, torch.zeros_like(idx))
    return table[safe.long()].T


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                cf: bool = False) -> torch.Tensor:
    """``table[idx]``: table [K, C], integer idx [N] in ``[-K, K)`` ->
    [N, C], or with ``cf`` its transpose [C, N] (a view, the
    component-first layout), equal bit for bit to the plain indexing.
    Its backward is ``gather_rows_backward``."""
    return GatherRows.apply(table, idx, cf)


class GatherRows(torch.autograd.Function):
    """``table[idx]`` (``.T`` with ``cf``) whose backward is
    ``gather_rows_backward`` on the incoming gradient as it lies."""

    @staticmethod
    def forward(ctx, table, idx, cf):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        ctx.cf = cf
        out = table[idx.long()]
        return out.T if cf else out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        grad_cf = grad if ctx.cf else grad.T
        return gather_rows_backward(grad_cf, idx, ctx.rows), None, None


def gather_rows_backward(grad_cf: torch.Tensor, idx: torch.Tensor,
                         rows: int) -> torch.Tensor:
    """The gradient [rows, C] of ``table[idx]`` given the gradient of its
    component-first result, ``grad_cf`` [C, N] (any strides): the plain
    version on CPU tensors; on any other device a stable sort of the
    indices and ``csrc/gather_bwd.cu`` (raises where it cannot launch).
    Runs inside the ``srt.gather_bwd`` span."""
    with span("srt.gather_bwd"):
        if grad_cf.device.type == "cpu":
            return gather_rows_backward_plain(grad_cf, idx, rows)
        return _gather_rows_backward_kernel(grad_cf, idx, rows)


def gather_rows_backward_plain(grad_cf: torch.Tensor, idx: torch.Tensor,
                               rows: int) -> torch.Tensor:
    """Plain version: ``index_put_`` with ``accumulate=True``, as the
    backward of ``table[idx]`` computes it."""
    return grad_cf.new_zeros((rows, grad_cf.shape[0])).index_put_(
        (idx.long(),), grad_cf.T, accumulate=True)


def _gather_rows_backward_kernel(grad_cf, idx, rows):
    cols, n = grad_cf.shape
    if grad_cf.dtype != torch.float32:
        raise TypeError(f"gather_bwd takes float32 gradients, got "
                        f"{grad_cf.dtype}")
    if n >= 2 ** 31 or rows >= 2 ** 31:
        raise ValueError(f"gather_bwd takes fewer than 2**31 entries and "
                         f"rows, got {n} and {rows}")
    out = torch.zeros((rows, cols), dtype=grad_cf.dtype,
                      device=grad_cf.device)
    if n == 0 or cols == 0:
        return out
    # Negative indices wrap as in the forward; int32 keys sort faster.
    keys, pos = torch.sort(torch.remainder(idx, rows).to(torch.int32),
                           stable=True)
    slots = 2 * -(-n // CHUNK)
    part = torch.empty((slots, cols), dtype=grad_cf.dtype,
                       device=grad_cf.device)
    part_row = torch.empty((slots,), dtype=torch.int32, device=keys.device)
    cuda_lib.launch("gather_bwd", keys, pos, grad_cf, grad_cf.stride(0),
                    grad_cf.stride(1), cols, n, slots, out, part, part_row)
    cuda_lib.launch("gather_bwd_merge", part_row, part, cols, slots, out)
    return out
