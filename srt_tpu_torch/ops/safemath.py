"""Masked-lane math helpers (counterpart of ``srt_tpu/ops/safemath.py``):
degenerate lanes see a guard value inside the op and a defined value out,
so no NaN or inf leaks through a ``where``.

``maximum``, ``minimum`` and ``clip`` bound a tensor by a constant with
the JAX package's gradient at a tie: ``jnp.maximum``, ``jnp.minimum``
and ``jnp.clip`` split the gradient half and half where the tensor
equals the bound, while ``torch.clamp`` passes all of it.  ``absolute``
is ``jnp.abs``: its gradient at 0 is +1, where ``torch.abs`` gives 0.
Values are the same either way.  The bound is a 0-dim CPU tensor, which torch takes
as a scalar on any device (no copy to the card).
"""

from __future__ import annotations

import functools

import torch


def safe_sqrt(x, guard=1.0):
    """sqrt that returns 0 where ``x <= 0``."""
    ok = x > 0.0
    inner = torch.sqrt(torch.where(ok, x, torch.full_like(x, guard)))
    return torch.where(ok, inner, torch.zeros_like(x))


@functools.lru_cache(maxsize=None)
def _bound(c: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(c, dtype=dtype)


def maximum(x, c: float):
    """``jnp.maximum(x, c)`` for a constant ``c``: half the gradient at
    a tie."""
    return torch.maximum(x, _bound(c, x.dtype))


def minimum(x, c: float):
    """``jnp.minimum(x, c)`` for a constant ``c``: half the gradient at
    a tie."""
    return torch.minimum(x, _bound(c, x.dtype))


def clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``."""
    return minimum(maximum(x, lo), hi)


class _Absolute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return torch.where(x >= 0.0, grad, -grad)


def absolute(x):
    """``jnp.abs(x)``: |x| with the gradient +1 at x = 0 (and -0.0)."""
    return _Absolute.apply(x)
