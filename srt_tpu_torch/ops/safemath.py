"""Masked-lane math helpers (counterpart of ``srt_tpu/ops/safemath.py``):
degenerate lanes see a guard value inside the op and a defined value out,
so no NaN or inf leaks through a ``where``."""

from __future__ import annotations

import torch


def safe_sqrt(x, guard=1.0):
    """sqrt that returns 0 where ``x <= 0``."""
    ok = x > 0.0
    inner = torch.sqrt(torch.where(ok, x, torch.full_like(x, guard)))
    return torch.where(ok, inner, torch.zeros_like(x))
