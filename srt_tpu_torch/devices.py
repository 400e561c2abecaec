"""The device a public entry point runs on.

The port runs on the card unless the caller asks for the CPU: entry points
that take a ``device`` default to ``None``, which resolves to the CUDA
device.  Without one the call raises; it never falls back to the CPU
quietly.  CPU callers (the tests, CPU rehearsals) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless "
                           "the caller passes device='cpu'")
    return torch.device("cuda")
