"""Tonemapping, accumulation and NaN diagnostics (counterpart of
``srt_tpu/ops/tonemap.py``).

The display path of the reference megakernel (raytrace_compute.glsl:
395-413): progressive accumulation into a float32 buffer, division by the
frame count, linear->sRGB conversion, and NaN pixels flagged bright
green.  Plain tensor functions, on the device of their inputs.
"""

from __future__ import annotations

import torch

from srt_tpu_torch.ops.safemath import clip, maximum

NAN_SENTINEL = (0.0, 1.0, 0.0)  # NaN pixels render green (glsl:408-410)


def linear_to_srgb(linear):
    """Piecewise sRGB transfer (``linearToSrgb``, raytrace_utils.glsl:
    177-184)."""
    lo = linear * 12.92
    hi = 1.055 * torch.pow(maximum(linear, 1e-12), 1.0 / 2.4) - 0.055
    return torch.where(linear < 0.0031308, lo, hi)


def flag_nans(color):
    """Replace NaN samples with the green sentinel, per pixel ([..., 3])."""
    bad = torch.isnan(color).any(-1, keepdim=True)
    return torch.where(bad, torch.tensor(NAN_SENTINEL, dtype=color.dtype,
                                         device=color.device), color)


def accumulate(accum, sample, frames_done: int):
    """One progressive-accumulation step.

    accum: [..., 3] running linear sum; sample: the new frame's linear
    color; frames_done: frames in ``accum`` before this one.  Returns
    (new_accum, display), display sRGB in [0, 1]
    (raytrace_compute.glsl:404-413)."""
    new_accum = accum + flag_nans(sample)
    display = clip(linear_to_srgb(new_accum / (frames_done + 1)), 0.0, 1.0)
    return new_accum, display


def resolve(accum, frames: int):
    """Final resolve of an accumulation buffer to sRGB."""
    return clip(linear_to_srgb(accum / max(frames, 1)), 0.0, 1.0)
