"""Render-state validation and self-healing (counterpart of
``srt_tpu/utils/validate.py``).

The analog of the reference's runtime guards: ``ValidateRenderState``
recreates the quad pipeline when GL handles go bad (src/main.cpp:358-379)
and NaN pixels are painted green in-kernel (raytrace_compute.glsl:408-410).
What can still go wrong here is numeric: non-finite radiance leaking into
the accumulation buffer, and a camera basis that has lost its
orthogonality (camera.cpp:173-184).

``validate_render_state`` reads a frame and the accumulation buffer on
the host and returns a report; ``heal_accumulation`` zeroes the corrupted
accumulation texels on their own device, so one bad frame does not poison
progressive accumulation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class RenderStateReport:
    """One validation snapshot (counts are per call, host ints)."""

    nonfinite_frame: int      # non-finite texels in the incoming frame
    nonfinite_accum: int      # non-finite texels in the accumulation buffer
    negative_accum: int       # negative-radiance texels (sign corruption)
    camera_skew: float        # max |dot| between camera basis vectors
    ok: bool

    def __str__(self):
        state = "ok" if self.ok else "DEGRADED"
        return (f"render-state {state}: nonfinite "
                f"frame={self.nonfinite_frame} "
                f"accum={self.nonfinite_accum} neg={self.negative_accum} "
                f"camera-skew={self.camera_skew:.2e}")


def camera_skew(forward, up, right) -> float:
    """Max pairwise |dot| of the camera basis (0 for a healthy basis)."""
    f, u, r = (np.asarray(v, np.float64) for v in (forward, up, right))

    def nrm(v):
        return v / max(np.linalg.norm(v), 1e-12)

    f, u, r = nrm(f), nrm(u), nrm(r)
    return float(max(abs(f @ u), abs(f @ r), abs(u @ r)))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def validate_render_state(frame, accum, camera=None,
                          skew_tol: float = 1e-3) -> RenderStateReport:
    """Inspect one frame and the accumulation buffer (a host read)."""
    frame = _host(frame)
    accum = _host(accum)
    nf_frame = int((~np.isfinite(frame)).sum())
    nf_accum = int((~np.isfinite(accum)).sum())
    neg = int((accum < 0.0).sum())
    skew = 0.0
    if camera is not None:
        front, right, up = camera.basis()
        skew = camera_skew(front, up, right)
    return RenderStateReport(
        nonfinite_frame=nf_frame,
        nonfinite_accum=nf_accum,
        negative_accum=neg,
        camera_skew=skew,
        ok=(nf_frame == 0 and nf_accum == 0 and neg == 0
            and skew <= skew_tol),
    )


def heal_accumulation(accum: torch.Tensor):
    """Quarantine corrupted accumulation texels: non-finite or negative
    entries are zeroed (they re-converge from later frames).  Returns
    (healed tensor on ``accum``'s device, healed texel count)."""
    bad = ~torch.isfinite(accum) | (accum < 0.0)
    healed = torch.where(bad, torch.zeros_like(accum), accum)
    return healed, int(bad.sum())
