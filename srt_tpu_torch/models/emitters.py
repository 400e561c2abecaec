"""Area-emitter tables and sampling for next-event estimation (counterpart
of ``srt_tpu/models/emitters.py``).

The reference parses ``Ke`` but never lights with it
(model_loader.cpp:240-273).  The hit record credits ``throughput * Ke``
when a path hits an emissive triangle; this module adds the matching
light-sampling strategy: a power-proportional triangle pick, a uniform
point on it and a shadow segment toward it, combined with BSDF sampling
by the one-sample balance heuristic in ``pathtracer.bounce_step``
(``cfg.nee``).

The build is split so gradients flow: ``emitter_indices`` reads the
uploaded scene on the host once (the emitter set is static, like the
model directory), and ``build_emitters`` is torch on the scene's device,
differentiable with respect to ``frames``, the vertices and
``mat_emissive``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from srt_tpu_torch.ops.safemath import maximum
from srt_tpu_torch.ops.vec import bc


class Emitters(NamedTuple):
    """Emitter tables of E emissive triangles, world space, on the
    scene's device."""

    v0: torch.Tensor        # [E, 3]
    e1: torch.Tensor        # [E, 3]
    e2: torch.Tensor        # [E, 3]
    normal: torch.Tensor    # [E, 3] unit geometric normal (two-sided use)
    area: torch.Tensor      # [E] world-space triangle area
    le: torch.Tensor        # [E, 3] emitted radiance (Ke)
    cdf: torch.Tensor       # [E] power-pick CDF
    pick: torch.Tensor      # [E] pick probability
    # Per GLOBAL triangle pick / area (0 for non-emitters): the hit-side
    # MIS weight gathers it at the hit index.
    tri_pdfa: torch.Tensor  # [T]


def emitter_indices(scene) -> Optional[np.ndarray]:
    """Global indices [E] int32 of the emissive real triangles of an
    uploaded scene (padding triangles excluded); None without emitters.
    Reads ``mat_emissive`` and ``tri_mat`` back to the host once."""
    ke = scene.mat_emissive.detach().cpu().numpy()
    tri_mat = scene.tri_mat.cpu().numpy()
    emissive_mat = (ke > 0.0).any(axis=1)
    valid = np.zeros(tri_mat.shape[0], bool)
    for first, count in zip(scene.model_first_tri, scene.model_tri_count):
        valid[first:first + count] = True
    idx = np.where(emissive_mat[tri_mat] & valid)[0]
    if idx.size == 0:
        return None
    return idx.astype(np.int32)


def build_emitters(scene, emit_idx: np.ndarray) -> Emitters:
    """Emitter tables for a static index set (``emitter_indices``), built
    on the scene's device; differentiable with respect to
    ``scene.frames``, the vertices and ``mat_emissive``."""
    emit_idx = np.asarray(emit_idx)
    e = emit_idx.shape[0]
    model_of = np.zeros(e, np.int32)
    for b, (first, count) in enumerate(
            zip(scene.model_first_tri, scene.model_padded_tri_count)):
        model_of[(emit_idx >= first) & (emit_idx < first + count)] = b
    dev = scene.device
    idx = torch.as_tensor(emit_idx, device=dev).long()
    v0m, v1m, v2m = scene.tri_v0[idx], scene.tri_v1[idx], scene.tri_v2[idx]

    def to_world(pts_m, b):
        # frames are world->model: x_m = R x_w + t, so x_w = R^-1 (x_m - t).
        fr = scene.frames[b]
        r_inv = torch.linalg.inv(fr[:3, :3])
        return (pts_m - fr[:3, 3][None, :]) @ r_inv.T

    v0 = v1 = v2 = None
    for b in range(scene.num_models):
        sel = torch.as_tensor(model_of == b, device=dev)[:, None]
        w0, w1, w2 = to_world(v0m, b), to_world(v1m, b), to_world(v2m, b)
        v0 = w0 if v0 is None else torch.where(sel, w0, v0)
        v1 = w1 if v1 is None else torch.where(sel, w1, v1)
        v2 = w2 if v2 is None else torch.where(sel, w2, v2)

    e1 = v1 - v0
    e2 = v2 - v0
    cr = torch.linalg.cross(e1, e2)
    cr_len = torch.sqrt(maximum((cr * cr).sum(1), 1e-20))
    area = 0.5 * cr_len
    normal = cr / cr_len[:, None]

    le = scene.mat_emissive[scene.tri_mat[idx].long()]          # [E, 3]
    power = maximum(le.sum(1), 1e-12) * area
    pick = power / power.sum()
    cdf = torch.cumsum(pick, 0)
    # Out of place, so the table stays differentiable.
    tri_pdfa = torch.zeros(scene.tri_v0.shape[0], dtype=torch.float32,
                           device=dev).index_put(
        (idx,), pick / maximum(area, 1e-12))
    return Emitters(v0=v0, e1=e1, e2=e2, normal=normal, area=area, le=le,
                    cdf=cdf, pick=pick, tri_pdfa=tri_pdfa)


def scene_emitters(scene) -> Optional[Emitters]:
    """``build_emitters(scene, emitter_indices(scene))``; None without
    emitters."""
    idx = emitter_indices(scene)
    if idx is None:
        return None
    return build_emitters(scene, idx)


def sample_emitters(em: Emitters, u_pick, u1, u2):
    """One area sample per ray: a power-proportional triangle pick (CDF
    inversion, ``searchsorted(side="right")``) and a uniform point (sqrt
    warp).  u_*: [N] uniforms.  Returns ``(x [3, N] world point, n [3, N]
    unit emitter normal, le [3, N], pdf_a [N] area pdf = pick / area)``."""
    e = em.cdf.shape[0]
    pick = torch.clamp(torch.searchsorted(em.cdf, u_pick.contiguous(),
                                          right=True), 0, e - 1)
    v0 = em.v0[pick].T
    e1 = em.e1[pick].T
    e2 = em.e2[pick].T
    su = torch.sqrt(maximum(u1, 0.0))
    b1 = 1.0 - su
    b2 = u2 * su
    x = v0 + bc(b1) * e1 + bc(b2) * e2
    n = em.normal[pick].T
    le = em.le[pick].T
    pdf_a = em.pick[pick] / maximum(em.area[pick], 1e-12)
    return x, n, le, pdf_a
