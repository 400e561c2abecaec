"""Shadow-boundary gradients for mesh occluders (counterpart of
``srt_tpu/models/edge_aware_shadow.py``).

The binary occlusion test (``CheckLightOccluded``,
raytrace_compute.glsl:167-176) gives occluder geometry seen only through
its shadow exactly zero path-space gradient.  ``mesh_soft_shadow_fn``
replaces it with a coverage ramp in the shadow segment's distance to the
occluder's silhouette:

* ``sdist`` = min over silhouette edges (with respect to the shadow
  direction: the two adjacent faces disagree in facing sign, or the edge
  is a boundary) of the ray-line to edge-segment distance, over closest
  approaches inside the clipped segment;
* ``pen`` = +sdist where the segment is occluded (binary any-hit),
  -sdist where it is lit: occlusion flips exactly where the segment
  crosses the silhouette, so ``pen`` is continuous through zero;
* ``mult`` = clip(0.5 - pen / band, 0, 1): deep shadow 0, fully lit 1,
  a ``band``-wide world-space ramp whose gradient is the boundary term.

The edge table (``model_edges``) and the segment distance
(``edge_segment_dist``) are shared with the global silhouette search of
``models/edge_aware_mesh.py``.  Cost: dense O(rays x edges) per model in
[N, E, 3] temporaries; ``ray_tile`` bounds the working set.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from srt_tpu_torch.models.mesh import MeshScene, transform_rays
from srt_tpu_torch.ops import vec
from srt_tpu_torch.ops.intersect import _cross_last
from srt_tpu_torch.ops.safemath import clip, maximum
from srt_tpu_torch.ops.vec import bc

BIG = 3.0e37


def model_edges(scene: MeshScene, b: int):
    """Deduplicated edge table of model ``b`` (owner = lower triangle id),
    built on the host from ``tri_adj`` / ``tri_vidx``: numpy int arrays
    (e_i0, e_i1 [E] vertex ids; e_ta, e_tb [E] adjacent triangle ids,
    e_tb = -1 on boundaries).  Static per topology."""
    adj_np = scene.tri_adj.cpu().numpy()
    vidx_np = scene.tri_vidx.cpu().numpy()
    lo = scene.model_first_tri[b]
    hi = lo + scene.model_tri_count[b]
    e_i0, e_i1, e_ta, e_tb = [], [], [], []
    for k in range(3):
        t_ids = np.arange(lo, hi)
        nbr = adj_np[lo:hi, k]
        own = (nbr < 0) | (nbr > t_ids)
        t_own = t_ids[own]
        e_i0.append(vidx_np[t_own, k])
        e_i1.append(vidx_np[t_own, (k + 1) % 3])
        e_ta.append(t_own)
        e_tb.append(nbr[own])
    cat = np.concatenate
    return cat(e_i0), cat(e_i1), cat(e_ta), cat(e_tb)


def device_edges(scene: MeshScene, b: int):
    """``model_edges`` as int64 tensors on the scene's device."""
    return tuple(torch.as_tensor(x.astype(np.int64), device=scene.device)
                 for x in model_edges(scene, b))


def _edge_normals(scene: MeshScene, e_ta, e_tb):
    """Unnormalized face normals [E, 3] of both triangles adjacent to each
    edge (e_tb < 0 reuses triangle 0; the boundary test ignores it)."""
    pos = scene.positions

    def nrm(t):
        vidx = scene.tri_vidx[t].long()
        a = pos[vidx[:, 0]]
        return _cross_last(pos[vidx[:, 1]] - a, pos[vidx[:, 2]] - a)

    return nrm(e_ta), nrm(torch.clamp_min(e_tb, 0))


def silhouette_mask(scene: MeshScene, d_t, edges):
    """[N, E] bool: edge e is a silhouette of the unit ray directions d_t
    [N, 3] (a boundary edge, or adjacent faces of opposite facing)."""
    _, _, e_ta, e_tb = edges
    n_a, n_b = _edge_normals(scene, e_ta, e_tb)
    f_a = d_t @ n_a.T                             # [N, E]
    f_b = d_t @ n_b.T
    return (e_tb[None, :] < 0) | (f_a * f_b <= 0.0)


def edge_segment_dist(o_t, d_t, p0, p1):
    """Ray lines (o_t, d_t [N, 3]) against edge segments (p0, p1 [E, 3]):
    (dist [N, E], the closest point's along-ray coordinate t_c [N, E]).
    |A + s B| minimized over s in [0, 1], A = (p0 - o) x d, B = e x d."""
    e_vec = p1 - p0
    w = p0[None, :, :] - o_t[:, None, :]          # [N, E, 3]
    a_v = _cross_last(w, d_t[:, None, :])
    b_v = _cross_last(e_vec[None, :, :], d_t[:, None, :])
    bb = (b_v * b_v).sum(2)
    ok = bb > 1e-20
    s = clip(-(a_v * b_v).sum(2) / torch.where(ok, bb, torch.ones_like(bb)),
             0.0, 1.0)
    s = torch.where(ok, s, torch.zeros_like(s))
    dvec = a_v + s[..., None] * b_v
    dist = torch.sqrt(maximum((dvec * dvec).sum(2), 1e-30))
    t_c = ((w + s[..., None] * e_vec[None, :, :]) * d_t[:, None, :]).sum(2)
    return dist, t_c


def _silhouette_edge_dist(scene: MeshScene, o_m, dn, t_lo, t_hi, edges):
    """Min distance from ray lines (o_m, unit dn [3, N]) to the silhouette
    edge segments of ``edges`` whose closest approach lies in
    (t_lo, t_hi) [N]; BIG where none.  Differentiable w.r.t.
    ``scene.positions``."""
    e_i0, e_i1, _, _ = edges
    pos = scene.positions
    d_t = dn.T
    sil = silhouette_mask(scene, d_t, edges)
    dist, t_c = edge_segment_dist(o_m.T, d_t, pos[e_i0], pos[e_i1])
    near = (t_c > t_lo[:, None]) & (t_c < t_hi[:, None])
    return torch.where(sil & near, dist, torch.full_like(dist, BIG)).amin(1)


def mesh_soft_shadow_fn(scene: MeshScene, band: float, ray_tile: int = 0):
    """A ``shadow_fn`` for ``pathtracer.bounce_step``: continuous light
    visibility with silhouette-distance ramps (module docstring).
    ``band`` is the ramp width in world units; ``ray_tile`` > 0 takes the
    shadow rays in chunks of that many to bound the [N, E] working set
    (the same result).  The edge tables are built once, here."""
    edges = [device_edges(scene, b) for b in range(scene.num_models)]

    def sdist_all(p, dn, t_min, dist):
        out = torch.full_like(dist, BIG)
        for b in range(scene.num_models):
            o_m, d_m = transform_rays(scene.frames[b], p, dn)
            out = torch.minimum(out, _silhouette_edge_dist(
                scene, o_m, d_m, torch.full_like(dist, t_min), dist,
                edges[b]))
        return out

    def fn(closest_hit, p, l_pos, t_min, active):
        delta = l_pos - p
        dist2 = vec.norm2(delta)
        dist = torch.sqrt(torch.where(dist2 > 0.0, dist2,
                                      torch.ones_like(dist2)))
        dn = delta / bc(maximum(dist, 1e-8))
        occ = closest_hit(p, dn, t_min, dist, any_hit=True).hit

        n = p.shape[1]
        if ray_tile and n > ray_tile:
            pad = (-n) % ray_tile
            p_p = F.pad(p, (0, pad))
            d_p = F.pad(dn, (0, pad), value=1.0)
            dist_p = F.pad(dist, (0, pad))
            sdist = torch.cat([
                sdist_all(p_p[:, a:a + ray_tile], d_p[:, a:a + ray_tile],
                          t_min, dist_p[a:a + ray_tile])
                for a in range(0, n + pad, ray_tile)])[:n]
        else:
            sdist = sdist_all(p, dn, t_min, dist)

        pen = torch.where(occ, sdist, -sdist)
        mult = clip(0.5 - pen / max(band, 1e-6), 0.0, 1.0)
        if active is not None:
            mult = torch.where(active, mult, torch.ones_like(mult))
        return mult

    return fn
