"""Edge-aware (silhouette) visibility gradients for mesh scenes
(counterpart of ``srt_tpu/models/edge_aware_mesh.py``).

Path-space gradients treat the hit/miss decision as fixed, so vertex
optimization stalls at silhouettes (the step lives in
``IntersectsTriangle``'s hit window, ray_intersects.glsl:61-96).  A mesh
silhouette is a set of edges: an edge is on the silhouette when its two
adjacent triangles face opposite ways with respect to the ray, or it is
a boundary edge.  Primary visibility is reparameterized with a one-pixel
coverage ramp:

* ``sdf`` = the distance from the ray to the nearest silhouette edge,
  differentiable in the shared vertex buffer ``positions``;
* ``cov`` = clip(sdf / footprint, 0, 1), the footprint one pixel at the
  hit distance;
* radiance = cov * hit-path radiance + (1 - cov) * background radiance,
  the background being the same ray traced again from beyond the winning
  model's box: "this pixel without the winning model".

Pixels whose hit triangle has no silhouette edge nearby get cov = 1 and
equal the plain renderer bit for bit.  ``search="ring"`` examines the hit
triangle and ``rings`` adjacency rings; ``search="global"`` takes every
edge of the winning model within an along-ray window (dense O(rays x
edges), for sub-pixel triangles).  Model frames are assumed rigid.

``method`` is the traversal: ``"walk"`` (the default, as in
``mesh.mesh_hit_fn``: the kernels on CUDA tensors, their plain versions
on CPU tensors; the JAX package's ``"pallas"``), ``"dense"`` or
``"bvh"`` (the primary winner then comes from the dense sweep, as in JAX,
and the bounces from the BVH stack walk).  The walk's winner distance is
the kernels' candidate t, outside the autograd graph (JAX's
``pallas_model_hit(refine=False)``); the dense sweep's t carries a
gradient into the footprint.
"""

from __future__ import annotations

import dataclasses

import torch

from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import edge_aware_shadow
from srt_tpu_torch.models.edge_aware import _primary
from srt_tpu_torch.models.mesh import (MISS, MeshScene, _dense_model_hit,
                                       mesh_hit_fn, transform_rays)
from srt_tpu_torch.models.pathtracer import (bounce_step, initial_carry,
                                             trace_wavefront)
from srt_tpu_torch.ops import rng, traversal, vec
from srt_tpu_torch.ops.safemath import absolute, clip, maximum
from srt_tpu_torch.ops.vec import bc
from srt_tpu_torch.scene import Lights

BIG = edge_aware_shadow.BIG


def _primary_winner(scene: MeshScene, origins, dirs, t_min, method: str):
    """Closest hit across models with the winning indices exposed:
    (hit [N] bool, t [N], tri_idx [N], model_idx [N])."""
    n = origins.shape[1]
    dev = origins.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_i = torch.full((n,), MISS, dtype=torch.int32, device=dev)
    best_b = torch.zeros((n,), dtype=torch.int32, device=dev)
    for b in range(scene.num_models):
        if method == "walk":
            t, i, _, _ = traversal.model_hit(scene, b, origins, dirs, best_t,
                                             refine=False)
        elif method in ("dense", "bvh"):
            # The BVH route's winner is the dense one, as in JAX
            # (srt_tpu/models/edge_aware_mesh.py:81-83).
            t, i, _, _ = _dense_model_hit(scene, b, origins, dirs, best_t)
        else:
            raise ValueError(f"unknown traversal method: {method}")
        better = (i != MISS) & (t < best_t) & (t > t_min)
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, i, best_i)
        best_b = torch.where(better, torch.full_like(best_b, b), best_b)
    return best_i != MISS, best_t, torch.clamp_min(best_i, 0), best_b


def _tri_normal(scene: MeshScene, tri, pos):
    """Corners and geometric normal (unnormalized) of triangles ``tri``
    [N] from the shared vertex buffer, each [3, N]."""
    vidx = scene.tri_vidx[tri.long()].long()
    a = pos[vidx[:, 0]].T
    b = pos[vidx[:, 1]].T
    c = pos[vidx[:, 2]].T
    return a, b, c, vec.cross(b - a, c - a)


def _tri_silhouette_dist(scene: MeshScene, tri, o_m, d_m, valid):
    """Min ray-to-silhouette-edge-line distance over one candidate
    triangle's 3 edges per ray ([N]; BIG where no edge is a silhouette or
    ``valid`` is False)."""
    pos = scene.positions
    a, b, c, n_hit = _tri_normal(scene, tri, pos)
    f_hit = (n_hit * d_m).sum(0)
    adj = scene.tri_adj[tri.long()]                  # [N, 3]
    big = torch.full(tri.shape, BIG, device=tri.device)
    sdf = big
    corners = (a, b, c)
    for k in range(3):
        p0 = corners[k]
        p1 = corners[(k + 1) % 3]
        adj_k = adj[:, k]
        _, _, _, n_adj = _tri_normal(scene, torch.clamp_min(adj_k, 0), pos)
        f_adj = (n_adj * d_m).sum(0)
        # Silhouette: a boundary edge, or the neighbour faces the other way.
        sil = valid & ((adj_k < 0) | (f_hit * f_adj <= 0.0))
        # Ray-to-edge-line distance: m = e x d, dist = |m . (p0 - o)| / |m|.
        m = vec.cross(p1 - p0, d_m)
        m2 = (m * m).sum(0)
        ok = m2 > 1e-20
        inv = torch.rsqrt(torch.where(ok, m2, torch.ones_like(m2)))
        dist = absolute((m * (p0 - o_m)).sum(0)) * inv
        dist = torch.where(ok, dist, big)    # an edge parallel to the ray
        sdf = torch.minimum(sdf, torch.where(sil, dist, big))
    return sdf


def silhouette_sdf(scene: MeshScene, tri_idx, o_m, d_m, rings: int = 0):
    """Distance from the model-space rays (o_m, d_m [3, N]) to the nearest
    silhouette edge within ``rings`` adjacency rings of the hit triangles
    ``tri_idx`` [N] (0: the hit triangle's own 3 edges; candidates grow
    3^rings, no dedup).  BIG where no candidate edge is a silhouette."""
    valid0 = torch.ones(tri_idx.shape, dtype=torch.bool,
                        device=tri_idx.device)
    cands = [(tri_idx, valid0)]
    frontier = [(tri_idx, valid0)]
    for _ in range(rings):
        nxt = []
        for t, v in frontier:
            adj = scene.tri_adj[t.long()]            # [N, 3]
            for k in range(3):
                nxt.append((torch.clamp_min(adj[:, k], 0),
                            v & (adj[:, k] >= 0)))
        frontier = nxt
        cands += nxt
    sdf = torch.full(tri_idx.shape, BIG, device=tri_idx.device)
    for t, v in cands:
        sdf = torch.minimum(sdf, _tri_silhouette_dist(scene, t, o_m, d_m, v))
    return sdf


def silhouette_sdf_global(scene: MeshScene, b: int, o_m, d_m, t_hit,
                          window):
    """The exact nearest-silhouette-edge distance over all of model
    ``b``'s edges (deduplicated, tested as segments), restricted to
    closest approaches within ``window`` [N] of the hit distance ``t_hit``
    [N] along the unit model-space rays (o_m, d_m [3, N]).  Dense
    O(rays x edges); differentiable w.r.t. ``scene.positions``."""
    edges = edge_aware_shadow.device_edges(scene, b)
    e_i0, e_i1, _, _ = edges
    pos = scene.positions
    d_t = d_m.T
    sil = edge_aware_shadow.silhouette_mask(scene, d_t, edges)
    dist, t_c = edge_aware_shadow.edge_segment_dist(o_m.T, d_t, pos[e_i0],
                                                    pos[e_i1])
    near = (t_c - t_hit[:, None]).abs() <= window[:, None]
    return torch.where(sil & near, dist, torch.full_like(dist, BIG)).amin(1)


def _model_exit_t(scene: MeshScene, b: int, o_m, d_m):
    """Far parameter of the rays (o_m, d_m [3, N]) through model ``b``'s
    box; 0 where they miss it.  The box comes from the live per-corner
    arrays ``tri_v0/v1/v2`` (``with_positions`` re-gathers them), not the
    uploaded BVH bounds: a continuation placed past a stale box could
    start inside the displaced model and hit it again."""
    lo_t = scene.model_first_tri[b]
    hi_t = lo_t + scene.model_tri_count[b]
    vs = torch.cat([scene.tri_v0[lo_t:hi_t], scene.tri_v1[lo_t:hi_t],
                    scene.tri_v2[lo_t:hi_t]], dim=0)
    lo = vs.amin(0)[:, None]
    hi = vs.amax(0)[:, None]
    inv = 1.0 / d_m
    t0 = (lo - o_m) * inv
    t1 = (hi - o_m) * inv
    t_near = torch.minimum(t0, t1).amax(0)
    t_far = torch.maximum(t0, t1).amin(0)
    hit = (t_near <= t_far) & (t_far >= 0.0)
    return torch.where(hit, t_far, torch.zeros_like(t_far))


def _winner_coverage(scene: MeshScene, origins, dirs, t_hit, tri_idx,
                     model_idx, fp, search: str, rings: int):
    """Per ray, the winning model's silhouette distance (``search``) and
    box exit parameter, where-chained over the models."""
    n = origins.shape[1]
    sdf = torch.full((n,), BIG, device=origins.device)
    t_exit = torch.zeros((n,), device=origins.device)
    for b in range(scene.num_models):
        o_m, d_m = transform_rays(scene.frames[b], origins, dirs)
        if search == "global":
            dlen = torch.sqrt(maximum(vec.norm2(d_m), 1e-20))
            sdf_b = silhouette_sdf_global(scene, b, o_m, d_m / dlen[None, :],
                                          t_hit * dlen,
                                          window=8.0 * fp + 1e-3)
        elif search == "ring":
            sdf_b = silhouette_sdf(scene, tri_idx, o_m, d_m, rings=rings)
        else:
            raise ValueError(f"unknown silhouette search: {search}")
        ex_b = _model_exit_t(scene, b, o_m, d_m)
        sel = model_idx == b
        sdf = torch.where(sel, sdf_b, sdf)
        t_exit = torch.where(sel, ex_b, t_exit)
    return sdf, t_exit


def _check_adjacency(scene: MeshScene):
    if scene.tri_adj is None:
        raise ValueError("scene has no tri_adj: flatten it with "
                         "utils/flatten.flatten_models")


def trace_edge_aware_mesh(scene: MeshScene, lights: Lights,
                          cam: CameraConfig, cfg: RenderConfig, stream,
                          band: float = 1.0, method: str = "walk",
                          search: str = "ring", rings: int = 1,
                          soft_shadow_band: float = 0.0):
    """One image sample with reparameterized primary mesh visibility:
    linear radiance [H, W, 3] on the stream's device.

    ``band`` is the coverage ramp width in pixels at the hit distance;
    ``search`` / ``rings`` pick the silhouette-edge search (module
    docstring); ``soft_shadow_band`` > 0 also reparameterizes shadow
    boundaries (``edge_aware_shadow.mesh_soft_shadow_fn``, a world-unit
    band).  Both traces take the same uniform block, so the image is a
    deterministic function of the stream."""
    _check_adjacency(scene)
    origins, dirs, u_block = _primary(cam, cfg, stream, lights.count)
    shadow = (edge_aware_shadow.mesh_soft_shadow_fn(scene, soft_shadow_band)
              if soft_shadow_band > 0.0 else None)
    hit_fn = mesh_hit_fn(scene, method=method)
    color_main = trace_wavefront(hit_fn, lights, origins, dirs,
                                 rng.ArrayStream(u_block.T), cfg,
                                 shadow_fn=shadow)

    p_hit, t_hit, tri_idx, model_idx = _primary_winner(
        scene, origins, dirs, cfg.t_min, method)
    # One pixel's world footprint at the hit distance (the "reference"
    # viewport: 1 x 1 at focus_dist).
    fp = band * maximum(t_hit, 1e-3) / (cam.focus_dist
                                        * min(cam.width, cam.height))
    sdf, t_exit = _winner_coverage(scene, origins, dirs, t_hit, tri_idx,
                                   model_idx, fp, search, rings)
    cov = clip(sdf / fp, 0.0, 1.0)

    # The background: the same ray from beyond the winning model's box.
    d_hat = vec.normalize(dirs)
    o_bg = origins + bc(torch.where(p_hit, t_exit + cfg.t_min,
                                    torch.zeros_like(t_exit))) * d_hat
    color_bg = trace_wavefront(hit_fn, lights, o_bg, dirs,
                               rng.ArrayStream(u_block.T), cfg,
                               shadow_fn=shadow)

    blend = torch.where(p_hit, cov, torch.ones_like(cov))
    radiance = bc(blend) * color_main + bc(1.0 - blend) * color_bg
    return radiance.T.reshape(cam.height, cam.width, 3)


def trace_edge_aware_mesh_reflection(scene: MeshScene, lights: Lights,
                                     cam: CameraConfig, cfg: RenderConfig,
                                     stream, band: float = 1.0,
                                     method: str = "walk",
                                     search: str = "global", rings: int = 1,
                                     rough_thresh: float = 1e-2):
    """One image sample with reparameterized secondary (mirror-reflected)
    mesh visibility: [H, W, 3].

    Bounce 1 runs the integrator's own ``bounce_step`` (``return_aux``);
    pixels whose bounce-1 lobe was specular on a material of roughness at
    most ``rough_thresh`` get the reflected winner's silhouette replaced
    by a coverage ramp at the reflected footprint (one pixel at the
    camera -> mirror -> object distance): the rest of the depth is traced
    twice from the bounce ray, as it is and continued past the reflected
    winning model's box, and blended.  Every other pixel equals the plain
    renderer; both continuations take the slots the scan would."""
    _check_adjacency(scene)
    n_bounces = cfg.max_depth + cfg.rr_bounces
    if n_bounces < 2:
        raise ValueError("reflected silhouettes need depth >= 2")
    origins, dirs, u_block = _primary(cam, cfg, stream, lights.count)
    d_slots = rng.bounce_slots(lights.count)
    hit_fn = mesh_hit_fn(scene, method=method)

    carry1, _, aux1 = bounce_step(
        hit_fn, lights, cfg, initial_carry(origins, dirs, cfg, False), 0,
        u_block[:d_slots], sort=False, return_aux=True)
    o2, d2, thr1, color1, alive1 = carry1[:5]
    mirror1 = aux1["take_spec"] & (aux1["rough"] <= rough_thresh)

    # The rest of the depth from the bounce ray: the same slots, and Russian
    # roulette at the same absolute depths.
    cfg_rest = dataclasses.replace(cfg, max_depth=cfg.max_depth - 1)
    rest = u_block[d_slots:]
    l2_hit = trace_wavefront(hit_fn, lights, o2, d2, rng.ArrayStream(rest.T),
                             cfg_rest)

    p_hit2, t_hit2, tri2, model2 = _primary_winner(scene, o2, d2, cfg.t_min,
                                                   method)
    fp = band * maximum(aux1["t"] + t_hit2, 1e-3) / (
        cam.focus_dist * min(cam.width, cam.height))
    sdf, t_exit = _winner_coverage(scene, o2, d2, t_hit2, tri2, model2, fp,
                                   search, rings)
    cov2 = clip(sdf / fp, 0.0, 1.0)

    d2_hat = vec.normalize(d2)
    o2_bg = o2 + bc(torch.where(p_hit2, t_exit + cfg.t_min,
                                torch.zeros_like(t_exit))) * d2_hat
    l2_bg = trace_wavefront(hit_fn, lights, o2_bg, d2,
                            rng.ArrayStream(rest.T), cfg_rest)

    blend = torch.where(mirror1 & alive1 & p_hit2, cov2,
                        torch.ones_like(cov2))
    l2 = bc(blend) * l2_hit + bc(1.0 - blend) * l2_bg
    radiance = color1 + torch.where(bc(alive1), thr1 * l2,
                                    torch.zeros_like(l2))
    return radiance.T.reshape(cam.height, cam.width, 3)


def render_edge_aware_mesh(scene: MeshScene, lights: Lights,
                           cam: CameraConfig, cfg: RenderConfig,
                           key: torch.Tensor, band: float = 1.0,
                           method: str = "walk", search: str = "ring",
                           rings: int = 1) -> torch.Tensor:
    """``cfg.spp`` edge-aware samples, the mean image [H, W, 3]; sample s
    draws from ``KeyStream(fold_in(key, s), H * W)`` (``pathtracer.render``
    semantics)."""
    n = cam.height * cam.width
    samples = [trace_edge_aware_mesh(
        scene, lights, cam, cfg, rng.KeyStream(rng.fold_in(key, s), n),
        band=band, method=method, search=search, rings=rings)
        for s in range(cfg.spp)]
    return samples[0] if cfg.spp == 1 else torch.stack(samples).mean(0)
