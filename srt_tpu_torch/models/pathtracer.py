"""The wavefront bounce step (counterpart of ``srt_tpu/models/pathtracer.py``).

The image is an ``[N]`` ray wavefront and each bounce is one batched pass:

  closest hit -> RIS light sample -> shadow ray -> direct lighting
  -> BRDF lobe selection -> Russian roulette -> indirect bounce

with an ``alive`` mask instead of ``break`` (reference ``GetRayColor``,
raytrace_compute.glsl:208-294).  Geometry sits behind a
``closest_hit(origins, dirs, t_min, t_max, any_hit=False) -> Hit``
callable.  Vectors are ``[3, N]``.

Sort keys are built in int64 (torch has only partial uint32 support); they
order exactly like the JAX package's uint32 keys, and ``torch.argsort``
runs stable like ``jnp.argsort``.

Not ported yet: next-event estimation toward emissive triangles, ray
cones, the ``shadow_fn`` hook and the ``lax.scan`` integrator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from srt_tpu_torch.config import RenderConfig
from srt_tpu_torch.ops import brdf, vec
from srt_tpu_torch.ops.gather import take_small_t
from srt_tpu_torch.ops.vec import bc
from srt_tpu_torch.scene import Lights, Materials


@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray hit record (reference ``HitRecord``).  Vectors [3, N],
    scalars [N]; ``mat`` fields per ray; ``emitted`` [3, N] radiance and
    ``tri`` [N] int32 winning triangle (-1 miss) on the mesh path."""

    hit: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    normal: torch.Tensor
    mat: Materials
    emitted: Optional[torch.Tensor] = None
    tri: Optional[torch.Tensor] = None


def _part1by2(x):  # spread 5 bits with 2-bit gaps
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _part1by1(x):  # spread 15 bits with 1-bit gaps
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _cells(x, lo: float, hi: float):
    """clip(x, lo, hi) truncated to int64 cells (NaN -> 0, like the
    float -> uint32 conversion of the JAX package)."""
    q = torch.clamp(x, lo, hi)
    return torch.where(torch.isnan(q), torch.zeros_like(q), q).to(torch.int64)


def _morton15(pts):
    """15-bit Morton cell code of [3, N] points within their own bounding
    box (5 bits per axis)."""
    lo = pts.amin(1, keepdim=True)
    hi = pts.amax(1, keepdim=True)
    q = _cells(((pts - lo) / torch.clamp_min(hi - lo, 1e-6)) * 31.0, 0.0, 31.0)
    return (_part1by2(q[0]) << 2) | (_part1by2(q[1]) << 1) | _part1by2(q[2])


def _bounce_sort_keys(origins, dirs, alive, bounce=None):
    """Coherence keys for re-sorting the wavefront between bounces: dead
    last, then (bounce 0 or None) origin Morton cell + ~30-degree
    direction cone, or (bounce >= 1) the 6-D interleave of direction and
    origin Morton codes."""
    morton = _morton15(origins)
    inv_len = torch.rsqrt(torch.clamp_min((dirs * dirs).sum(0), 1e-12))
    dirs_n = dirs * inv_len
    qd = _cells((dirs_n + 1.0) * 2.0, 0.0, 3.0)
    dm = (((qd[0] >> 1) << 5) | ((qd[1] >> 1) << 4) | ((qd[2] >> 1) << 3)
          | ((qd[0] & 1) << 2) | ((qd[1] & 1) << 1) | (qd[2] & 1))
    dead = (~alive).to(torch.int64)
    key_cell = (dead << 21) | (morton << 6) | dm
    if bounce is None or bounce < 1:
        return key_cell
    qd5 = _cells((dirs_n + 1.0) * 16.0, 0.0, 31.0)
    dm15 = ((_part1by2(qd5[0]) << 2) | (_part1by2(qd5[1]) << 1)
            | _part1by2(qd5[2]))
    return (dead << 30) | (_part1by1(dm15) << 1) | _part1by1(morton)


def _shadow_segments(p, light_pos, active):
    delta = light_pos - p
    dist2 = vec.norm2(delta)
    dist = torch.sqrt(torch.where(dist2 > 0.0, dist2, torch.ones_like(dist2)))
    dist = torch.where(active, dist, torch.zeros_like(dist))
    return vec.normalize(delta), dist


def _occluded(closest_hit, p, light_pos, t_min, active):
    """Shadow ray p -> light (``CheckLightOccluded``,
    raytrace_compute.glsl:167-176); inactive lanes trace with t_max = 0."""
    direction, dist = _shadow_segments(p, light_pos, active)
    return closest_hit(p, direction, t_min, dist, any_hit=True).hit


def _occluded_sorted(closest_hit, p, light_pos, light_idx, t_min, active):
    """``_occluded`` with the batch re-sorted by (dead last, picked light,
    origin Morton cell) so per-group walks see same-light segments from
    nearby origins; the answers return to wavefront order.  The light
    index is clipped to 4 bits in the key, as in the JAX package."""
    direction, dist = _shadow_segments(p, light_pos, active)
    key = (((~active).to(torch.int64) << 19)
           | (torch.clamp(light_idx, 0, 15).to(torch.int64) << 15)
           | _morton15(p))
    order = torch.argsort(key, stable=True)
    shadow = closest_hit(p[:, order], direction[:, order], t_min,
                         dist[order], any_hit=True)
    occ = torch.empty_like(shadow.hit)
    occ[order] = shadow.hit
    return occ


def _sky(dirs, cfg: RenderConfig):
    """Sky radiance: constant grey or the blue gradient; [3, N]/[3, 1]."""
    if not cfg.sky_gradient:
        return vec.col(cfg.sky_color, device=dirs.device)
    d = vec.normalize(dirs)
    a = 0.5 * (d[1] + 1.0)
    white = vec.col([1.0, 1.0, 1.0], device=dirs.device)
    blue = vec.col([0.5, 0.7, 1.0], device=dirs.device)
    return bc(1.0 - a) * white + bc(a) * blue


def _masked(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def bounce_step(closest_hit, lights: Lights, cfg: RenderConfig, carry,
                bounce: int, u, sort: bool, emitters=None):
    """One path-tracing bounce on a wavefront slice (the body of the
    compact driver).

    ``carry`` = (origins, dirs, throughput, color, alive, pix) in
    wavefront order; ``u`` [D, W] is this bounce's uniform block already
    in wavefront order.  ``sort`` re-sorts live rays first for the next
    bounce (``_bounce_sort_keys``).  Returns (carry', stats [2] int32 =
    (rays traced, shadow queries))."""
    if emitters is not None and cfg.nee:
        raise NotImplementedError("next-event estimation is not ported "
                                  "yet: ROADMAP.md queue A")
    if cfg.ray_cones:
        raise NotImplementedError("ray cones are not ported yet: "
                                  "ROADMAP.md queue A")
    origins, dirs, throughput, color, alive, pix = carry
    num_lights = lights.count
    inf = torch.full_like(alive, float("inf"), dtype=torch.float32)
    rec = closest_hit(origins, dirs, cfg.t_min,
                      torch.where(alive, inf, torch.zeros_like(inf)))
    active = alive & rec.hit

    if rec.emitted is not None:
        color = color + _masked(bc(active), throughput * rec.emitted)

    missed = alive & ~rec.hit
    color = color + _masked(bc(missed), throughput * _sky(dirs, cfg))

    view = vec.normalize(-dirs)

    # --- RIS light sampling + direct lighting (glsl:228-246) ---
    u_idx = u[0:num_lights]
    u_sel = u[num_lights:2 * num_lights]
    sampled, light_idx, light_w = brdf.sample_lights_ris(
        rec.p, lights, u_idx, u_sel)
    l_pos = take_small_t(lights.position, light_idx)
    l_col = take_small_t(lights.color, light_idx)
    l_int = take_small_t(lights.intensity[:, None], light_idx)[0]

    # Shadow queries whose answer multiplies an exact zero (failed RIS
    # draw, light behind the shading normal) trace with t_max = 0.
    ndl_pos = (rec.normal * brdf.light_dir_to(rec.p, l_pos)).sum(0) > 0.0
    shadow_active = active & sampled & ndl_pos
    if cfg.sort_shadows_from is not None and bounce >= cfg.sort_shadows_from:
        occ = _occluded_sorted(closest_hit, rec.p, l_pos, light_idx,
                               cfg.t_min, shadow_active)
    else:
        occ = _occluded(closest_hit, rec.p, l_pos, cfg.t_min, shadow_active)
    shadow_mult = torch.where(occ, 0.0, 1.0).to(torch.float32)

    direct_spec = brdf.sample_direct(
        rec.p, rec.normal, view, rec.mat, l_pos, l_col, l_int, shadow_mult
    ) * bc(light_w)
    if cfg.uniform_use_spec:
        direct = direct_spec
    else:
        l_dir = brdf.light_dir_to(rec.p, l_pos)
        falloff = brdf.light_falloff(rec.p, l_pos)
        light_term = l_col * bc(falloff * l_int * light_w)
        direct_diff = (brdf.sample_direct_new(rec.normal, l_dir, view, rec.mat)
                       * bc(shadow_mult) * light_term)
        direct = torch.where(bc(rec.mat.use_spec), direct_spec, direct_diff)
    color = color + _masked(bc(active & sampled), throughput * direct)

    # --- BRDF lobe selection (glsl:248-264) ---
    u_lobe = u[2 * num_lights]
    forced_spec = (rec.mat.metalness == 1.0) & (rec.mat.roughness == 0.0)
    prob = brdf.brdf_probability(rec.mat, view, rec.normal)
    chose_spec = u_lobe < prob
    take_spec = forced_spec | chose_spec
    lobe_scale = torch.where(
        forced_spec, torch.ones_like(prob),
        torch.where(chose_spec, 1.0 / prob, 1.0 / (1.0 - prob)))
    throughput = torch.where(bc(active), throughput * bc(lobe_scale),
                             throughput)

    # --- Russian roulette (glsl:266-274) once past max_depth ---
    u_rr = u[2 * num_lights + 1]
    in_rr = bounce >= cfg.max_depth
    survival = torch.clamp(brdf.luminance(throughput), 0.1, 1.0)
    died = active & (u_rr > survival) if in_rr else torch.zeros_like(active)
    if cfg.sky_always:
        color = color + _masked(bc(died), throughput * _sky(dirs, cfg))
    survived = active & ~died
    if in_rr:
        throughput = torch.where(bc(survived), throughput / bc(survival),
                                 throughput)
    active = survived

    # --- Indirect bounce (glsl:276-285) ---
    u4 = u[2 * num_lights + 2:2 * num_lights + 6]
    new_dir, weight, valid = brdf.sample_indirect(
        rec.p, rec.normal, view, rec.mat, take_spec,
        u4[0], u4[1], u4[2], u4[3])
    invalid = active & ~valid
    if cfg.sky_always:
        color = color + _masked(bc(invalid), throughput * _sky(dirs, cfg))
    cont = active & valid
    throughput = torch.where(bc(cont), throughput * weight, throughput)
    origins = torch.where(bc(cont), rec.p, origins)
    dirs = torch.where(bc(cont), new_dir, dirs)

    # Accounting: rays entering the bounce + shadow queries issued for
    # active hits (a query resolved analytically above still counts).
    stats = torch.stack([alive.sum(), active.sum()]).to(torch.int32)
    if sort:
        order = torch.argsort(_bounce_sort_keys(origins, dirs, cont, bounce),
                              stable=True)
        origins, dirs = origins[:, order], dirs[:, order]
        throughput, color = throughput[:, order], color[:, order]
        cont, pix = cont[order], pix[order]
    return (origins, dirs, throughput, color, cont, pix), stats
