"""The wavefront path tracer (counterpart of ``srt_tpu/models/pathtracer.py``).

The image is an ``[N]`` ray wavefront and each bounce is one batched pass:

  closest hit -> RIS light sample -> shadow ray -> direct lighting
  -> BRDF lobe selection -> Russian roulette -> indirect bounce

with an ``alive`` mask instead of ``break`` (reference ``GetRayColor``,
raytrace_compute.glsl:208-294).  Geometry sits behind a
``closest_hit(origins, dirs, t_min, t_max, any_hit=False) -> Hit``
callable: spheres (``spheres_hit_fn``), meshes (``models/mesh.py``) or
the nearest of several (``union_hit_fn``).  Vectors are ``[3, N]``.

Two drivers share ``bounce_step``, so they cannot drift apart: the scan
integrator here (``trace_wavefront`` under ``render``: every bounce at
the full width N, the JAX package's ``lax.scan`` as a Python loop) and the
width-compacted driver of ``models/wavefront_compact.py``.

Sort keys are built in int64 (torch has only partial uint32 support); they
order exactly like the JAX package's uint32 keys, and ``torch.argsort``
runs stable like ``jnp.argsort``.

With ``cfg.ray_cones`` the carry holds each ray's cone (width at its
origin, spread), which picks texture mips at the hit (``models/mesh.py``).
With ``cfg.nee`` and an ``emitters`` table (``models/emitters.py``) each
bounce also samples an emissive triangle and casts a shadow segment
toward it (next-event estimation), combined with BSDF sampling by the
one-sample balance heuristic; the carry then holds ``prev_pdf``, the
mixture pdf of the direction that led to the hit.

``shadow_fn`` replaces the binary shadow test with a continuous light
visibility multiplier (the edge-aware renderers' soft shadows,
``models/edge_aware.py``, ``models/edge_aware_shadow.py``);
``bounce_step(return_aux=True)`` also reports the bounce's lobe choice
and hit record (the edge-aware reflection traces).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import torch

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import emitters as emitters_mod
from srt_tpu_torch.ops import brdf, intersect, rng, vec
from srt_tpu_torch.ops.gather import take_small_t
from srt_tpu_torch.ops.morton import (PermutedStream, morton_perm,
                                      permute_rays, unpermute_image)
from srt_tpu_torch.ops.safemath import absolute, clip, maximum
from srt_tpu_torch.ops.vec import bc
from srt_tpu_torch.scene import Lights, Materials, Spheres
from srt_tpu_torch.utils.profiling import span

# MIS sentinel: "this direction was not density-sampled" (primary rays,
# delta-specular bounces).  Large against any real area pdf, and far
# from float32 overflow in prev_pdf + pdf_nee: the weight
# prev_pdf / (prev_pdf + pdf_nee) is then exactly 1.0.
_NO_MIS_PDF = 1e30


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


def _materials_t(mats: Materials, idx) -> Materials:
    """Table materials -> per-ray component-first materials."""
    return Materials(
        albedo=take_small_t(mats.albedo, idx),
        specular=take_small_t(mats.specular, idx),
        roughness=take_small_t(mats.roughness[:, None], idx)[0],
        metalness=take_small_t(mats.metalness[:, None], idx)[0],
        use_spec=take_small_t(mats.use_spec[:, None], idx)[0],
    )


def spheres_hit_fn(spheres: Spheres):
    """Closest-hit closure over a sphere scene (``CheckHit`` sphere loop,
    raytrace_compute.glsl:122-141)."""

    def closest_hit(origins, dirs, t_min, t_max, any_hit=False):
        hit, t, idx = intersect.sphere_hit(
            origins, dirs, spheres.center, spheres.radius, t_min, t_max)
        p = origins + bc(torch.where(hit, t, torch.ones_like(t))) * dirs
        if any_hit:
            # Occlusion only: no shading data.
            return Hit(hit=hit, t=t, p=p, normal=torch.zeros_like(p),
                       mat=_materials_t(spheres.materials,
                                        torch.zeros_like(idx)))
        center = take_small_t(spheres.center, idx)
        radius = take_small_t(spheres.radius[:, None], idx)[0]
        normal, _front = intersect.sphere_normal(p, center, radius, dirs)
        return Hit(hit=hit, t=t, p=p, normal=normal,
                   mat=_materials_t(spheres.materials, idx))

    return closest_hit


def _supports_kw(fn, name: str) -> bool:
    """True when ``fn`` accepts the keyword ``name`` (read from its
    signature, not by calling it and catching TypeError)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return name in sig.parameters or any(
        p.kind is inspect.Parameter.VAR_KEYWORD
        for p in sig.parameters.values())


def union_hit_fn(*hit_fns):
    """Combine closest-hit functions into one scene: the nearest hit wins
    (the reference switches spheres and models with ``showModel``,
    raytrace_compute.glsl:132-143; this takes both).  A hit fn without an
    ``any_hit`` or ``cone`` parameter is called without it.  Where one
    record carries ``emitted`` or ``tri`` and the other does not, the
    missing one counts as zeros and -1."""
    takes_any_hit = tuple(_supports_kw(fn, "any_hit") for fn in hit_fns)
    takes_cone = tuple(_supports_kw(fn, "cone") for fn in hit_fns)

    def closest_hit(origins, dirs, t_min, t_max, any_hit=False, cone=None):
        best = None
        for fn, supported, with_cone in zip(hit_fns, takes_any_hit,
                                            takes_cone):
            kw = {"any_hit": any_hit} if supported else {}
            if with_cone and cone is not None:
                kw["cone"] = cone
            rec = fn(origins, dirs, t_min, t_max, **kw)
            if best is None:
                best = rec
                continue
            closer = rec.hit & (~best.hit | (rec.t < best.t))

            def sel(a, b, m=closer):
                # Vectors are [3, N] (the mask broadcasts); scalars [N].
                return torch.where(m[None, :] if a.ndim > m.ndim else m, a, b)

            if rec.emitted is None and best.emitted is None:
                emitted = None
            else:
                e_new = rec.emitted if rec.emitted is not None \
                    else torch.zeros_like(best.emitted)
                e_old = best.emitted if best.emitted is not None \
                    else torch.zeros_like(rec.emitted)
                emitted = sel(e_new, e_old)
            if rec.tri is None and best.tri is None:
                tri = None
            else:
                miss = torch.full(best.hit.shape, -1, dtype=torch.int32,
                                  device=best.hit.device)
                tri = sel(rec.tri if rec.tri is not None else miss,
                          best.tri if best.tri is not None else miss)
            best = Hit(
                hit=best.hit | rec.hit,
                t=torch.where(closer, rec.t, best.t),
                p=sel(rec.p, best.p),
                normal=sel(rec.normal, best.normal),
                mat=Materials(**{
                    f.name: sel(getattr(rec.mat, f.name),
                                getattr(best.mat, f.name))
                    for f in dataclasses.fields(Materials)}),
                emitted=emitted,
                tri=tri,
            )
        return best

    return closest_hit


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
                bounce: int, u, sort: bool, shadow_fn=None,
                return_aux: bool = False, emitters=None):
    """One path-tracing bounce on a wavefront slice: the body of the scan
    integrator (``trace_wavefront``) and of the compact driver.

    ``carry`` = (origins, dirs, throughput, color, alive, pix), then
    (cone_width, cone_spread) when ``cfg.ray_cones``, then ``prev_pdf``
    when NEE is on (``emitters`` given and ``cfg.nee``), all in wavefront
    order; ``u`` [D, W] is this bounce's uniform block already in
    wavefront order (NEE reads 3 more slots, ``rng.bounce_slots``).
    ``sort`` re-sorts live rays first for the next bounce
    (``_bounce_sort_keys``).  Returns (carry', stats [2] int32 = (rays
    traced, shadow queries)).

    ``shadow_fn(closest_hit, p, l_pos, t_min, active) -> mult [N]``
    replaces the binary occlusion test toward the sampled point light
    with a continuous visibility multiplier, traced for every active hit
    (no masking, no sorted batch); None keeps the binary test.  The NEE
    segment keeps the binary test either way.  ``return_aux=True``
    (requires ``sort=False``) also returns ``{"take_spec", "rough",
    "hit", "t"}`` of this bounce, in the slice's input order."""
    with span("srt.shade"):
        nee_on = emitters is not None and cfg.nee
        origins, dirs, throughput, color, alive, pix = carry[:6]
        k = 6
        cone = None
        if cfg.ray_cones:
            cwidth, cspread = carry[k], carry[k + 1]
            cone = (cwidth, cspread)
            k += 2
        prev_pdf = carry[k] if nee_on else None
        num_lights = lights.count
        takes_cone = cone is not None and _supports_kw(closest_hit, "cone")
        inf = torch.full_like(alive, float("inf"), dtype=torch.float32)
        rec = closest_hit(origins, dirs, cfg.t_min,
                          torch.where(alive, inf, torch.zeros_like(inf)),
                          **({"cone": cone} if takes_cone else {}))
        active = alive & rec.hit

        # Emission: with NEE the hit-side credit carries the balance-heuristic
        # weight prev_pdf / (prev_pdf + pdf_nee(hit)); primaries and
        # delta-specular bounces arrive with the sentinel (weight 1.0), and
        # non-emitters have tri_pdfa = 0 (weight 1 exactly).
        if rec.emitted is not None:
            credit = throughput * rec.emitted
            if nee_on and rec.tri is not None:
                pdfa_hit = emitters.tri_pdfa[
                    torch.clamp_min(rec.tri, 0).long()]
                cos_hit = absolute((rec.normal * dirs).sum(0))
                # t guarded so no inf * 0 reaches an unselected where branch
                # (it would poison the backward).
                t_h = torch.where(active, rec.t, torch.ones_like(rec.t))
                pdf_nee_hit = pdfa_hit * t_h * t_h / maximum(cos_hit, 1e-6)
                credit = credit * bc(prev_pdf / (prev_pdf + pdf_nee_hit))
            color = color + _masked(bc(active), credit)

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

        if shadow_fn is None:
            # Shadow queries whose answer multiplies an exact zero (failed RIS
            # draw, light behind the shading normal) trace with t_max = 0.
            ndl_pos = (rec.normal
                       * brdf.light_dir_to(rec.p, l_pos)).sum(0) > 0.0
            shadow_active = active & sampled & ndl_pos
            if (cfg.sort_shadows_from is not None
                    and bounce >= cfg.sort_shadows_from):
                occ = _occluded_sorted(closest_hit, rec.p, l_pos, light_idx,
                                       cfg.t_min, shadow_active)
            else:
                occ = _occluded(closest_hit, rec.p, l_pos, cfg.t_min,
                                shadow_active)
            shadow_mult = torch.where(occ, 0.0, 1.0).to(torch.float32)
        else:
            shadow_mult = shadow_fn(closest_hit, rec.p, l_pos, cfg.t_min,
                                    active)

        direct_spec = brdf.sample_direct(
            rec.p, rec.normal, view, rec.mat, l_pos, l_col, l_int, shadow_mult
        ) * bc(light_w)
        if cfg.uniform_use_spec:
            direct = direct_spec
        else:
            l_dir = brdf.light_dir_to(rec.p, l_pos)
            falloff = brdf.light_falloff(rec.p, l_pos)
            light_term = l_col * bc(falloff * l_int * light_w)
            direct_diff = (brdf.sample_direct_new(rec.normal, l_dir, view,
                                                  rec.mat)
                           * bc(shadow_mult) * light_term)
            direct = torch.where(bc(rec.mat.use_spec), direct_spec,
                                 direct_diff)
        color = color + _masked(bc(active & sampled), throughput * direct)

        # --- NEE toward emissive triangles (no reference analog) ---
        u4 = u[2 * num_lights + 2:2 * num_lights + 6]
        if nee_on:
            u_nee = u[2 * num_lights + 6:2 * num_lights + 9]
            x_l, n_l, le_s, pdf_a = emitters_mod.sample_emitters(
                emitters, u_nee[0], u_nee[1], u_nee[2])
            delta_l = x_l - rec.p
            d2 = maximum(vec.norm2(delta_l), 1e-12)
            dist = torch.sqrt(d2)
            wi = delta_l / bc(dist)
            cos_l = absolute((n_l * wi).sum(0))              # two-sided Ke
            front = (rec.normal * wi).sum(0) > 0.0
            pdf_nee = pdf_a * d2 / maximum(cos_l, 1e-6)
            # The same GGX half-vector draw as sample_indirect below, so the
            # diffuse lobe's Fresnel matches the BSDF-side estimator.
            h_rand = brdf.sample_ggx_half_vector(
                rec.normal, rec.mat.roughness, u4[2], u4[3])
            fcos, pdf_mix_l = brdf.eval_lobes_pdf(
                rec.normal, view, wi, rec.mat, h_diffuse=h_rand)
            nee_active = active & front & (cos_l > 1e-6)
            # The segment is shrunk off the emitter so the sampled triangle
            # does not occlude its own sample (the JAX package's 0.999, a
            # reference fault the port keeps: ROADMAP.md queue C).
            occ_nee = _occluded(closest_hit, rec.p, rec.p + delta_l * 0.999,
                                cfg.t_min, nee_active)
            vis = nee_active & ~occ_nee
            # Balance heuristic folded:
            # w_nee / pdf_nee = 1 / (pdf_nee + pdf_mix).
            contrib = le_s * fcos * bc(
                1.0 / maximum(pdf_nee + pdf_mix_l, 1e-12))
            color = color + _masked(bc(vis), throughput * contrib)

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
        survival = clip(brdf.luminance(throughput), 0.1, 1.0)
        died = (active & (u_rr > survival) if in_rr
                else torch.zeros_like(active))
        if cfg.sky_always:
            color = color + _masked(bc(died), throughput * _sky(dirs, cfg))
        survived = active & ~died
        if in_rr:
            throughput = torch.where(bc(survived), throughput / bc(survival),
                                     throughput)
        active = survived

        # --- Indirect bounce (glsl:276-285) ---
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
        extra = ()
        if cone is not None:
            # Ray-cone update: the footprint grows along the segment, and the
            # spread widens by the sampled lobe (specular by roughness,
            # diffuse by a constant).
            t_seg = torch.where(rec.hit, rec.t, torch.zeros_like(rec.t))
            cwidth = torch.where(cont, cwidth + t_seg * cspread, cwidth)
            dspread = torch.where(
                take_spec, cfg.cone_spec_spread * rec.mat.roughness,
                torch.full_like(cspread, cfg.cone_diffuse_spread))
            cspread = torch.where(cont, cspread + dspread, cspread)
            extra = (cwidth, cspread)
        if nee_on:
            # The mixture pdf of the direction just sampled: the next bounce's
            # hit-side MIS weight.  Delta-specular choices carry the sentinel.
            _, pdf_next = brdf.eval_lobes_pdf(rec.normal, view, new_dir,
                                              rec.mat, h_diffuse=h_rand)
            delta_choice = take_spec & (rec.mat.roughness == 0.0)
            prev_pdf = torch.where(cont & ~delta_choice, pdf_next,
                                   torch.full_like(pdf_next, _NO_MIS_PDF))
            extra = extra + (prev_pdf,)

        # Accounting: rays entering the bounce + shadow queries issued for
        # active hits (a query resolved analytically above still counts),
        # NEE's segments included.
        shadow_queries = active.sum()
        if nee_on:
            shadow_queries = shadow_queries + nee_active.sum()
        stats = torch.stack([alive.sum(), shadow_queries]).to(torch.int32)
        out = (origins, dirs, throughput, color, cont, pix) + extra
        if return_aux:
            if sort:
                raise ValueError("return_aux reports pre-sort order; use "
                                 "sort=False")
            return out, stats, {"take_spec": take_spec,
                                "rough": rec.mat.roughness, "hit": rec.hit,
                                "t": rec.t}
        if sort:
            order = torch.argsort(
                _bounce_sort_keys(origins, dirs, cont, bounce), stable=True)
            out = tuple(x[..., order] for x in out)
        return out, stats


def initial_carry(origins, dirs, cfg: RenderConfig, nee_on: bool,
                  pix=None):
    """The bounce carry of fresh [3, N] rays: unit throughput, no colour,
    all alive, ``pix`` (default 0..N-1), then zero-width cones of
    ``cfg.primary_spread`` (``cfg.ray_cones``) and the no-MIS sentinel
    (``nee_on``: emitters seen directly keep full credit)."""
    n = origins.shape[1]
    dev = origins.device
    carry = (origins, dirs, torch.ones((3, n), device=dev),
             torch.zeros((3, n), device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev),
             torch.arange(n, device=dev) if pix is None else pix)
    if cfg.ray_cones:
        carry = carry + (torch.zeros((n,), device=dev),
                         torch.full((n,), cfg.primary_spread, device=dev))
    if nee_on:
        carry = carry + (torch.full((n,), _NO_MIS_PDF, device=dev),)
    return carry


def with_primary_spread(cfg: RenderConfig, cam: CameraConfig):
    """``cfg`` with ``primary_spread`` set, where ray cones are on and it
    is 0, to one pixel's footprint per unit t at the reference viewport
    (1x1 at ``focus_dist``)."""
    if cfg.ray_cones and cfg.primary_spread == 0.0:
        return dataclasses.replace(
            cfg, primary_spread=1.0 / (cam.focus_dist
                                       * min(cam.width, cam.height)))
    return cfg


def trace_wavefront(closest_hit, lights: Lights, origins, dirs, stream,
                    cfg: RenderConfig, return_stats: bool = False,
                    shadow_fn=None, emitters=None):
    """Trace a ``[3, N]`` ray batch to radiance ``[3, N]``: the JAX
    package's ``lax.scan`` over ``max_depth + rr_bounces`` bounces as a
    loop, every bounce at the full width N (dead rays trace with
    t_max = 0), then paths still alive end as a miss.

    ``stream`` (``KeyStream``, ``ArrayStream`` or ``PermutedStream``)
    gives every bounce's slots in one ``take(n_bounces * slots)``,
    reshaped to [B, D, N]; with ``cfg.sort_bounces`` each bounce's block
    is gathered by the rays' pixel ids, and the radiance is scattered back
    to pixel order at the end.  With ``return_stats`` also returns the
    per-bounce (rays traced, shadow queries) [B, 2] int32.

    ``shadow_fn`` goes to every bounce (``bounce_step``).  ``emitters``
    (``models/emitters.py``) with ``cfg.nee`` turns on next-event
    estimation: each bounce then takes 3 more slots."""
    n = origins.shape[1]
    dev = origins.device
    n_bounces = cfg.max_depth + cfg.rr_bounces
    nee_on = emitters is not None and cfg.nee
    d_slots = rng.bounce_slots(lights.count, nee_on)
    u_bounce = stream.take(n_bounces * d_slots).reshape(n_bounces, d_slots, n)
    # The JAX scan traces the bounce index, so its sorted shadow batches
    # (``isinstance(bounce, int)``) never run there; the loop here passes
    # ints, so the sort is switched off to trace the same batches.
    cfg = dataclasses.replace(cfg, sort_shadows_from=None)
    carry = initial_carry(origins, dirs, cfg, nee_on)
    stats = []
    for b in range(n_bounces):
        u = u_bounce[b]
        if cfg.sort_bounces:
            u = u[:, carry[5]]
        carry, st = bounce_step(closest_hit, lights, cfg, carry, b, u,
                                sort=cfg.sort_bounces, shadow_fn=shadow_fn,
                                emitters=emitters)
        stats.append(st)
    _, dirs, throughput, color, alive, pix = carry[:6]
    color = color + _masked(bc(alive), throughput * _sky(dirs, cfg))
    if cfg.sort_bounces:
        out = torch.zeros_like(color)
        out[:, pix] = color
        color = out
    if return_stats:
        return color, (torch.stack(stats) if stats else
                       torch.zeros((0, 2), dtype=torch.int32, device=dev))
    return color


def trace_image_sample(closest_hit, lights: Lights, cam: CameraConfig,
                       cfg: RenderConfig, stream, origin=None, look_at=None,
                       return_stats: bool = False):
    """One full-image sample: jittered primary rays (2 slots, then 2
    defocus slots when ``cam.defocus_angle > 0``) and ``trace_wavefront``,
    in Morton order when ``cfg.morton_order``.  Returns linear radiance
    [H, W, 3] (and the [B, 2] stats with ``return_stats``) on the
    stream's device.  With ``cfg.ray_cones`` and no ``primary_spread``,
    the spread is one pixel's footprint (``with_primary_spread``)."""
    cfg = with_primary_spread(cfg, cam)
    jitter = stream.take(2)
    defocus = stream.take(2) if cam.defocus_angle > 0 else None
    vp = derive_viewport(cam, origin=origin, look_at=look_at,
                         device=jitter.device)
    origins, dirs = generate_rays(vp, cam.width, cam.height, jitter, defocus)
    if cfg.morton_order:
        perm, inv = morton_perm(cam.height, cam.width)
        origins, dirs = permute_rays(origins, dirs, perm)
        out = trace_wavefront(closest_hit, lights, origins, dirs,
                              PermutedStream(stream, perm), cfg,
                              return_stats=True)
        radiance = unpermute_image(out[0], inv)
    else:
        out = trace_wavefront(closest_hit, lights, origins, dirs, stream,
                              cfg, return_stats=True)
        radiance = out[0]
    img = radiance.T.reshape(cam.height, cam.width, 3)
    return (img, out[1]) if return_stats else img


def render(closest_hit, lights: Lights, cam: CameraConfig,
           cfg: RenderConfig, key: torch.Tensor, origin=None,
           look_at=None) -> torch.Tensor:
    """Render ``cfg.spp`` samples; the linear mean image [H, W, 3].
    Sample s draws from ``KeyStream(fold_in(key, s), H * W)`` (``key``
    from ``ops/rng.key``: the numbers of the JAX package's
    ``render(jax.random.key(seed))``)."""
    n = cam.height * cam.width

    def one_sample(s):
        return trace_image_sample(
            closest_hit, lights, cam, cfg,
            rng.KeyStream(rng.fold_in(key, s), n), origin=origin,
            look_at=look_at)

    if cfg.spp == 1:
        return one_sample(0)
    return torch.stack([one_sample(s) for s in range(cfg.spp)]).mean(0)


def render_spheres(spheres: Spheres, lights: Lights, cam: CameraConfig,
                   cfg: RenderConfig, key: torch.Tensor) -> torch.Tensor:
    """Render a sphere scene (the reference's SHOW_MODEL=0 configuration)."""
    return render(spheres_hit_fn(spheres), lights, cam, cfg, key)


def trace_with_uniforms(closest_hit, lights: Lights, cam: CameraConfig,
                        cfg: RenderConfig, uniforms: torch.Tensor):
    """One image sample driven by an injected ``[N, D]`` float32 uniform
    tensor (``ArrayStream``): the same slots as the JAX package's
    ``trace_with_uniforms`` and the numpy oracle; runs on the tensor's
    device."""
    return trace_image_sample(closest_hit, lights, cam, cfg,
                              rng.ArrayStream(uniforms))
