"""Edge-aware (silhouette) visibility gradients for sphere scenes
(counterpart of ``srt_tpu/models/edge_aware.py``).

Path-space gradients treat the hit/miss decision as fixed, so moving
geometry gets zero gradient from pixels where visibility flips (the step
functions of ``CheckHit`` / ``CheckLightOccluded``,
raytrace_compute.glsl:122-176).  ``trace_edge_aware`` replaces the hard
silhouette of the primary hit by a one-pixel analytic coverage ramp that
blends the hit path's radiance with the exact background radiance: the
same ray traced again from just beyond the winning sphere's far root
("this pixel without the winning sphere").  The image is then continuous
and differentiable in sphere centres and radii across silhouettes.

``soft_shadow_fn`` does the same for shadow boundaries (through
``bounce_step``'s ``shadow_fn`` hook), and ``trace_edge_aware_reflection``
for silhouettes seen in deterministic mirror reflections.  Silhouettes
behind rough or diffuse bounces stay path-space.  There is no kernel on
this route: ``ops/intersect.sphere_hit`` is plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models.pathtracer import (bounce_step, initial_carry,
                                             spheres_hit_fn, trace_wavefront)
from srt_tpu_torch.ops import intersect, rng, vec
from srt_tpu_torch.ops.gather import take_small_t
from srt_tpu_torch.ops.safemath import clip, maximum, safe_sqrt
from srt_tpu_torch.ops.vec import bc
from srt_tpu_torch.scene import Lights, Spheres


def _winner_silhouette(spheres: Spheres, origins, dirs, widx):
    """Per-ray silhouette data of the winning sphere ``widx`` [N]: (sdf =
    r - impact parameter, positive inside the silhouette; along = the
    distance to the closest approach; t_exit = the far root, where the
    continuation starts), each [N] and differentiable."""
    c = take_small_t(spheres.center, widx)                  # [3, N]
    r = take_small_t(spheres.radius[:, None], widx)[0]      # [N]
    d = vec.normalize(dirs)
    oc = c - origins
    along = (oc * d).sum(0)
    perp2 = maximum(vec.norm2(oc) - along * along, 0.0)
    sdf = r - safe_sqrt(perp2)
    half = safe_sqrt(maximum(r * r - perp2, 0.0))
    return sdf, along, along + half


def soft_shadow_fn(spheres: Spheres, band: float):
    """A ``shadow_fn`` for ``bounce_step``: the binary shadow test becomes
    a coverage ramp in the occluder's silhouette penetration, so shadow
    boundaries carry gradients w.r.t. occluder centres and radii.

    ``band`` is the ramp width in world units.  Per shadow segment the
    most-occluding sphere is the one with the largest penetration ``r -
    impact parameter`` among the spheres whose closest approach lies
    inside the segment; mult = clip(0.5 - pen / band, 0, 1): deep inside
    the silhouette 0, outside 1."""

    def fn(closest_hit, p, l_pos, t_min, active):
        delta = l_pos - p
        dist2 = vec.norm2(delta)
        dist = torch.sqrt(torch.where(dist2 > 0.0, dist2,
                                      torch.ones_like(dist2)))
        d = delta / bc(maximum(dist, 1e-8))
        oc = spheres.center.T[:, None, :] - p[:, :, None]   # [3, N, S]
        along = (oc * d[:, :, None]).sum(0)                  # [N, S]
        perp2 = maximum((oc * oc).sum(0) - along * along, 0.0)
        pen = spheres.radius[None, :] - safe_sqrt(perp2)
        in_seg = (along > t_min) & (along < dist[:, None])
        pen_best = torch.where(in_seg, pen,
                               torch.full_like(pen, -float("inf"))).amax(1)
        mult = clip(0.5 - pen_best / max(band, 1e-6), 0.0, 1.0)
        if active is not None:
            mult = torch.where(active, mult, torch.ones_like(mult))
        return mult

    return fn


def _primary(cam: CameraConfig, cfg: RenderConfig, stream, n_lights: int):
    """Jittered primary rays (2 slots) and the [B * D, N] uniform block of
    every bounce."""
    jitter = stream.take(2)
    vp = derive_viewport(cam, device=jitter.device)
    origins, dirs = generate_rays(vp, cam.width, cam.height, jitter)
    n_bounces = cfg.max_depth + cfg.rr_bounces
    return origins, dirs, stream.take(n_bounces * rng.bounce_slots(n_lights))


def trace_edge_aware(spheres: Spheres, lights: Lights, cam: CameraConfig,
                     cfg: RenderConfig, stream, band: float = 1.0,
                     soft_shadow_band: float = 0.0):
    """One image sample with reparameterized primary visibility: linear
    radiance [H, W, 3] on the stream's device.

    ``band`` is the coverage ramp width in pixels at the sphere's
    distance; ``soft_shadow_band`` > 0 also reparameterizes shadow
    boundaries (``soft_shadow_fn``, a world-unit ramp).  Both traces take
    the same uniform block, so the image is a deterministic function of
    the stream."""
    origins, dirs, u_block = _primary(cam, cfg, stream, lights.count)
    shadow = (soft_shadow_fn(spheres, soft_shadow_band)
              if soft_shadow_band > 0.0 else None)
    hit_fn = spheres_hit_fn(spheres)
    color_main = trace_wavefront(hit_fn, lights, origins, dirs,
                                 rng.ArrayStream(u_block.T), cfg,
                                 shadow_fn=shadow)

    p_hit, _, widx = intersect.sphere_hit(origins, dirs, spheres.center,
                                          spheres.radius, cfg.t_min,
                                          float("inf"))
    sdf, along, t_exit = _winner_silhouette(spheres, origins, dirs, widx)
    # One pixel's world footprint at the closest approach (the "reference"
    # viewport: 1 x 1 at focus_dist).
    fp = band * maximum(along, 1e-3) / (cam.focus_dist
                                        * min(cam.width, cam.height))
    cov = clip(sdf / fp, 0.0, 1.0)

    # The background: the same ray from beyond the winner's far root.
    d_hat = vec.normalize(dirs)
    o_bg = origins + bc(torch.where(p_hit, t_exit + cfg.t_min,
                                    torch.zeros_like(t_exit))) * d_hat
    color_bg = trace_wavefront(hit_fn, lights, o_bg, dirs,
                               rng.ArrayStream(u_block.T), cfg,
                               shadow_fn=shadow)

    blend = torch.where(p_hit, cov, torch.ones_like(cov))
    radiance = bc(blend) * color_main + bc(1.0 - blend) * color_bg
    return radiance.T.reshape(cam.height, cam.width, 3)


def trace_edge_aware_reflection(spheres: Spheres, lights: Lights,
                                cam: CameraConfig, cfg: RenderConfig,
                                stream, band: float = 1.0):
    """One image sample with reparameterized secondary (mirror-reflected)
    visibility: [H, W, 3].

    Bounce 1 runs the integrator's own ``bounce_step``; pixels whose
    primary hit is a mirror (metalness 1, roughness 0: the forced specular
    lobe) get the reflected winner's silhouette replaced by a coverage
    ramp at the reflected footprint (one pixel at the camera -> mirror ->
    object distance): the rest of the depth is traced twice from the
    bounce ray, as it is and continued past the reflected winner's far
    root, and blended.  Every other pixel equals the plain renderer."""
    n_bounces = cfg.max_depth + cfg.rr_bounces
    if n_bounces < 2:
        raise ValueError("reflected silhouettes need depth >= 2")
    origins, dirs, u_block = _primary(cam, cfg, stream, lights.count)
    d_slots = rng.bounce_slots(lights.count)
    hit_fn = spheres_hit_fn(spheres)

    carry1, _ = bounce_step(hit_fn, lights, cfg,
                            initial_carry(origins, dirs, cfg, False), 0,
                            u_block[:d_slots], sort=False)
    o2, d2, thr1, color1, alive1 = carry1[:5]

    # The rest of the depth from the bounce ray: the same slots, and Russian
    # roulette at the same absolute depths.
    cfg_rest = dataclasses.replace(cfg, max_depth=cfg.max_depth - 1)
    rest = u_block[d_slots:]
    l2_hit = trace_wavefront(hit_fn, lights, o2, d2, rng.ArrayStream(rest.T),
                             cfg_rest)

    p_hit1, t1, w1 = intersect.sphere_hit(origins, dirs, spheres.center,
                                          spheres.radius, cfg.t_min,
                                          float("inf"))
    metal1 = take_small_t(spheres.materials.metalness[:, None], w1)[0]
    rough1 = take_small_t(spheres.materials.roughness[:, None], w1)[0]
    mirror1 = p_hit1 & (metal1 == 1.0) & (rough1 == 0.0)

    hit2, _, w2 = intersect.sphere_hit(o2, d2, spheres.center,
                                       spheres.radius, cfg.t_min,
                                       float("inf"))
    sdf2, along2, t_exit2 = _winner_silhouette(spheres, o2, d2, w2)
    fp = band * maximum(t1 + along2, 1e-3) / (
        cam.focus_dist * min(cam.width, cam.height))
    cov2 = clip(sdf2 / fp, 0.0, 1.0)

    d2_hat = vec.normalize(d2)
    o2_bg = o2 + bc(torch.where(hit2, t_exit2 + cfg.t_min,
                                torch.zeros_like(t_exit2))) * d2_hat
    l2_bg = trace_wavefront(hit_fn, lights, o2_bg, d2,
                            rng.ArrayStream(rest.T), cfg_rest)

    blend = torch.where(mirror1 & alive1 & hit2, cov2, torch.ones_like(cov2))
    l2 = bc(blend) * l2_hit + bc(1.0 - blend) * l2_bg
    radiance = color1 + torch.where(bc(alive1), thr1 * l2,
                                    torch.zeros_like(l2))
    return radiance.T.reshape(cam.height, cam.width, 3)


def render_edge_aware(spheres: Spheres, lights: Lights, cam: CameraConfig,
                      cfg: RenderConfig, key: torch.Tensor,
                      band: float = 1.0) -> torch.Tensor:
    """``cfg.spp`` edge-aware samples, the mean image [H, W, 3]; sample s
    draws from ``KeyStream(fold_in(key, s), H * W)`` (``pathtracer.render``
    semantics)."""
    n = cam.height * cam.width
    samples = [trace_edge_aware(spheres, lights, cam, cfg,
                                rng.KeyStream(rng.fold_in(key, s), n),
                                band=band)
               for s in range(cfg.spp)]
    return samples[0] if cfg.spp == 1 else torch.stack(samples).mean(0)
