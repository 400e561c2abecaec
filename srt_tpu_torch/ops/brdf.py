"""GGX microfacet BRDF, batched over ray wavefronts (counterpart of
``srt_tpu/ops/brdf.py``): what ``pathtracer.bounce_step`` calls,
``eval_lobes_pdf`` (next-event estimation) among it, and the reference's
legacy sampler set (the ``legacy_*`` tail).

Cook-Torrance GGX with Smith height-correlated masking, Schlick Fresnel,
cosine-weighted diffuse + GGX half-vector sampling, RIS over point lights
and the lobe-selection probability (reference shaders/brdf.glsl and
raytrace_utils.glsl).  Vectors are ``[3, N]``, per-ray scalars ``[N]``;
each formula keeps the JAX package's operation order, and each bound by a
constant keeps its gradient at a tie (``ops/safemath.maximum``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from srt_tpu_torch.ops import vec
from srt_tpu_torch.ops.safemath import (absolute, clip, maximum, minimum,
                                      safe_sqrt)
from srt_tpu_torch.ops.vec import bc, dot
from srt_tpu_torch.scene import Lights, Materials

PI = 3.14159265358979323846
MIN_DIELECTRIC_F0 = 0.04


def saturate(x):
    return clip(x, 0.0, 1.0)


def luminance(rgb):
    """BT.709 relative luminance: [3, N] -> [N]."""
    return 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]


def specular_f0(base_color, metalness):
    m = bc(metalness)
    return (1.0 - m) * MIN_DIELECTRIC_F0 + m * base_color


def shadowed_f90(f0):
    return minimum((1.0 / MIN_DIELECTRIC_F0) * luminance(f0), 1.0)


def fresnel_schlick(f0, f90, n_dot_s):
    return f0 + (bc(f90) - f0) * torch.pow(1.0 - bc(n_dot_s), 5.0)


def ggx_ndf(n_dot_h, alpha_squared):
    b = (alpha_squared - 1.0) * n_dot_h * n_dot_h + 1.0
    return alpha_squared / maximum(PI * b * b, 0.001)


def smith_g_alpha(alpha, n_dot_s):
    return n_dot_s / (
        maximum(alpha, 1e-4)
        * torch.sqrt(1.0 - minimum(n_dot_s * n_dot_s, 0.99999))
    )


def smith_g_lambda_ggx(a):
    return (-1.0 + torch.sqrt(1.0 + 1.0 / maximum(a * a, 0.001))) * 0.5


def smith_g2_height_correlated(alpha, n_dot_l, n_dot_v):
    a_l = smith_g_alpha(alpha, n_dot_l)
    a_v = smith_g_alpha(alpha, n_dot_v)
    return 1.0 / (1.0 + smith_g_lambda_ggx(a_l) + smith_g_lambda_ggx(a_v))


def ggx_schlick_masking(n_dot_l, n_dot_v, roughness):
    k = roughness * roughness / 2.0
    g_v = n_dot_v / maximum(n_dot_v * (1.0 - k) + k, 0.001)
    g_l = n_dot_l / maximum(n_dot_l * (1.0 - k) + k, 0.001)
    return absolute(g_v * g_l)


def ggx_ndf_legacy(n_dot_h, roughness):
    a2 = roughness * roughness
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / maximum(d * d * PI, 0.001)


def schlick_fresnel_legacy(f0, u):
    return f0 + (1.0 - f0) * torch.pow(maximum(1.0 - bc(u), 0.001), 5.0)


def probability_to_sample_diffuse(diff_brdf, spec_brdf):
    """Luminance-ratio lobe probability (``probabilityToSampleDiffuse``,
    raytrace_utils.glsl:115-119; the reference's legacy sampler)."""
    lum_d = maximum(luminance(diff_brdf), 0.01)
    lum_s = maximum(luminance(spec_brdf), 0.01)
    return lum_d / (lum_d + lum_s)


def perpendicular_vector(u):
    """Branchless perpendicular basis vector (raytrace_utils.glsl:123-129)."""
    a = u.abs()
    xm = ((a[0] - a[1]) < 0) & ((a[0] - a[2]) < 0)
    xm = xm.to(u.dtype)
    ym = torch.where((a[1] - a[2]) < 0, 1.0 - xm, torch.zeros_like(xm))
    zm = (1.0 - xm) * (1.0 - ym)
    return vec.cross(u, torch.stack([xm, ym, zm]))


def reflect(incident, normal):
    return incident - 2.0 * bc(dot(normal, incident)) * normal


def sample_diffuse(normal, r1, r2):
    """Cosine-weighted hemisphere sample around ``normal``."""
    bitangent = perpendicular_vector(normal)
    tangent = vec.cross(bitangent, normal)
    r = safe_sqrt(r1.abs())
    phi = 2.0 * PI * r2
    return (
        tangent * bc(r * torch.cos(phi))
        + bitangent * bc(r * torch.sin(phi))
        + normal * bc(safe_sqrt((1.0 - r1).abs()))
    )


def sample_ggx_half_vector(normal, roughness, r1, r2):
    """GGX NDF half-vector sample (a2 = roughness^2, brdf.glsl:81-99)."""
    b = perpendicular_vector(normal)
    t = vec.cross(b, normal)
    a2 = roughness * roughness
    cos_th = safe_sqrt(maximum((1.0 - r1) / ((a2 - 1.0) * r1 + 1.0), 0.0))
    sin_th = safe_sqrt(maximum(1.0 - cos_th * cos_th, 0.0))
    phi = r2 * 2.0 * PI
    return (
        t * bc(sin_th * torch.cos(phi))
        + b * bc(sin_th * torch.sin(phi))
        + normal * bc(cos_th)
    )


def specular_sample_weight(alpha_squared, n_dot_s):
    s2 = n_dot_s * n_dot_s
    return 2.0 / (torch.sqrt((alpha_squared * (1.0 - s2) + s2) / s2) + 1.0)


class BrdfData(NamedTuple):
    n_dot_l: torch.Tensor
    n_dot_v: torch.Tensor
    l_dot_h: torch.Tensor
    n_dot_h: torch.Tensor
    v_dot_h: torch.Tensor
    specular_f0: torch.Tensor
    diffuse_reflectance: torch.Tensor
    roughness: torch.Tensor
    alpha: torch.Tensor
    alpha_squared: torch.Tensor
    fresnel: torch.Tensor


def brdf_data(normal, light_dir, view_dir, mat: Materials) -> BrdfData:
    """Vectorized ``GetAllBRDFValues`` (brdf.glsl:173-198)."""
    h = vec.normalize(light_dir + view_dir)
    n_dot_l = saturate(dot(normal, light_dir))
    n_dot_v = saturate(dot(normal, view_dir))
    l_dot_h = saturate(dot(light_dir, h))
    n_dot_h = saturate(dot(normal, h))
    v_dot_h = saturate(dot(view_dir, h))
    f0 = specular_f0(mat.albedo, mat.metalness)
    alpha = mat.roughness * mat.roughness
    return BrdfData(
        n_dot_l=n_dot_l, n_dot_v=n_dot_v, l_dot_h=l_dot_h, n_dot_h=n_dot_h,
        v_dot_h=v_dot_h, specular_f0=f0,
        diffuse_reflectance=mat.albedo * bc(1.0 - mat.metalness),
        roughness=mat.roughness, alpha=alpha, alpha_squared=alpha * alpha,
        fresnel=fresnel_schlick(f0, shadowed_f90(f0), l_dot_h),
    )


def eval_diffuse(data: BrdfData):
    return data.diffuse_reflectance * bc(data.n_dot_l / PI)


def eval_specular(data: BrdfData):
    d = ggx_ndf(data.n_dot_h, maximum(data.alpha_squared, 1e-5))
    g = smith_g2_height_correlated(data.alpha, data.n_dot_l, data.n_dot_v)
    denom = 4.0 * maximum(data.n_dot_l, 0.001) * maximum(data.n_dot_v, 0.001)
    scale = g * d / maximum(denom, 0.001) * data.n_dot_l
    return data.fresnel * bc(scale)


def light_falloff(p, light_pos):
    """Inverse-square falloff with near-field clamp (brdf.glsl:147-152)."""
    d = light_pos - p
    return 1.0 / (0.01 * 0.01 + dot(d, d))


def light_dir_to(p, light_pos):
    """Unit vector to the light (brdf.glsl:2-5)."""
    return vec.normalize(light_pos - p)


def sample_direct(p, normal, view_dir, mat: Materials, light_pos, light_color,
                  light_intensity, shadow_mult):
    """Legacy direct-light evaluator for ``useSpec`` materials
    (``SampleDirect``, brdf.glsl:200-224)."""
    l_dir = light_dir_to(p, light_pos)
    h = vec.normalize(view_dir + l_dir)
    n_dot_l = saturate(dot(normal, l_dir))
    n_dot_h = saturate(dot(normal, h))
    l_dot_h = saturate(dot(l_dir, h))
    n_dot_v = saturate(dot(normal, view_dir))
    d = ggx_ndf_legacy(n_dot_h, mat.roughness)
    g = ggx_schlick_masking(n_dot_l, n_dot_v, mat.roughness)
    f = schlick_fresnel_legacy(mat.specular, l_dot_h)
    falloff = light_falloff(p, light_pos)
    intensity = light_intensity * falloff
    ggx_term = f * bc(d * g / (4.0 * maximum(n_dot_v, 0.001)))
    light_term = bc(shadow_mult) * light_color * bc(intensity)
    return light_term * (ggx_term + bc(n_dot_l) * mat.albedo / PI)


def sample_direct_new(normal, light_dir, view_dir, mat: Materials):
    """Energy-conserving direct evaluator for non-``useSpec`` materials
    (``SampleDirectNew``, brdf.glsl:226-237)."""
    data = brdf_data(normal, light_dir, view_dir, mat)
    return (1.0 - data.fresnel) * eval_diffuse(data) + eval_specular(data)


def brdf_probability(mat: Materials, view_dir, normal):
    """Specular-lobe selection probability clamped to [0.1, 0.9]
    (``GetBrdfProbability``, brdf.glsl:279-288)."""
    spec_f0_lum = luminance(specular_f0(mat.albedo, mat.metalness))
    diff_lum = luminance(mat.albedo * bc(1.0 - mat.metalness))
    f0 = bc(spec_f0_lum).expand((3,) + spec_f0_lum.shape)
    fres = saturate(luminance(fresnel_schlick(
        f0, shadowed_f90(f0), maximum(dot(view_dir, normal), 0.0))))
    spec = fres
    diff = diff_lum * (1.0 - fres)
    p = spec / maximum(spec + diff, 1e-4)
    return clip(p, 0.1, 0.9)


def sample_specular_microfacet(p, normal, view_dir, mat: Materials, f0,
                               alpha, alpha_squared, h_r1, h_r2):
    """GGX importance sample + weight (``SampleSpecularMicrofacet``,
    brdf.glsl:102-132), with the perfect-mirror path at alpha == 0."""
    l_perfect = reflect(-view_dir, normal)
    h_perfect = vec.normalize(view_dir + l_perfect, fallback=normal)
    h_sampled = sample_ggx_half_vector(normal, mat.roughness, h_r1, h_r2)
    h = torch.where(bc(alpha == 0.0), h_perfect, h_sampled)

    l_dir = reflect(-view_dir, h)
    h_dot_l = clip(dot(h, l_dir), 1e-5, 1.0)
    n_dot_l = clip(dot(normal, l_dir), 1e-5, 1.0)
    f = fresnel_schlick(f0, shadowed_f90(f0), h_dot_l)
    weight = f * bc(specular_sample_weight(alpha_squared, n_dot_l))
    return l_dir, weight


def sample_indirect(p, normal, view_dir, mat: Materials, take_specular,
                    diff_r1, diff_r2, h_r1, h_r2):
    """Next-bounce direction + throughput weight (``SampleIndirectNew``,
    brdf.glsl:239-277).  Returns (direction, weight, valid)."""
    above = dot(normal, view_dir) > 0.0

    diff_dir = sample_diffuse(normal, diff_r1, diff_r2)
    data = brdf_data(normal, diff_dir, view_dir, mat)
    h = sample_ggx_half_vector(normal, mat.roughness, h_r1, h_r2)
    v_dot_h = clip(dot(view_dir, h), 1e-5, 1.0)
    diff_weight = data.diffuse_reflectance * (
        1.0 - fresnel_schlick(data.specular_f0,
                              shadowed_f90(data.specular_f0), v_dot_h))

    spec_dir, spec_weight = sample_specular_microfacet(
        p, normal, view_dir, mat, data.specular_f0, data.alpha,
        data.alpha_squared, h_r1, h_r2,
    )

    raw_dir = torch.where(bc(take_specular), spec_dir, diff_dir)
    weight = torch.where(bc(take_specular), spec_weight, diff_weight)

    direction = vec.normalize(raw_dir)
    valid = (
        above
        & (luminance(weight) != 0.0)
        & (dot(normal, direction) > 0.0)
    )
    return direction, weight, valid


def eval_lobes_pdf(normal, view_dir, direction, mat: Materials,
                   h_diffuse=None):
    """The integrand ``sample_indirect`` implies at an arbitrary
    ``direction`` and the density of its lobe mixture there, for
    next-event estimation and its balance-heuristic weights.  Returns
    ``(fcos [3, N], pdf_mix [N])``:

    * ``fcos``: per lobe, ``sample_indirect``'s weight times the lobe's
      pdf at ``direction``, summed over the lobes, so NEE and BSDF
      sampling estimate the same integral;
    * ``pdf_mix``: the solid-angle density of the lobe mixture chosen by
      ``brdf_probability``.

    ``h_diffuse`` is the GGX half-vector sample whose Fresnel the diffuse
    weight uses; pass the bounce's own draw for an exact match with
    ``sample_indirect``.  The roughness-0 specular lobe is a delta: its
    pdf and fcos are 0 here (the hit-side weight covers it with the
    ``_NO_MIS_PDF`` sentinel of ``models/pathtracer.bounce_step``)."""
    p_spec = brdf_probability(mat, view_dir, normal)
    n_dot_l = saturate(dot(normal, direction))
    pdf_diff = n_dot_l / PI

    h = vec.normalize(view_dir + direction, fallback=normal)
    n_dot_h = saturate(dot(normal, h))
    v_dot_h = clip(dot(view_dir, h), 1e-5, 1.0)
    # The sampler's NDF parameter is roughness^2 (BrdfData.alpha), not
    # alpha_squared.
    data = brdf_data(normal, direction, view_dir, mat)
    nd = ggx_ndf(n_dot_h, data.alpha)
    live_spec = data.alpha > 0.0
    pdf_spec = torch.where(live_spec, nd * n_dot_h / (4.0 * v_dot_h),
                           torch.zeros_like(nd))

    f0 = data.specular_f0
    h_dot_l = clip(dot(h, direction), 1e-5, 1.0)
    w_spec = fresnel_schlick(f0, shadowed_f90(f0), h_dot_l) * bc(
        specular_sample_weight(
            data.alpha_squared, clip(dot(normal, direction), 1e-5, 1.0)))
    if h_diffuse is None:
        h_diffuse = h
    vdh_d = clip(dot(view_dir, h_diffuse), 1e-5, 1.0)
    w_diff = data.diffuse_reflectance * (
        1.0 - fresnel_schlick(f0, shadowed_f90(f0), vdh_d))

    fcos = w_spec * bc(pdf_spec) + w_diff * bc(pdf_diff)
    pdf_mix = p_spec * pdf_spec + (1.0 - p_spec) * pdf_diff
    return fcos, pdf_mix


def sample_lights_ris(p, lights: Lights, u_idx, u_sel):
    """Resampled importance sampling over point lights (``SampleLights``,
    raytrace_compute.glsl:179-206), with the ``round(u * L)`` off-by-one
    fixed by floor + clamp.  Returns (selected [N] bool, light_idx [N]
    int32, weight [N])."""
    n = p.shape[1]
    num_lights = lights.count
    total = torch.zeros((n,), dtype=p.dtype, device=p.device)
    sel_idx = torch.zeros((n,), dtype=torch.int32, device=p.device)
    sel_pdf = torch.zeros((n,), dtype=p.dtype, device=p.device)
    selected = torch.zeros((n,), dtype=torch.bool, device=p.device)

    pdf_k = [
        lights.intensity[k] * light_falloff(p, lights.position[k][:, None])
        for k in range(num_lights)
    ]

    def pdf_at(cand):
        out = pdf_k[0]
        for k in range(1, num_lights):
            out = torch.where(cand == k, pdf_k[k], out)
        return out

    for i in range(num_lights):
        cand = torch.clamp(torch.floor(u_idx[i] * num_lights).to(torch.int32),
                           0, num_lights - 1)
        light_pdf = pdf_at(cand)
        ris_w = light_pdf * num_lights
        total = total + ris_w
        pos = total > 0.0
        ratio = ris_w / torch.where(pos, total, torch.ones_like(total))
        accept = u_sel[i] < torch.where(pos, ratio, torch.zeros_like(ratio))
        sel_idx = torch.where(accept, cand, sel_idx)
        sel_pdf = torch.where(accept, light_pdf, sel_pdf)
        selected = selected | accept

    weight = (total / num_lights) / maximum(sel_pdf, 0.001)
    return selected, sel_idx, weight


# ---------------------------------------------------------------------------
# Legacy sampler set (brdf.glsl:290-386): the reference's older,
# partly-used BRDF/PDF set beside the "New" path, kept for inventory
# parity with the JAX package: uniform draws are explicit arguments, and
# the half-vector is passed in where the reference draws a fresh random
# one inside an evaluator (SpecularPDF/SpecularBRDF, brdf.glsl:326/341).
# ---------------------------------------------------------------------------

def legacy_diffuse_pdf(normal, light_dir):
    """``DiffusePDF`` (brdf.glsl:320-322): cosine-hemisphere pdf."""
    return maximum(dot(normal, light_dir), 0.0) / PI


def legacy_specular_pdf(normal, half_vec, light_dir, roughness):
    """``SpecularPDF`` (brdf.glsl:324-334) with the half-vector passed in:
    the GGX NDF pdf moved to the light direction, D*NdotH / (4*LdotH)."""
    l_dot_h = saturate(dot(light_dir, half_vec))
    n_dot_h = saturate(dot(normal, half_vec))
    d = ggx_ndf_legacy(n_dot_h, roughness)
    return d * n_dot_h / maximum(4.0 * l_dot_h, 1e-4)


def legacy_diffuse_brdf(mat: Materials):
    """``DiffuseBRDF`` (brdf.glsl:336-338): albedo / pi."""
    return mat.albedo / PI


def legacy_specular_brdf(normal, view_dir, light_dir, mat: Materials):
    """``SpecularBRDF`` (brdf.glsl:340-358) with H = normalize(V + L):
    legacy D * Schlick-G * F / (4 NdotV NdotL)."""
    h = vec.normalize(view_dir + light_dir)
    n_dot_l = saturate(dot(normal, light_dir))
    n_dot_h = saturate(dot(normal, h))
    l_dot_h = saturate(dot(light_dir, h))
    n_dot_v = saturate(dot(normal, view_dir))
    d = ggx_ndf_legacy(n_dot_h, mat.roughness)
    g = ggx_schlick_masking(n_dot_l, n_dot_v, mat.roughness)
    f = schlick_fresnel_legacy(mat.specular, l_dot_h)
    denom = 4.0 * maximum(n_dot_v, 0.001) * maximum(n_dot_l, 0.001)
    return f * bc(d * g / maximum(denom, 0.001))


def legacy_brdf(normal, in_dir, out_dir, mat: Materials, is_diffuse):
    """``BRDF`` (brdf.glsl:360-386): per-lobe evaluator, cosine-weighted
    Lambertian for the diffuse lobe, D*G*F/(4 NdotV) for the specular
    lobe (the reference comments out the NdotL factor; matched)."""
    data = brdf_data(normal, out_dir, -in_dir, mat)
    d = ggx_ndf_legacy(data.n_dot_h, mat.roughness)
    g = ggx_schlick_masking(data.n_dot_l, data.n_dot_v, mat.roughness)
    f = schlick_fresnel_legacy(specular_f0(mat.albedo, mat.metalness),
                               data.l_dot_h)
    ggx_term = f * bc(d * g / maximum(4.0 * data.n_dot_v, 0.001))
    diffuse_term = mat.albedo * bc(data.n_dot_l / PI)
    return torch.where(bc(is_diffuse), diffuse_term, ggx_term)


def legacy_sample_next_ray(p, normal, in_dir, mat: Materials,
                           u_lobe, u1, u2):
    """``SampleNextRay`` (brdf.glsl:290-318): luminance-ratio lobe choice,
    cosine diffuse or GGX half-vector specular bounce, with the matching
    pdf.  Returns (direction [3, N], pdf [N], is_diffuse [N] bool);
    uniforms u_lobe, u1, u2 [N]."""
    diff_prob = probability_to_sample_diffuse(
        legacy_diffuse_brdf(mat),
        legacy_specular_brdf(normal, -in_dir, reflect(in_dir, normal), mat),
    )
    is_diffuse = u_lobe < diff_prob

    l_diff = sample_diffuse(normal, u1, u2)
    half = sample_ggx_half_vector(normal, mat.roughness, u1, u2)
    l_spec = reflect(in_dir, half)

    direction = torch.where(bc(is_diffuse), l_diff, l_spec)
    pdf_diff = legacy_diffuse_pdf(normal, l_diff)
    pdf_spec = legacy_specular_pdf(normal, half, l_spec, mat.roughness)
    pdf = torch.where(is_diffuse, pdf_diff, pdf_spec)
    return direction, pdf, is_diffuse
