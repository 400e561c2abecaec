"""Independent numpy oracle renderer (counterpart of
``srt_tpu/models/reference_cpu.py``, carried over unchanged in behaviour).

The reference keeps a CPU software renderer as its correctness anchor
(src/raytracer/raytracer.cpp, off by default — SURVEY.md section 3.3).  This
module plays that role for the port: a from-scratch numpy implementation
of the same rendering *specification* (camera derivation, sphere
intersection, GGX BRDF, RIS lights, Russian roulette, masked bounce loop,
sky term) that shares **no code** with the PyTorch renderer (it imports
neither ``pathtracer``, ``brdf`` nor ``intersect``).  Both are driven with
the same injected ``[N, D]`` uniform array (``ops/rng.py`` slot protocol)
and their images compared; ``bench_suite`` config1 holds the renderer on
the card against it.  The port keeps its own copy because the card's
machine has no JAX.

Deliberately plain numpy, float64-friendly, clarity over speed.
"""

from __future__ import annotations

import numpy as np

PI = np.pi
F0_DIELECTRIC = 0.04


# --------------------------- small vector helpers ---------------------------

def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _norm(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1e-12)


def _lum(rgb):
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def _sat(x):
    return np.clip(x, 0.0, 1.0)


# ------------------------------- scene inputs -------------------------------

class OracleScene:
    """Plain-array scene container for the oracle.

    spheres: centers [S,3], radii [S]
    materials (per sphere): albedo [S,3], specular [S,3], rough [S],
    metal [S], use_spec [S] bool
    lights: lpos [L,3], lcol [L,3], lint [L]
    Optionally a triangle mesh: verts [V,3], tris [T,3] int, tri_mat fields.
    """

    def __init__(self, centers, radii, albedo, specular, rough, metal,
                 use_spec, lpos, lcol, lint):
        self.centers = np.asarray(centers, np.float32)
        self.radii = np.asarray(radii, np.float32)
        self.albedo = np.asarray(albedo, np.float32)
        self.specular = np.asarray(specular, np.float32)
        self.rough = np.asarray(rough, np.float32)
        self.metal = np.asarray(metal, np.float32)
        self.use_spec = np.asarray(use_spec, bool)
        self.lpos = np.asarray(lpos, np.float32)
        self.lcol = np.asarray(lcol, np.float32)
        self.lint = np.asarray(lint, np.float32)


# ------------------------------ camera + rays -------------------------------

def camera_rays(width, height, origin, look_at, v_up, focus_dist, jitter,
                viewport_mode="reference", vfov=90.0):
    """Primary rays matching srt_tpu_torch.camera.generate_rays row-major
    order."""
    origin = np.asarray(origin, np.float64)
    look_at = np.asarray(look_at, np.float64)
    v_up = np.asarray(v_up, np.float64)
    front = _norm(look_at - origin)
    right = _norm(np.cross(front, v_up))
    up = _norm(np.cross(right, front))
    w = -front
    if viewport_mode == "reference":
        view_u = right * focus_dist
        view_v = up * focus_dist
    else:
        h = np.tan(np.radians(vfov) / 2.0)
        vh = 2.0 * h * focus_dist
        vw = vh * (width / height)
        view_u = right * vw
        view_v = up * vh
    du = view_u / width
    dv = view_v / height
    lower_left = origin - focus_dist * w - view_u / 2 - view_v / 2
    p00 = lower_left + 0.5 * (du + dv)

    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    i = xs.reshape(-1).astype(np.float64)
    j = ys.reshape(-1).astype(np.float64)
    off = jitter.astype(np.float64) - 0.5
    px = p00[None] + (i + off[:, 0])[:, None] * du[None] + (j + off[:, 1])[:, None] * dv[None]
    o = np.broadcast_to(origin[None], px.shape).copy()
    return o.astype(np.float32), (px - o).astype(np.float32)


# ------------------------------- intersection -------------------------------

def closest_sphere_hit(sc: OracleScene, o, d, t_min, t_max):
    """[N] rays vs all spheres; returns dict with hit/t/p/normal/mat idx."""
    oc = sc.centers[None] - o[:, None]                      # [N,S,3]
    a = _dot(d, d)[:, None]
    h = np.einsum("nd,nsd->ns", d, oc)
    c = _dot(oc, oc) - sc.radii[None] ** 2
    disc = h * h - a * c
    ok = disc >= 0
    sq = np.sqrt(np.maximum(disc, 0))
    r_near = (h - sq) / a
    r_far = (h + sq) / a
    tmax = np.broadcast_to(np.asarray(t_max)[..., None], r_near.shape)
    near_ok = (r_near > t_min) & (r_near < tmax)
    far_ok = (r_far > t_min) & (r_far < tmax)
    root = np.where(near_ok, r_near, r_far)
    ok = ok & (near_ok | far_ok)
    t_all = np.where(ok, root, np.inf)
    idx = np.argmin(t_all, axis=1)
    t = t_all[np.arange(len(o)), idx]
    hit = np.isfinite(t)
    ts = np.where(hit, t, 1.0)
    p = o + ts[:, None] * d
    outward = (p - sc.centers[idx]) / sc.radii[idx][:, None]
    front = _dot(d, outward) < 0
    normal = np.where(front[:, None], outward, -outward)
    return {"hit": hit, "t": t, "p": p, "normal": normal, "idx": idx}


def occluded(sc, p, lpos, t_min):
    delta = lpos - p
    dist = np.linalg.norm(delta, axis=-1)
    d = delta / np.maximum(dist, 1e-12)[:, None]
    rec = closest_sphere_hit(sc, p, d, t_min, dist)
    return rec["hit"]


# --------------------------------- shading ----------------------------------

def _spec_f0(albedo, metal):
    return (1 - metal[:, None]) * F0_DIELECTRIC + metal[:, None] * albedo


def _f90(f0):
    return np.minimum(1.0, (1.0 / F0_DIELECTRIC) * _lum(f0))


def _fresnel(f0, f90, ns):
    return f0 + (f90[:, None] - f0) * (1.0 - ns[:, None]) ** 5


def _ndf(ndoth, a2):
    b = (a2 - 1.0) * ndoth * ndoth + 1.0
    return a2 / np.maximum(0.001, PI * b * b)


def _g_alpha(alpha, ns):
    return ns / (np.maximum(1e-4, alpha) * np.sqrt(1.0 - np.minimum(0.99999, ns * ns)))


def _g_lambda(a):
    return (-1.0 + np.sqrt(1.0 + 1.0 / np.maximum(0.001, a * a))) * 0.5


def _g2(alpha, ndotl, ndotv):
    return 1.0 / (1.0 + _g_lambda(_g_alpha(alpha, ndotl)) + _g_lambda(_g_alpha(alpha, ndotv)))


def _perp(u):
    a = np.abs(u)
    xm = (((a[:, 0] - a[:, 1]) < 0) & ((a[:, 0] - a[:, 2]) < 0)).astype(np.int64)
    ym = np.where((a[:, 1] - a[:, 2]) < 0, 1 ^ xm, 0)
    zm = 1 ^ (xm | ym)
    axis = np.stack([xm, ym, zm], axis=-1).astype(u.dtype)
    return np.cross(u, axis)


def _reflect(i, n):
    return i - 2.0 * _dot(n, i)[:, None] * n


def _falloff(p, lp):
    d = lp - p
    return 1.0 / (0.0001 + _dot(d, d))


def _brdf_prob(albedo, metal, v, n):
    sf0 = _lum(_spec_f0(albedo, metal))
    dr = _lum(albedo * (1 - metal[:, None]))
    f0v = np.repeat(sf0[:, None], 3, axis=1)
    fres = _sat(_lum(_fresnel(f0v, _f90(f0v), np.maximum(0.0, _dot(v, n)))))
    spec = fres
    diff = dr * (1 - fres)
    return np.clip(spec / np.maximum(1e-4, spec + diff), 0.1, 0.9)


def _direct_legacy(p, n, v, albedo, specular, rough, lpos, lcol, lint, shadow):
    ldir = _norm(lpos - p)
    h = _norm(v + ldir)
    ndotl = _sat(_dot(n, ldir))
    ndoth = _sat(_dot(n, h))
    ldoth = _sat(_dot(ldir, h))
    ndotv = _sat(_dot(n, v))
    a2 = rough * rough
    dterm = a2 / np.maximum(0.001, ((ndoth * a2 - ndoth) * ndoth + 1.0) ** 2 * PI)
    k = rough * rough / 2
    gv = ndotv / np.maximum(0.001, ndotv * (1 - k) + k)
    gl = ndotl / np.maximum(0.001, ndotl * (1 - k) + k)
    gterm = np.abs(gv * gl)
    fterm = specular + (1 - specular) * np.maximum(0.001, 1 - ldoth[:, None]) ** 5
    intensity = lint * _falloff(p, lpos)
    ggx = fterm * (dterm * gterm / (4 * np.maximum(0.001, ndotv)))[:, None]
    light_term = shadow[:, None] * lcol * intensity[:, None]
    return light_term * (ggx + ndotl[:, None] * albedo / PI)


def _direct_new(n, ldir, v, albedo, rough, metal):
    h = _norm(ldir + v)
    ndotl = _sat(_dot(n, ldir))
    ndotv = _sat(_dot(n, v))
    ldoth = _sat(_dot(ldir, h))
    ndoth = _sat(_dot(n, h))
    f0 = _spec_f0(albedo, metal)
    alpha = rough * rough
    a2 = alpha * alpha
    fres = _fresnel(f0, _f90(f0), ldoth)
    diff_refl = albedo * (1 - metal[:, None])
    diffuse = diff_refl * (ndotl / PI)[:, None]
    dterm = _ndf(ndoth, np.maximum(1e-5, a2))
    gterm = _g2(alpha, ndotl, ndotv)
    denom = 4 * np.maximum(ndotl, 0.001) * np.maximum(ndotv, 0.001)
    specular = fres * (gterm * dterm / np.maximum(denom, 0.001) * ndotl)[:, None]
    return (1 - fres) * diffuse + specular


def _sample_diffuse(n, r1, r2):
    bit = _perp(n)
    tan = np.cross(bit, n)
    r = np.sqrt(np.abs(r1))
    phi = 2 * PI * r2
    return (tan * (r * np.cos(phi))[:, None] + bit * (r * np.sin(phi))[:, None]
            + n * np.sqrt(np.abs(1 - r1))[:, None])


def _sample_half(n, rough, r1, r2):
    b = _perp(n)
    t = np.cross(b, n)
    a2 = rough * rough
    cth = np.sqrt(np.maximum(0.0, (1 - r1) / ((a2 - 1) * r1 + 1)))
    sth = np.sqrt(np.maximum(0.0, 1 - cth * cth))
    phi = r2 * 2 * PI
    return (t * (sth * np.cos(phi))[:, None] + b * (sth * np.sin(phi))[:, None]
            + n * cth[:, None])


def _ris(p, sc: OracleScene, u_idx, u_sel):
    nrays = len(p)
    nl = len(sc.lint)
    total = np.zeros(nrays)
    sel_idx = np.zeros(nrays, np.int64)
    sel_pdf = np.zeros(nrays)
    selected = np.zeros(nrays, bool)
    for i in range(nl):
        cand = np.clip(np.floor(u_idx[:, i] * nl).astype(np.int64), 0, nl - 1)
        pdf = sc.lint[cand] * _falloff(p, sc.lpos[cand])
        w = pdf * nl
        total = total + w
        frac = np.divide(w, total, out=np.zeros_like(w), where=total > 0)
        accept = u_sel[:, i] < frac
        sel_idx = np.where(accept, cand, sel_idx)
        sel_pdf = np.where(accept, pdf, sel_pdf)
        selected |= accept
    weight = (total / nl) / np.maximum(0.001, sel_pdf)
    return selected, sel_idx, weight


# ------------------------------ the path tracer -----------------------------

def trace(sc: OracleScene, o, d, uniforms, max_depth=5, rr_bounces=3,
          t_min=1e-3, sky=(0.05, 0.05, 0.05), sky_gradient=False,
          sky_always=True):
    """Trace [N] rays with injected uniforms; mirrors the slot protocol of
    srt_tpu_torch.ops.rng exactly (jitter slots must already be
    consumed)."""
    nrays = len(o)
    nl = len(sc.lint)
    sky = np.asarray(sky, np.float64)
    off = 0

    def take(k):
        nonlocal off
        u = uniforms[:, off:off + k]
        off += k
        assert u.shape[1] == k, "oracle uniform array exhausted"
        return u

    throughput = np.ones((nrays, 3))
    color = np.zeros((nrays, 3))
    alive = np.ones(nrays, bool)

    def sky_term(dirs):
        if not sky_gradient:
            return np.broadcast_to(sky, (nrays, 3))
        dn = _norm(dirs)
        a = 0.5 * (dn[:, 1] + 1.0)
        return (1 - a)[:, None] * np.ones(3) + a[:, None] * np.array([0.5, 0.7, 1.0])

    for bounce in range(max_depth + rr_bounces):
        rec = closest_sphere_hit(sc, o, d, t_min, np.full(nrays, np.inf))
        active = alive & rec["hit"]
        missed = alive & ~rec["hit"]
        color += np.where(missed[:, None], throughput * sky_term(d), 0.0)
        alive = active

        v = -_norm(d)
        idx = rec["idx"]
        albedo = sc.albedo[idx]
        specular = sc.specular[idx]
        rough = sc.rough[idx]
        metal = sc.metal[idx]
        use_spec = sc.use_spec[idx]
        p, n = rec["p"], rec["normal"]

        u_idx = take(nl)
        u_sel = take(nl)
        sampled, li, lw = _ris(p, sc, u_idx, u_sel)
        lpos, lcol, lint = sc.lpos[li], sc.lcol[li], sc.lint[li]
        shadow = np.where(occluded(sc, p, lpos, t_min), 0.0, 1.0)

        dir_spec = _direct_legacy(p, n, v, albedo, specular, rough,
                                  lpos, lcol, lint, shadow) * lw[:, None]
        ldir = _norm(lpos - p)
        light_term = lcol * (_falloff(p, lpos) * lint * lw)[:, None]
        dir_diff = _direct_new(n, ldir, v, albedo, rough, metal) \
            * shadow[:, None] * light_term
        direct = np.where(use_spec[:, None], dir_spec, dir_diff)
        add = active & sampled
        color += np.where(add[:, None], throughput * direct, 0.0)

        u_lobe = take(1)[:, 0]
        forced = (metal == 1.0) & (rough == 0.0)
        prob = _brdf_prob(albedo, metal, v, n)
        chose_spec = u_lobe < prob
        take_spec = forced | chose_spec
        scale = np.where(forced, 1.0, np.where(chose_spec, 1 / prob, 1 / (1 - prob)))
        throughput = np.where(active[:, None], throughput * scale[:, None], throughput)

        u_rr = take(1)[:, 0]
        if bounce >= max_depth:
            survival = np.clip(_lum(throughput), 0.1, 1.0)
            died = active & (u_rr > survival)
            if sky_always:
                color += np.where(died[:, None], throughput * sky_term(d), 0.0)
            survived = active & ~died
            throughput = np.where(survived[:, None], throughput / survival[:, None],
                                  throughput)
            active = survived
            alive = active

        u4 = take(4)
        above = _dot(n, v) > 0
        # diffuse candidate
        ddir = _sample_diffuse(n, u4[:, 0], u4[:, 1])
        f0 = _spec_f0(albedo, metal)
        h = _sample_half(n, rough, u4[:, 2], u4[:, 3])
        vdoth = np.clip(_dot(v, h), 1e-5, 1.0)
        dweight = albedo * (1 - metal[:, None]) * (1 - _fresnel(f0, _f90(f0), vdoth))
        # specular candidate
        alpha = rough * rough
        lp = _reflect(-v, n)
        hp = _norm(v + lp)   # V + L (the -V form was tangent; see brdf.py)
        hs = np.where((alpha == 0)[:, None], hp, h)
        sdir = _reflect(-v, hs)
        hdotl = np.clip(_dot(hs, sdir), 1e-5, 1.0)
        ndotl = np.clip(_dot(n, sdir), 1e-5, 1.0)
        fterm = _fresnel(f0, _f90(f0), hdotl)
        s2 = ndotl * ndotl
        sw = 2.0 / (np.sqrt((alpha * alpha * (1 - s2) + s2) / s2) + 1.0)
        sweight = fterm * sw[:, None]

        raw = np.where(take_spec[:, None], sdir, ddir)
        weight = np.where(take_spec[:, None], sweight, dweight)
        direction = _norm(raw)
        valid = above & (_lum(weight) != 0.0) & (_dot(n, direction) > 0)
        invalid = active & ~valid
        if sky_always:
            color += np.where(invalid[:, None], throughput * sky_term(d), 0.0)
        cont = active & valid
        throughput = np.where(cont[:, None], throughput * weight, throughput)
        o = np.where(cont[:, None], p, o)
        d = np.where(cont[:, None], direction, d)
        alive = cont

    color += np.where(alive[:, None], throughput * sky_term(d), 0.0)
    return color


def render_image(sc: OracleScene, width, height, origin, look_at, uniforms,
                 v_up=(0, 1, 0), focus_dist=1.0, viewport_mode="reference",
                 vfov=90.0, **trace_kwargs):
    """Full-image oracle render with injected uniforms (jitter = slots 0:2)."""
    jitter = uniforms[:, 0:2]
    o, d = camera_rays(width, height, origin, look_at, v_up, focus_dist,
                       jitter, viewport_mode, vfov)
    color = trace(sc, o, d, uniforms[:, 2:], **trace_kwargs)
    return color.reshape(height, width, 3)
