"""Plain PyTorch reference of the path tracer the port renders with.

It shares no code with the port and imports nothing of it or of JAX.  It
follows the rendering specification path by path: the reference camera
(a 1 x 1 viewport at the focus distance), triangle hits by Moller-Trumbore
against every triangle whose box the ray enters (chunks of ``CHUNK``
consecutive triangles, each with its own box: a two-level search that is
exact, since a ray that misses a box misses its triangles), flat
geometric normals turned toward the ray, the mesh material rule
(roughness ``1 / (Ns + 1e-7)``, metalness 0.1, the legacy GGX direct
term), resampled importance sampling over point lights, one binary shadow
segment, GGX / cosine lobe sampling, Russian roulette past ``max_depth``
and a constant sky.  Uniforms come from ``lib/threefry`` at the lattice
points that each path of a frame reads (``uniforms_for``).

Only triangles with no emission and no texture are covered: the
configurations give none.  ``dtype`` sets the precision of every float
step (float32 for the reference; a lower one for the control).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from srtbench.lib import threefry

PI = 3.14159265358979323846
F0_DIELECTRIC = 0.04
METALNESS = 0.1
ROUGHNESS_EPS = 1e-7
PARALLEL_EPS = 1e-4
CHUNK = 128
# Work sizes of the search: rays a block, (ray, chunk) pairs a block.
RAY_BLOCK = 16384
PAIR_BLOCK = 32768


# ------------------------------- the search --------------------------------

def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v):
    n2 = _dot(v, v)
    ok = n2 > 0
    return v / torch.sqrt(torch.where(ok, n2, torch.ones_like(n2)))[..., None]


def moller_trumbore(o, d, v0, e1, e2):
    """(t, u, v, parallel) of rays o, d [..., 3] against triangles v0, e1 =
    v1 - v0, e2 = v2 - v0 [..., 3]."""
    h = _cross(d, e2)
    a = _dot(e1, h)
    parallel = a.abs() < PARALLEL_EPS
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = o - v0
    q = _cross(s, e1)
    return f * _dot(e2, q), f * _dot(s, h), f * _dot(d, q), parallel


class Mesh:
    """The search over a triangle mesh, built from its own inputs: vertex
    positions [V, 3] and corner indices [T, 3]."""

    def __init__(self, positions: torch.Tensor, tri_vidx: torch.Tensor,
                 dtype=torch.float32):
        self.dtype = dtype
        self.tri_vidx = tri_vidx.long()
        pos = positions.detach().to(dtype)
        v0, v1, v2 = (pos[self.tri_vidx[:, k]] for k in range(3))
        n = v0.shape[0]
        n_chunks = -(-n // CHUNK)
        pad = n_chunks * CHUNK - n
        self.n = n

        def chunked(x):
            if pad:
                x = torch.cat([x, x[-1:].expand(pad, 3)])
            return x.reshape(n_chunks, CHUNK, 3)

        self.v0 = chunked(v0)
        self.e1 = chunked(v1 - v0)
        self.e2 = chunked(v2 - v0)
        corners = torch.stack([self.v0, self.v0 + self.e1,
                               self.v0 + self.e2])
        lo = corners.amin((0, 2)).float()
        hi = corners.amax((0, 2)).float()
        # Boxes widened past any rounding of the corners or of the slab
        # test, so the search never drops a hit that its triangles give.
        grow = 1e-3 * (hi - lo).amax(-1, keepdim=True) + 1e-4 * torch.maximum(
            lo.abs(), hi.abs()) + 1e-6
        self.lo = lo - grow
        self.hi = hi + grow

    def _chunks_entered(self, o, d, t_lo, t_hi):
        """[R, K] bool: the ray's segment (t_lo, t_hi) meets chunk k's box.
        A NaN slab (zero direction on a face plane) counts as entered."""
        o = o.float()[:, None, :]
        inv = 1.0 / d.float()[:, None, :]
        t0 = (self.lo[None] - o) * inv
        t1 = (self.hi[None] - o) * inv
        near = torch.nan_to_num(torch.fmin(t0, t1).amax(-1),
                                nan=-math.inf)
        far = torch.nan_to_num(torch.fmax(t0, t1).amin(-1), nan=math.inf)
        return (near <= far) & (far >= t_lo) & (near <= t_hi.float()[:, None])

    def closest(self, o, d, t_lo: float, t_hi):
        """Closest hit of rays o, d [R, 3] with t in (t_lo, t_hi [R]):
        (t [R], tri [R] int64, -1 for none); a shadow segment is occluded
        where it finds one.  Runs without gradients."""
        with torch.no_grad():
            r_total = o.shape[0]
            dev = o.device
            best = torch.full((r_total,), torch.iinfo(torch.int64).max,
                              dtype=torch.int64, device=dev)
            for a in range(0, r_total, RAY_BLOCK):
                ob, db = o[a:a + RAY_BLOCK], d[a:a + RAY_BLOCK]
                th = t_hi[a:a + RAY_BLOCK]
                ri, ki = self._chunks_entered(ob, db, t_lo, th).nonzero(
                    as_tuple=True)
                for p0 in range(0, ri.shape[0], PAIR_BLOCK):
                    r = ri[p0:p0 + PAIR_BLOCK]
                    k = ki[p0:p0 + PAIR_BLOCK]
                    t, u, v, par = moller_trumbore(
                        ob[r][:, None, :].to(self.dtype),
                        db[r][:, None, :].to(self.dtype),
                        self.v0[k], self.e1[k], self.e2[k])
                    ok = (~par & (u >= 0) & (v >= 0) & (u + v <= 1)
                          & (t > t_lo) & (t < th[r].to(self.dtype)[:, None]))
                    tri = k[:, None] * CHUNK + torch.arange(
                        CHUNK, device=dev)[None, :]
                    ok = ok & (tri < self.n)
                    # Positive float32 bits order as integers: one amin
                    # picks the nearest t, then the lowest triangle.
                    bits = t.float().view(torch.int32).to(torch.int64)
                    key = torch.where(ok, (bits << 32) | tri,
                                      torch.iinfo(torch.int64).max)
                    best[a:a + RAY_BLOCK].scatter_reduce_(
                        0, r, key.amin(1), "amin")
            none = best == torch.iinfo(torch.int64).max
            tri = torch.where(none, -1, best & 0xFFFFFFFF)
            t = (best >> 32).to(torch.int32).view(torch.float32)
            t = torch.where(none, torch.full_like(t, math.inf), t)
            return t.to(self.dtype), tri


# ------------------------------- the shading -------------------------------

def _sat(x):
    return torch.clamp(x, 0.0, 1.0)


def _lum(rgb):
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def _spec_f0(albedo, metal):
    return (1 - metal[:, None]) * F0_DIELECTRIC + metal[:, None] * albedo


def _f90(f0):
    return torch.clamp(_lum(f0) / F0_DIELECTRIC, max=1.0)


def _fresnel(f0, f90, ns):
    return f0 + (f90[:, None] - f0) * (1.0 - ns[:, None]) ** 5


def _falloff(p, lp):
    dd = lp - p
    return 1.0 / (1e-4 + _dot(dd, dd))


def _perp(u):
    a = u.abs()
    xm = ((a[:, 0] - a[:, 1]) < 0) & ((a[:, 0] - a[:, 2]) < 0)
    ym = ((a[:, 1] - a[:, 2]) < 0) & ~xm
    zm = ~(xm | ym)
    return _cross(u, torch.stack([xm, ym, zm], -1).to(u.dtype))


def _reflect(i, n):
    return i - 2.0 * _dot(n, i)[:, None] * n


def _brdf_prob(albedo, metal, v, n):
    sf0 = _lum(_spec_f0(albedo, metal))
    dr = _lum(albedo * (1 - metal[:, None]))
    f0v = sf0[:, None].expand(-1, 3)
    fres = _sat(_lum(_fresnel(f0v, _f90(f0v), torch.clamp(_dot(v, n), min=0))))
    return torch.clamp(fres / torch.clamp(fres + dr * (1 - fres), min=1e-4),
                       0.1, 0.9)


def _direct(p, n, v, albedo, specular, rough, lpos, lcol, lint, shadow):
    """The legacy GGX direct term of a material that uses its specular
    colour, toward one point light."""
    ldir = _norm(lpos - p)
    h = _norm(v + ldir)
    ndotl = _sat(_dot(n, ldir))
    ndoth = _sat(_dot(n, h))
    ldoth = _sat(_dot(ldir, h))
    ndotv = _sat(_dot(n, v))
    a2 = rough * rough
    dterm = a2 / torch.clamp(((ndoth * a2 - ndoth) * ndoth + 1.0) ** 2 * PI,
                             min=0.001)
    k = rough * rough / 2
    gv = ndotv / torch.clamp(ndotv * (1 - k) + k, min=0.001)
    gl = ndotl / torch.clamp(ndotl * (1 - k) + k, min=0.001)
    gterm = (gv * gl).abs()
    fterm = specular + (1 - specular) * torch.clamp(
        1 - ldoth[:, None], min=0.001) ** 5
    intensity = lint * _falloff(p, lpos)
    ggx = fterm * (dterm * gterm / (4 * torch.clamp(ndotv, min=0.001)))[:, None]
    light = shadow[:, None] * lcol * intensity[:, None]
    return light * (ggx + ndotl[:, None] * albedo / PI)


def _sample_diffuse(n, r1, r2):
    bit = _perp(n)
    tan = _cross(bit, n)
    r = torch.sqrt(r1.abs())
    phi = 2 * PI * r2
    return (tan * (r * torch.cos(phi))[:, None]
            + bit * (r * torch.sin(phi))[:, None]
            + n * torch.sqrt((1 - r1).abs())[:, None])


def _sample_half(n, rough, r1, r2):
    b = _perp(n)
    t = _cross(b, n)
    a2 = rough * rough
    cth = torch.sqrt(torch.clamp((1 - r1) / ((a2 - 1) * r1 + 1), min=0))
    sth = torch.sqrt(torch.clamp(1 - cth * cth, min=0))
    phi = r2 * 2 * PI
    return (t * (sth * torch.cos(phi))[:, None]
            + b * (sth * torch.sin(phi))[:, None] + n * cth[:, None])


def _ris(p, lpos, lint, u_idx, u_sel):
    nl = lint.shape[0]
    pdf_all = lint[None, :] * _falloff(p[:, None, :], lpos[None, :, :])
    total = torch.zeros_like(p[:, 0])
    sel_idx = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    sel_pdf = torch.zeros_like(total)
    selected = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for i in range(nl):
        cand = torch.clamp(torch.floor(u_idx[i] * nl).long(), 0, nl - 1)
        pdf = pdf_all.gather(1, cand[:, None])[:, 0]
        w = pdf * nl
        total = total + w
        frac = torch.where(total > 0, w / torch.where(
            total > 0, total, torch.ones_like(total)), torch.zeros_like(w))
        accept = u_sel[i] < frac
        sel_idx = torch.where(accept, cand, sel_idx)
        sel_pdf = torch.where(accept, pdf, sel_pdf)
        selected = selected | accept
    return selected, sel_idx, (total / nl) / torch.clamp(sel_pdf, min=0.001)


def _sample_indirect(n, v, albedo, rough, metal, take_spec, u4):
    above = _dot(n, v) > 0
    ddir = _sample_diffuse(n, u4[0], u4[1])
    f0 = _spec_f0(albedo, metal)
    h = _sample_half(n, rough, u4[2], u4[3])
    vdoth = torch.clamp(_dot(v, h), 1e-5, 1.0)
    dweight = albedo * (1 - metal[:, None]) * (1 - _fresnel(f0, _f90(f0),
                                                            vdoth))
    alpha = rough * rough
    lp = _reflect(-v, n)
    hp_raw = v + lp
    hp = torch.where((_dot(hp_raw, hp_raw) > 0)[:, None], _norm(hp_raw), n)
    hs = torch.where((alpha == 0)[:, None], hp, h)
    sdir = _reflect(-v, hs)
    hdotl = torch.clamp(_dot(hs, sdir), 1e-5, 1.0)
    ndotl = torch.clamp(_dot(n, sdir), 1e-5, 1.0)
    s2 = ndotl * ndotl
    sw = 2.0 / (torch.sqrt((alpha * alpha * (1 - s2) + s2) / s2) + 1.0)
    sweight = _fresnel(f0, _f90(f0), hdotl) * sw[:, None]
    raw = torch.where(take_spec[:, None], sdir, ddir)
    weight = torch.where(take_spec[:, None], sweight, dweight)
    direction = _norm(raw)
    valid = above & (_lum(weight) != 0) & (_dot(n, direction) > 0)
    return direction, weight, valid


class Scene:
    """What one render needs: the search mesh, the shading positions (a
    parameter where gradients are wanted), corner indices, the material,
    the lights and the render settings, all in ``dtype``."""

    def __init__(self, search: Mesh, positions, kd, ks, ns: float, lights,
                 sky, t_min: float, max_depth: int, rr_bounces: int):
        dt = search.dtype
        self.search = search
        self.positions = positions.to(dt)
        self.kd = kd.to(dt)
        self.ks = ks.to(dt)
        self.rough = 1.0 / (ns + ROUGHNESS_EPS)
        self.lpos, self.lcol, self.lint = (x.to(dt) for x in lights)
        self.sky = sky.to(dt)
        self.t_min = t_min
        self.max_depth = max_depth
        self.n_bounces = max_depth + rr_bounces
        self.dtype = dt

    @property
    def n_lights(self) -> int:
        return self.lint.shape[0]

    @property
    def slots(self) -> int:
        """Uniform slots a bounce: RIS index and selection a light, lobe,
        roulette, two diffuse and two half-vector draws."""
        return 2 * self.n_lights + 6

    def hit(self, o, d, t_hi):
        """Closest hit: (hit [R], t, p, n) with the triangle found on the
        search mesh and t, p and the normal from the shading positions."""
        t_s, tri = self.search.closest(o.detach(), d.detach(), self.t_min,
                                       t_hi)
        hit = tri >= 0
        vid = self.search.tri_vidx[tri.clamp_min(0)]
        v0, v1, v2 = (self.positions[vid[:, k]] for k in range(3))
        e1, e2 = v1 - v0, v2 - v0
        t, _, _, _ = moller_trumbore(o, d, v0, e1, e2)
        t = torch.where(hit, t, torch.ones_like(t))
        p = o + t[:, None] * d
        n = _norm(_cross(e1, e2))
        n = torch.where((_dot(n, d) < 0)[:, None], n, -n)
        return hit, p, n

    def trace(self, o, d, u):
        """Radiance [R, 3] of paths from o, d [R, 3]; ``u`` [B * D, R]
        their bounce uniforms, slot-major."""
        dt = self.dtype
        # Uniforms stay in [0, 1) in the lower precisions, where rounding
        # would give 1.0 (the largest float of the type below 1 instead).
        o, d = o.to(dt), d.to(dt)
        u = torch.clamp(u.to(dt), max=1.0 - torch.finfo(dt).eps / 2)
        r = o.shape[0]
        nl = self.n_lights
        dd = self.slots
        inf = torch.full((r,), math.inf, dtype=dt, device=o.device)
        throughput = torch.ones((r, 3), dtype=dt, device=o.device)
        color = torch.zeros((r, 3), dtype=dt, device=o.device)
        alive = torch.ones(r, dtype=torch.bool, device=o.device)
        metal = torch.full((r,), METALNESS, dtype=dt, device=o.device)
        rough = torch.full((r,), self.rough, dtype=dt, device=o.device)
        albedo = self.kd.expand(r, 3)
        specular = self.ks.expand(r, 3)
        zero3 = torch.zeros_like(color)
        for b in range(self.n_bounces):
            ub = u[b * dd:(b + 1) * dd]
            hit, p, n = self.hit(o, d, torch.where(alive, inf,
                                                   torch.zeros_like(inf)))
            active = alive & hit
            color = color + torch.where((alive & ~hit)[:, None],
                                        throughput * self.sky, zero3)
            v = -_norm(d)
            sampled, li, lw = _ris(p, self.lpos, self.lint, ub[0:nl],
                                   ub[nl:2 * nl])
            lpos, lcol, lint = self.lpos[li], self.lcol[li], self.lint[li]
            delta = lpos - p
            ldir = _norm(delta)
            shadow_on = active & sampled & (_dot(n, ldir) > 0)
            dist = torch.where(shadow_on, torch.sqrt(_dot(delta, delta)),
                               torch.zeros_like(lint))
            occ = torch.zeros_like(shadow_on)
            idx = shadow_on.nonzero()[:, 0]
            if idx.numel():
                _, tri = self.search.closest(p[idx].detach(),
                                             ldir[idx].detach(), self.t_min,
                                             dist[idx].detach())
                occ[idx] = tri >= 0
            shadow = torch.where(occ, 0.0, 1.0).to(dt)
            direct = _direct(p, n, v, albedo, specular, rough, lpos, lcol,
                             lint, shadow) * lw[:, None]
            color = color + torch.where((active & sampled)[:, None],
                                        throughput * direct, zero3)
            forced = (metal == 1.0) & (rough == 0.0)
            prob = _brdf_prob(albedo, metal, v, n)
            chose = ub[2 * nl] < prob
            take_spec = forced | chose
            scale = torch.where(forced, torch.ones_like(prob),
                                torch.where(chose, 1 / prob, 1 / (1 - prob)))
            throughput = torch.where(active[:, None],
                                     throughput * scale[:, None], throughput)
            if b >= self.max_depth:
                survival = torch.clamp(_lum(throughput), 0.1, 1.0)
                died = active & (ub[2 * nl + 1] > survival)
                color = color + torch.where(died[:, None],
                                            throughput * self.sky, zero3)
                active = active & ~died
                throughput = torch.where(active[:, None],
                                         throughput / survival[:, None],
                                         throughput)
            direction, weight, valid = _sample_indirect(
                n, v, albedo, rough, metal, take_spec,
                ub[2 * nl + 2:2 * nl + 6])
            color = color + torch.where((active & ~valid)[:, None],
                                        throughput * self.sky, zero3)
            cont = active & valid
            throughput = torch.where(cont[:, None], throughput * weight,
                                     throughput)
            o = torch.where(cont[:, None], p, o)
            d = torch.where(cont[:, None], direction, d)
            alive = cont
        return color + torch.where(alive[:, None], throughput * self.sky,
                                   zero3)


# ------------------------------ camera, uniforms ---------------------------

def camera_rays(cam: dict, x, y, jitter, dtype=torch.float32):
    """Primary rays of pixels (x, y) [R] with jitter [2, R] in [0, 1):
    the reference camera, its frame worked out in float64."""
    origin = np.asarray(cam["origin"], np.float64)
    look = np.asarray(cam["look_at"], np.float64)
    up = np.asarray(cam.get("v_up", (0.0, 1.0, 0.0)), np.float64)
    focus = float(cam.get("focus_dist", 1.0))
    w_px, h_px = cam["width"], cam["height"]

    def unit(v):
        return v / np.linalg.norm(v)

    front = unit(look - origin)
    right = unit(np.cross(front, up))
    upv = unit(np.cross(right, front))
    view_u, view_v = right * focus, upv * focus
    du, dv = view_u / w_px, view_v / h_px
    p00 = origin + focus * front - view_u / 2 - view_v / 2 + 0.5 * (du + dv)
    dev = jitter.device
    t64 = dict(dtype=torch.float64, device=dev)
    fx = x.to(torch.float64) + jitter[0].to(torch.float64) - 0.5
    fy = y.to(torch.float64) + jitter[1].to(torch.float64) - 0.5
    px = (torch.tensor(p00, **t64)[None] + fx[:, None]
          * torch.tensor(du, **t64)[None] + fy[:, None]
          * torch.tensor(dv, **t64)[None])
    o = torch.tensor(origin, **t64)[None].expand_as(px)
    return o.to(dtype), (px - o).to(dtype)


def uniforms_for(layout: str, key, n: int, ids, n_bounces: int,
                 slots: int):
    """(jitter [2, R], bounce uniforms [B * D, R]) of paths ``ids`` [R]
    (int64) of one sample drawn from ``key`` over ``n`` paths.

    ``"slots"``: the ``[k, n]`` blocks of a key stream, jitter from
    ``fold_in(key, 0)`` rows 0-1, bounce b slot s from ``fold_in(key, 1)``
    row b * D + s (the compact and scan drivers).  ``"rows"``: one
    ``[n, 2 + B * D]`` block at ``key``, path i's slots in row i (the
    sharded driver)."""
    if layout == "slots":
        jit = threefry.block_columns(threefry.fold_in(key, 0), range(2), n,
                                     ids)
        bnc = threefry.block_columns(threefry.fold_in(key, 1),
                                     range(n_bounces * slots), n, ids)
        return jit, bnc
    if layout == "rows":
        width = 2 + n_bounces * slots
        pts = ids.to(torch.int64)[None, :] * width + torch.arange(
            width, device=ids.device)[:, None]
        u = threefry.uniforms_at(key, pts)
        return u[:2], u[2:]
    raise ValueError(f"unknown uniform layout {layout!r}")


def render_paths(scene: Scene, cam: dict, layout: str, key, n: int, ids,
                 spp_of: Optional[Callable] = None):
    """Radiance [R, 3] of paths ``ids`` of one sample: pixel ``ids //
    spp`` where the sample's paths hold ``spp`` samples a pixel
    (``spp_of``: the paths a pixel, default 1)."""
    spp = spp_of or 1
    pix = ids // spp
    x, y = pix % cam["width"], pix // cam["width"]
    jit, u = uniforms_for(layout, key, n, ids, scene.n_bounces, scene.slots)
    o, d = camera_rays(cam, x, y, jit, scene.dtype)
    return scene.trace(o, d, u)
