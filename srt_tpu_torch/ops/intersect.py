"""Primitive intersection over ray wavefronts (counterpart of
``srt_tpu/ops/intersect.py``): spheres (reference ``SphereHit``,
raytrace_compute.glsl:93-120) and the dense Moller-Trumbore sweep
(``IntersectsTriangle``, ray_intersects.glsl:61-96), and the slab
test of the BVH stack walk (``IntersectsBox``)."""

from __future__ import annotations

import torch

from srt_tpu_torch.ops.vec import cross, dot

MT_PARALLEL_EPS = 1e-4   # ray-parallel epsilon (ray_intersects.glsl:73)
MT_HIT_EPS = 1e-5        # minimum hit distance  (ray_intersects.glsl:89)


def sphere_hit(origins, dirs, centers, radii, t_min, t_max):
    """Closest sphere hit per ray: the quadric's near root if inside
    (t_min, t_max), else its far root, then the nearest sphere (the
    closest-hit loop of ``CheckHit``, raytrace_compute.glsl:122-141).

    origins/dirs [3, N]; centers [S, 3]; radii [S]; ``t_max`` a float or
    [N].  Returns (hit [N] bool, t [N], idx [N] int32)."""
    ct = centers.T                                           # [3, S]
    oc = ct[:, :, None] - origins[:, None, :]                # [3, S, N]
    a = (dirs * dirs).sum(0)[None, :]                        # [1, N]
    h = (dirs[:, None, :] * oc).sum(0)                       # [S, N]
    c = (oc * oc).sum(0) - (radii * radii)[:, None]          # [S, N]
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=origins.device)
    t_max = (t_max[None, :] if t_max.ndim else t_max).expand(h.shape)
    disc = h * h - a * c
    valid = disc >= 0.0
    # Double where: the masked-out sqrt sees a positive argument, so a
    # gradient through it stays finite (the derivative of sqrt at 0 is
    # inf, and 0 * inf = NaN).  The root is taken in float64 and rounded:
    # the correctly rounded float32 root on every device (torch's CPU
    # float32 sqrt is an ulp off on ~0.7% of inputs, and the far root of
    # a ray inside the ground sphere cancels h against it).
    sqrtd = torch.sqrt(torch.where(valid, disc, torch.ones_like(disc))
                       .double()).float()
    root_near = (h - sqrtd) / a
    root_far = (h + sqrtd) / a
    near_ok = (t_min < root_near) & (root_near < t_max)
    far_ok = (t_min < root_far) & (root_far < t_max)
    root = torch.where(near_ok, root_near, root_far)
    valid = valid & (near_ok | far_ok)
    t_all = torch.where(valid, root, torch.full_like(root, float("inf")))
    t, idx = t_all.min(0)
    return torch.isfinite(t), t, idx.to(torch.int32)


def sphere_normal(p, center, radius, dirs):
    """Outward normal flipped to face the ray (``SetFaceNormal``,
    raytrace_utils.glsl:23-26).  p/center/dirs [3, N]; radius [N].
    Returns (normal [3, N], front_face [N])."""
    outward = (p - center) / radius[None, :]
    front = (dirs * outward).sum(0) < 0.0
    return torch.where(front[None, :], outward, -outward), front


def mt_refine(origins, dirs, v0, e1, e2):
    """Exact Moller-Trumbore of one triangle per ray (the walk's winner):
    [3, N] operands, e1 = v1 - v0, e2 = v2 - v0.  Returns (t, u, v) [N],
    without the hit tests (the walk already made them)."""
    h = cross(dirs, e2)
    a = dot(e1, h)
    parallel = a.abs() < MT_PARALLEL_EPS
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = origins - v0
    q = cross(s, e1)
    return f * dot(e2, q), f * dot(s, h), f * dot(dirs, q)


def _cross_last(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def mt_hits(origins, dirs, v0, v1, v2):
    """Moller-Trumbore over operands that broadcast against each other,
    [..., 3] each.  Returns (t with inf for a miss, u, v), the broadcast
    shape without the last axis.  The dense sweep and the BVH stack walk
    both evaluate it, so one (ray, triangle) pair gives the same bits on
    either route."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = _cross_last(dirs, e2)
    a = (e1 * h).sum(-1)
    parallel = a.abs() < MT_PARALLEL_EPS
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = origins - v0
    u = f * (s * h).sum(-1)
    q = _cross_last(s, e1)
    v = f * (dirs * q).sum(-1)
    t = f * (e2 * q).sum(-1)
    miss = parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0) \
        | (t <= MT_HIT_EPS)
    return torch.where(miss, torch.full_like(t, float("inf")), t), u, v


def moller_trumbore(origins, dirs, v0, v1, v2):
    """Dense ray x triangle Moller-Trumbore.

    origins/dirs: [N, 3]; v0/v1/v2: [T, 3].  Returns (t [N, T] with inf
    for a miss, u [N, T], v [N, T]); the caller takes the min over T.
    """
    return mt_hits(origins[:, None, :], dirs[:, None, :], v0[None],
                   v1[None], v2[None])


def ray_aabb(origins, dirs, bmin, bmax):
    """Slab test (``IntersectsBox``, ray_intersects.glsl:49-58): the entry
    distance, the exit distance if the origin is inside, inf on a miss:
    ``t_near <= t_far ? (t_near >= 0 ? t_near : t_far) : inf``.

    origins/dirs [..., 3]; bmin/bmax broadcastable to them.  A zero
    direction component divides to +/-inf, and 0 * inf gives NaN;
    ``torch.minimum`` and ``amax`` propagate it as JAX's ``jnp.minimum``
    and ``jnp.max`` do, so a NaN lane misses on both sides."""
    inv = 1.0 / dirs
    t0 = (bmin - origins) * inv
    t1 = (bmax - origins) * inv
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return torch.where(t_near <= t_far,
                       torch.where(t_near >= 0.0, t_near, t_far),
                       torch.full_like(t_near, float("inf")))
