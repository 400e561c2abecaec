"""One-bounce intersection of explicit rays (counterpart of
``srt_tpu/models/wavefront.py``).

The reference keeps a standalone intersect kernel that reads a ray buffer
and writes hit triangle ids (``ray_intersects.glsl:135-161``); this is
that capability as an API: intersect an ``[N, 3]`` ray batch with a mesh
scene and get global triangle indices (-1 on a miss), or the full ``Hit``.

``method`` is ``mesh.mesh_hit_fn``'s: ``"walk"`` (the kernels on CUDA
tensors, their plain versions on CPU tensors; the port's default),
``"dense"`` or ``"bvh"`` (the BVH stack walk, which refuses a
``refit_accel``-ed scene).  Rays go to the scene's device.
"""

from __future__ import annotations

import torch

from srt_tpu_torch.models import mesh as mesh_mod
from srt_tpu_torch.ops import traversal


def _rays_t(scene, origins, dirs):
    """[N, 3] rays -> [3, N] float32 on the scene's device."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=scene.device).T
    return t(origins), t(dirs)


def hit_ids(scene: mesh_mod.MeshScene, origins, dirs, t_min: float = 1e-3,
            t_max=None, method: str = "walk"):
    """Closest hit of each ray: (tri_idx [N] int32, -1 on a miss; t [N],
    the running bound on a miss).  The reference integration test's
    readback (``GetHits``)."""
    o_t, d_t = _rays_t(scene, origins, dirs)
    n = o_t.shape[1]
    best_t = torch.as_tensor(float("inf") if t_max is None else t_max,
                             dtype=torch.float32,
                             device=scene.device).expand(n).clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=scene.device)
    for b in range(scene.num_models):
        if method == "walk":
            t, i, _, _ = traversal.model_hit(scene, b, o_t, d_t, best_t)
        elif method == "dense":
            t, i, _, _ = mesh_mod._dense_model_hit(scene, b, o_t, d_t, best_t)
        elif method == "bvh":
            t, i, _, _ = mesh_mod._bvh_model_hit(scene, b, o_t, d_t, best_t)
        else:
            raise ValueError(f"unknown traversal method: {method}")
        better = (i != -1) & (t < best_t) & (t > t_min)
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, i, best_i)
    return best_i, best_t


def intersect_rays(scene: mesh_mod.MeshScene, origins, dirs,
                   t_min: float = 1e-3, t_max=None, method: str = "walk"):
    """(tri_idx [N] int32 with -1 on a miss, t [N] with inf on a miss):
    the wavefront kernel's contract (``hits[index] = uint(-1)`` on a miss,
    ray_intersects.glsl:145).  ``intersect_full`` gives the shading
    record."""
    idx, t = hit_ids(scene, origins, dirs, t_min=t_min, t_max=t_max,
                     method=method)
    return idx, torch.where(idx >= 0, t, torch.full_like(t, float("inf")))


def intersect_full(scene: mesh_mod.MeshScene, origins, dirs,
                   t_min: float = 1e-3, t_max=None, method: str = "walk"):
    """The full ``Hit`` record (position, facing normal, converted
    material) of the closest hit of [N, 3] rays."""
    o_t, d_t = _rays_t(scene, origins, dirs)
    if t_max is None:
        t_max = float("inf")
    return mesh_mod.mesh_hit_fn(scene, method=method)(o_t, d_t, t_min, t_max,
                                                      any_hit=False)
