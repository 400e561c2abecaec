"""Multi-process tile rendering and image assembly (counterpart of
``srt_tpu/parallel/multihost.py``).

After ``init_distributed`` each rank knows its tile of the image from its
coordinate on the mesh's rays axis (``local_shard_bounds``), traces only
that tile, and the tiles are all-gathered into the full image on every
rank.  A world of 1 degenerates to the trivial assembly, so the same
calling code runs from one card to many hosts.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models.pathtracer import trace_wavefront
from srt_tpu_torch.ops.rng import ArrayStream
from srt_tpu_torch.parallel.mesh import local_shard_bounds
from srt_tpu_torch.parallel.render_sharded import (_draw_uniforms,
                                                   _gather_columns,
                                                   _rays_order, _rays_shard)


def local_ray_tile(cam: CameraConfig, mesh, uniforms):
    """This rank's rays and uniform rows.

    ``uniforms`` is the full-image [N, D] block (drawn identically on every
    rank from a shared key, so tiles stay consistent); returns
    (origins [3, n_local], dirs, uniforms_local, (lo, hi))."""
    n = cam.height * cam.width
    lo, hi = local_shard_bounds(n, mesh)
    vp = derive_viewport(cam, device=uniforms.device)
    origins, dirs = generate_rays(vp, cam.width, cam.height,
                                  uniforms[:, 0:2].T)
    return origins[:, lo:hi], dirs[:, lo:hi], uniforms[lo:hi], (lo, hi)


def render_local_tile(make_hit_fn, scene, lights, cam: CameraConfig,
                      cfg: RenderConfig, key, mesh):
    """Trace only this rank's tile (one sample); returns (radiance
    [3, n_local], (lo, hi))."""
    n = cam.height * cam.width
    uniforms = _draw_uniforms(key, n, lights.count,
                              cfg.max_depth + cfg.rr_bounces)
    o, dirs, u_local, (lo, hi) = local_ray_tile(cam, mesh, uniforms)
    stream = ArrayStream(u_local)
    stream.take(2)  # jitter rows consumed by local_ray_tile's ray gen
    radiance = trace_wavefront(make_hit_fn(scene), lights, o, dirs, stream,
                               cfg)
    return radiance, (lo, hi)


def assemble_image(local_radiance, bounds, cam: CameraConfig, mesh=None):
    """The full [H, W, 3] image (numpy) on every rank of the mesh.

    A world of 1: the tile is the image.  Otherwise the tiles are
    all-gathered over ``mesh``'s rays group in rays order (ranks that
    share a rays coordinate hold the same tile)."""
    lo, hi = bounds
    n = cam.height * cam.width
    if not dist.is_initialized() or dist.get_world_size() == 1:
        if (lo, hi) != (0, n):
            raise ValueError(f"a world of 1 owns rows (0, {n}), not "
                             f"{(lo, hi)}")
        flat = local_radiance
    else:
        if mesh is None:
            raise ValueError("a world of several ranks assembles over a mesh")
        group, _, _ = _rays_shard(n, mesh)
        flat = _gather_columns(local_radiance.detach(), group,
                               _rays_order(mesh, group))
    return np.asarray(flat.detach().cpu()).T.reshape(cam.height, cam.width, 3)


def render_multihost(make_hit_fn, scene, lights, cam: CameraConfig,
                     cfg: RenderConfig, key, mesh):
    """Full multi-process render: local tile trace + assembly."""
    radiance, bounds = render_local_tile(make_hit_fn, scene, lights, cam,
                                         cfg, key, mesh)
    return assemble_image(radiance, bounds, cam, mesh)
