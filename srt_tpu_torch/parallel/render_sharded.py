"""Sharded rendering and the gradient all-reduce (counterpart of
``srt_tpu/parallel/render_sharded.py``).

JAX shards with ``shard_map``: rays on the ``rays`` axis (inputs
``P(None, RAYS_AXIS)``), the scene replicated (``P()``), the radiance
gathered (out spec ``P(None, RAYS_AXIS)``), and the transpose psums a
replicated input's cotangent.  Here each rank traces its contiguous
columns ``[lo, hi)`` of the ``[3, N]`` rays (ranks that share a rays
coordinate trace the same columns: the samples axis replicates), and two
autograd functions give the same gradients:

* ``_GatherRays``: forward, an all-gather of the radiance over the rays
  group, in rays order; backward, this rank's own columns of the incoming
  gradient, with no communication.  (``torch.distributed.nn``'s
  all-gather reduce-scatters in its backward: every rank computes the
  same replicated loss, so that would count the gradient once per rank.)
* ``_Replicated``: one node over all the scene's and lights' tensors that
  require grad.  Forward, the identity; backward, one SUM all-reduce of
  their gradients as one flat buffer in a fixed order, over the rays
  group only (a SUM over the whole world would count each slice once per
  samples shard).  One node and one buffer, so that every rank runs the
  same collectives in the same order.

``loss.backward()`` on every rank then leaves the unsharded gradient on
every rank.  A gradient with respect to the rays or the uniforms lands in
this rank's columns only (JAX's sharded cotangent).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from srt_tpu_torch.camera import derive_viewport, generate_rays
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models.pathtracer import trace_wavefront
from srt_tpu_torch.ops import rng
from srt_tpu_torch.optim import (_leaves_with_paths, _rebuild,
                                 float_partition)
from srt_tpu_torch.parallel.mesh import RAYS_AXIS
from srt_tpu_torch.scene import Lights


def _draw_uniforms(key, n, n_lights, n_bounces):
    """``jax.random.uniform(key, (n, d))`` bit for bit: the threefry
    lattice's [n, d] block (``rng.SlotBlock``)."""
    return rng.SlotBlock(key, n, rng.total_slots(n_lights, n_bounces)).full()


def _rays_shard(n: int, mesh):
    """(rays group, this rank's rays coordinate, columns per shard)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is outside the mesh "
                         f"{mesh.mesh.tolist()}")
    rays = mesh.size(0)
    if n % rays:
        raise ValueError(f"{n} rays do not split over {rays} shards")
    return mesh.get_group(RAYS_AXIS), coord[0], n // rays


def _rays_order(mesh, group):
    """Group ranks of ``group`` sorted by their rays coordinate."""
    coord = {int(r): i for i, row in enumerate(mesh.mesh.tolist())
             for r in row}
    members = dist.get_process_group_ranks(group)
    return sorted(range(len(members)), key=lambda j: coord[members[j]])


def _gather_columns(local, group, order):
    """All-gather [..., n_local] over ``group``; concatenated on the last
    axis in ``order`` (``_rays_order``)."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in order]
    dist.all_gather(parts, local, group=group)
    return torch.cat([parts[j] for j in order], dim=-1)


class _GatherRays(torch.autograd.Function):
    """[3, n_local] -> [3, N] gathered over the rays group in rays order;
    the backward keeps this rank's columns ``[lo, hi)``."""

    @staticmethod
    def forward(ctx, local, group, order, lo, hi):
        ctx.lo, ctx.hi = lo, hi
        return _gather_columns(local, group, order)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.lo:ctx.hi], None, None, None, None


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward all-reduces (SUM) every gradient
    over ``group`` as one flat buffer."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return (None, *out)


def _replicate(tree, group):
    """``tree`` with its tensors that require grad routed through one
    ``_Replicated`` node (unchanged when none does)."""
    leaves, merge = float_partition(tree, lambda _, t: t.requires_grad)
    if not leaves:
        return tree
    return merge(_Replicated.apply(group, *leaves))


def _trace_columns(make_hit_fn, scene, lights, origins, dirs, uniforms,
                   cfg, lo, hi, group, order):
    """Trace this rank's columns ``[lo, hi)`` and gather the radiance."""
    if dist.get_world_size(group) > 1:
        scene, lights = _replicate((scene, lights), group)
    stream = rng.ArrayStream(uniforms[lo:hi])
    stream.take(2)  # jitter slots consumed by the caller's ray gen
    local = trace_wavefront(make_hit_fn(scene), lights, origins[:, lo:hi],
                            dirs[:, lo:hi], stream, cfg)
    if dist.get_world_size(group) == 1:
        return local
    return _GatherRays.apply(local, group, order, lo, hi)


def trace_sharded(make_hit_fn: Callable, scene, lights: Lights,
                  origins, dirs, uniforms, cfg: RenderConfig, mesh):
    """Trace a ray batch with rays sharded over the mesh: every rank of the
    mesh passes the whole ``[3, N]`` origins and dirs and ``[N, D]``
    uniforms, traces its columns and returns the gathered ``[3, N]``
    radiance.  ``make_hit_fn(scene) -> hit_fn``; N must be a multiple of
    the rays axis' size (``ValueError`` otherwise, as ``shard_map``)."""
    n = origins.shape[1]
    group, r, per = _rays_shard(n, mesh)
    return _trace_columns(make_hit_fn, scene, lights, origins, dirs,
                          uniforms, cfg, r * per, (r + 1) * per, group,
                          _rays_order(mesh, group))


def render_sharded(make_hit_fn: Callable, scene, lights: Lights,
                   cam: CameraConfig, cfg: RenderConfig, key, mesh):
    """Full-image sharded render, spp-accumulated; linear [H, W, 3] on
    every rank of the mesh.  Sample s draws ``_draw_uniforms(fold_in(key,
    s), ...)`` and traces it as ``trace_sharded`` does, so a mesh of any
    shape gives the image of the unsharded ``trace_wavefront`` over the
    same uniforms."""
    n = cam.height * cam.width
    n_bounces = cfg.max_depth + cfg.rr_bounces
    group, r, per = _rays_shard(n, mesh)
    order = _rays_order(mesh, group)
    acc = torch.zeros((3, n), dtype=torch.float32, device=key.device)
    for s in range(cfg.spp):
        uniforms = _draw_uniforms(rng.fold_in(key, s), n, lights.count,
                                  n_bounces)
        vp = derive_viewport(cam, device=key.device)
        origins, dirs = generate_rays(vp, cam.width, cam.height,
                                      uniforms[:, 0:2].T)
        acc = acc + _trace_columns(make_hit_fn, scene, lights, origins, dirs,
                                   uniforms, cfg, r * per, (r + 1) * per,
                                   group, order)
    return (acc / cfg.spp).T.reshape(cam.height, cam.width, 3)


def sharded_loss_and_grad(make_hit_fn: Callable, lights: Lights,
                          cam: CameraConfig, cfg: RenderConfig, mesh):
    """``(scene, target, key) -> (loss, grads)``: the L2 image loss of
    ``render_sharded`` and its gradient with respect to every float tensor
    of ``scene``, the same on every rank of the mesh.  ``grads`` is a
    scene of the same type holding each float field's gradient and None
    for integer and bool fields (JAX's ``float0``)."""

    def loss_and_grad(scene, target, key):
        leaves, merge = float_partition(scene)
        params = [t.detach().requires_grad_(True) for t in leaves]
        img = render_sharded(make_hit_fn, merge(params), lights, cam, cfg,
                             key, mesh)
        loss = ((img - target) ** 2).mean()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), _grad_tree(scene, grads)

    return loss_and_grad


def _grad_tree(scene, grads):
    """``scene`` with each float tensor replaced, in order, by its
    gradient and every other tensor by None."""
    it = iter(grads)
    leaves = [next(it) if t.is_floating_point() else None
              for _, t in _leaves_with_paths(scene)]
    return _rebuild(scene, iter(leaves))
