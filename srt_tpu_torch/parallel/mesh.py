"""Device mesh construction and process-group bring-up (counterpart of
``srt_tpu/parallel/mesh.py``).

JAX's single controller sees every device in one process; here each
device is a process (a rank).  ``jax.sharding.Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` over ranks with the
dimension names ``("rays", "samples")``.  A rank's device is
``cuda:{local_rank % device_count}`` unless the caller passes
``device="cpu"``; without a card and without ``device="cpu"`` the calls
raise, as ``devices.resolve`` does.  The backend defaults to NCCL on the
card and gloo on the CPU; NCCL refuses two ranks on one card, so such a
world passes ``backend="gloo"``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

RAYS_AXIS = "rays"        # data parallel over pixels/rays
SAMPLES_AXIS = "samples"  # sample parallel over spp


def _local_rank(process_id: Optional[int] = None) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if process_id is not None:
        return int(process_id)
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None, process_id: Optional[int] = None
                ) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:{local_rank % device_count}`` (the launcher's ``LOCAL_RANK``,
    else ``process_id``, else the group rank).  Raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless "
                           "the caller passes device='cpu'")
    return torch.device("cuda", _local_rank(process_id)
                        % torch.cuda.device_count())


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout: Optional[float] = None) -> None:
    """Join this process to its world.

    A no-op when a group already exists, or for a single process with no
    launcher environment (no ``WORLD_SIZE``/``RANK``) and no
    ``coordinator``.  Otherwise ``init_process_group`` with
    ``init_method=f"tcp://{coordinator}"`` (``coordinator`` may also be a
    whole init URL, such as ``file:///path/store``), or with torchrun's
    environment when ``coordinator`` is None.  The backend defaults to
    NCCL on ``rank_device(device, process_id)`` when it is a card, gloo otherwise, which on
    the card also becomes the current device.  ``timeout`` (seconds)
    bounds the rendezvous and every collective.  Errors are not
    swallowed (unlike JAX's)."""
    if dist.is_initialized():
        return
    launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if coordinator is None and not launched:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator "
                             f"or a launcher's environment")
        return
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if coordinator is None:
        url = "env://"
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or _default_backend(dev), init_method=url,
                            **kw)


def device_mesh(n_rays_shards: Optional[int] = None,
                n_sample_shards: int = 1,
                ranks: Optional[Sequence[int]] = None,
                device=None) -> DeviceMesh:
    """A (rays, samples) ``DeviceMesh`` over the first ``n_rays_shards *
    n_sample_shards`` of ``ranks`` (default: every rank of the world), as
    JAX's takes ``devices[:use]``; ``n_rays_shards`` defaults to all of
    them on the rays axis.

    Every rank of the world calls it: it creates the process groups of
    each axis.  A rank outside the mesh gets a mesh whose
    ``get_coordinate()`` is None; the render functions refuse it
    (``ValueError``).  In a process with no group it first starts a world
    of 1 on an in-process store (no network, no file), so one process
    needs no set-up, as in JAX."""
    dev = rank_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(_default_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    ranks = (list(range(dist.get_world_size())) if ranks is None
             else [int(r) for r in ranks])
    if n_rays_shards is None:
        n_rays_shards = len(ranks) // n_sample_shards
    use = n_rays_shards * n_sample_shards
    if not 1 <= use <= len(ranks):
        raise ValueError(f"a ({n_rays_shards}, {n_sample_shards}) mesh needs "
                         f"{use} of {len(ranks)} ranks")
    grid = torch.tensor(ranks[:use]).reshape(n_rays_shards, n_sample_shards)
    return DeviceMesh(dev.type, grid, mesh_dim_names=(RAYS_AXIS,
                                                      SAMPLES_AXIS))


def _bounds_from_slices(slices, n: int) -> tuple:
    """Hull of a process's index slices; raises on non-contiguous
    ownership (an exotic device order the sharded renders do not
    support)."""
    if not slices:
        return 0, 0
    starts = [s.start or 0 for s in slices]
    stops = [n if s.stop is None else s.stop for s in slices]
    lo, hi = min(starts), max(stops)
    if sum(b - a for a, b in zip(starts, stops)) != hi - lo:
        raise ValueError(
            "process owns a non-contiguous slice of the rays axis; "
            "reorder the mesh devices process-major (parallel/mesh.py)"
        )
    return lo, hi


def local_shard_bounds(n: int, mesh: DeviceMesh,
                       process_index: Optional[int] = None) -> tuple:
    """Rows ``(lo, hi)`` of ``n`` items that rank ``process_index``
    (default: this rank) owns under rays sharding, from its coordinate on
    the rays axis; (0, 0) for a rank outside the mesh.  ``n`` must be a
    multiple of the rays axis' size."""
    rays = mesh.size(0)
    if n % rays:
        raise ValueError(f"{n} rays do not split over {rays} shards")
    pid = dist.get_rank() if process_index is None else int(process_index)
    per = n // rays
    slices = [slice(int(r) * per, (int(r) + 1) * per)
              for r, _ in (mesh.mesh == pid).nonzero().tolist()]
    return _bounds_from_slices(slices, n)
