"""Sharded rendering on ``torch.distributed`` (counterpart of
``srt_tpu/parallel``).

One process per device, joined in a process group.  Rays (pixels) shard
over the ``rays`` axis of a ``DeviceMesh``, samples replicate over the
``samples`` axis, and every rank holds the whole scene.  The gathered
image is on every rank, and scene gradients are all-reduced over the
``rays`` group: the psum that JAX's ``shard_map`` places on a replicated
input's cotangent (``render_sharded.py``).
"""

from srt_tpu_torch.parallel.mesh import RAYS_AXIS, SAMPLES_AXIS, device_mesh
from srt_tpu_torch.parallel.render_sharded import (render_sharded,
                                                   sharded_loss_and_grad,
                                                   trace_sharded)
