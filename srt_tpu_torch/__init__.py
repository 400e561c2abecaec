"""srt_tpu_torch: the PyTorch + CUDA (Hopper) port of the srt_tpu path tracer.

The package mirrors ``srt_tpu``'s module names so each counterpart is easy
to find, but imports only ``torch`` and numpy: the machine that runs it on
the GPU has no JAX, and importing any ``srt_tpu`` module imports JAX.  The
numpy host code the render path needs (OBJ types, procedural meshes, the
BVH builder, scene flattening, Morton order, Woop tables) therefore lives
here too, unchanged in behaviour.

Entry point: ``srt_tpu_torch.models.fastpath.make_render_plan``.  On CUDA
tensors the traversal runs the hand-written kernels of
``srt_tpu_torch/csrc``; on CPU tensors it runs their plain PyTorch
versions (``srt_tpu_torch.ops.traversal``).

This file imports nothing, so ``import srt_tpu_torch.<module>`` costs only
that module's own imports.
"""
