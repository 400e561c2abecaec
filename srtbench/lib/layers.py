"""Predicates over traced device operations (``lib/trace.Op``) that the
per-layer metrics share (frozen).

The walk kernels are picked out by their names in the port's ``csrc``
(``WALK_KERNELS``), whatever launches them.  Every other kernel is the
bounce step's (``elementwise``), and copies and sets are their own
(``is_copy``), so the three add up to the traced device time."""

import re

WALK = "srtbench.walk"
CAPTURE = "srtbench.capture"
BACKWARD = "autograd::engine::evaluate_function"

# The walk kernels of the port's csrc (B1-B7 with their helpers), by name.
WALK_KERNELS = frozenset({
    "cull_kernel", "intersect_kernel", "cull_pg2_kernel", "pgwalk2_kernel",
    "pgwalk2_merge", "cull_perray_kernel", "cull_gmask_kernel",
    "pgwalk_kernel", "pgwalk_count", "pgwalk_plan", "pgwalk_merge"})
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def in_span(op, prefix: str) -> bool:
    return any(name.startswith(prefix) for name in op.ctx)


def is_kernel(op) -> bool:
    return op.cat == "kernel"


def is_copy(op) -> bool:
    return op.cat in ("gpu_memcpy", "gpu_memset")


def kernel_name(name: str) -> str:
    """The function's own name in a kernel's demangled signature
    (``void intersect_kernel<false>(int const*, ...)`` -> ``intersect_kernel``):
    the last identifier before the template arguments or parameters."""
    name = name.replace("(anonymous namespace)", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0]
    idents = _IDENT.findall(head)
    return idents[-1] if idents else ""


def walk_kernel(op) -> bool:
    """A walk kernel of the port's csrc, by name."""
    return is_kernel(op) and kernel_name(op.name) in WALK_KERNELS


def elementwise(op) -> bool:
    """Any other kernel: the bounce step's PyTorch operations, sorts,
    gathers and compaction, and the uniforms."""
    return is_kernel(op) and not walk_kernel(op)


def per_step(trace, keep) -> float:
    return trace.device_ms(keep) / trace.n_steps
