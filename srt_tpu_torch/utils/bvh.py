"""Host-side BVH construction: counterpart of ``srt_tpu/utils/bvh.py``.

Midpoint split on the longest axis, leaf at <= ``leaf_size`` primitives or
a degenerate split, stable partition, primitives reordered to match leaf
ranges, children always adjacent (left, left+1).  The same algorithm as the
JAX package's numpy builder, so the trees are identical.  ``build_bvh``
sends 1,024 or more primitives to the C++ builder (``utils/native.py``,
``csrc/srt_native.cpp``: the same trees, faster; ``chip_smoke.py``'s
phases 3 and 6 time both) when ``native.available()``, as the JAX
package does; the numpy builder stays the reference and takes the rest.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FlatBVH:
    """Flattened BVH arrays.

    node_min/node_max: [Nn, 3] float32 AABB bounds
    node_first:        [Nn] uint32 — first child (internal) or first
                       primitive (leaf), merged layout
    node_count:        [Nn] uint32 — primitive count; 0 marks internal
    prim_order:        [T] uint32 — new_prims[i] = old_prims[prim_order[i]]
    """

    node_min: np.ndarray
    node_max: np.ndarray
    node_first: np.ndarray
    node_count: np.ndarray
    prim_order: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.node_first.shape[0]


# The least primitive count that ``build_bvh(use_native="auto")`` sends to
# the C++ builder (the JAX package's).
NATIVE_MIN_PRIMS = 1024


def build_bvh(centers: np.ndarray, bounds_min: np.ndarray,
              bounds_max: np.ndarray, leaf_size: int = 2,
              use_native: str = "auto") -> FlatBVH:
    """Build a midpoint-split BVH over primitives.

    centers: [T, 3]; bounds_min/bounds_max: [T, 3] per-primitive AABBs.
    ``use_native="auto"`` takes the C++ builder at ``NATIVE_MIN_PRIMS`` or
    more primitives when ``native.available()``; "never" the numpy one.
    """
    if use_native == "auto" and centers.shape[0] >= NATIVE_MIN_PRIMS:
        from srt_tpu_torch.utils.native import build_bvh_native
        bvh = build_bvh_native(centers, bounds_min, bounds_max, leaf_size)
        if bvh is not None:
            return bvh
    t = centers.shape[0]
    if t == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    centers = np.asarray(centers, np.float32)
    bounds_min = np.asarray(bounds_min, np.float32)
    bounds_max = np.asarray(bounds_max, np.float32)

    max_nodes = 2 * t - 1
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_first = np.zeros(max_nodes, np.uint32)
    node_count = np.zeros(max_nodes, np.uint32)

    order = np.arange(t, dtype=np.uint32)
    next_free = 1
    node_first[0] = 0
    node_count[0] = t

    stack = [0]
    while stack:
        ni = stack.pop()
        first = int(node_first[ni])
        count = int(node_count[ni])
        idxs = order[first:first + count]

        node_min[ni] = bounds_min[idxs].min(axis=0)
        node_max[ni] = bounds_max[idxs].max(axis=0)

        if count <= leaf_size:
            continue

        extent = node_max[ni] - node_min[ni]
        # Longest axis; y/z win ties.
        axis = 0
        if extent[1] > extent[0]:
            axis = 1
        if extent[2] > extent[axis]:
            axis = 2
        split = node_min[ni][axis] + extent[axis] * 0.5

        left_mask = centers[idxs, axis] < split
        left_count = int(left_mask.sum())
        if left_count == 0 or left_count == count:
            continue  # degenerate split -> leaf

        order[first:first + count] = np.concatenate(
            [idxs[left_mask], idxs[~left_mask]]
        )

        li, ri = next_free, next_free + 1
        next_free += 2
        node_first[li] = first
        node_count[li] = left_count
        node_first[ri] = first + left_count
        node_count[ri] = count - left_count
        node_first[ni] = li
        node_count[ni] = 0
        stack.append(ri)
        stack.append(li)

    return FlatBVH(
        node_min=node_min[:next_free].copy(),
        node_max=node_max[:next_free].copy(),
        node_first=node_first[:next_free].copy(),
        node_count=node_count[:next_free].copy(),
        prim_order=order,
    )


def triangle_bvh(positions: np.ndarray, tri_vidx: np.ndarray,
                 leaf_size: int = 2) -> FlatBVH:
    """Build a BVH over triangles given packed vertices."""
    v0 = positions[tri_vidx[:, 0]]
    v1 = positions[tri_vidx[:, 1]]
    v2 = positions[tri_vidx[:, 2]]
    centers = (v0 + v1 + v2) / 3.0
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    return build_bvh(centers, bmin, bmax, leaf_size=leaf_size)


def bvh_depth(bvh: FlatBVH) -> int:
    """Maximum tree depth (for sizing traversal stacks)."""
    depth = np.zeros(bvh.num_nodes, np.int32)
    out = 1
    for ni in range(bvh.num_nodes):
        if bvh.node_count[ni] == 0:
            child = int(bvh.node_first[ni])
            depth[child] = depth[ni] + 1
            depth[child + 1] = depth[ni] + 1
            out = max(out, int(depth[child]) + 1)
    return out


def validate_bvh(bvh: FlatBVH, centers: np.ndarray) -> None:
    """Sanity check: every primitive appears in exactly one leaf.  Raises
    ``AssertionError`` otherwise, as the JAX package's does."""
    seen = np.zeros(len(centers), np.int32)
    for ni in range(bvh.num_nodes):
        c = int(bvh.node_count[ni])
        if c > 0:
            f = int(bvh.node_first[ni])
            for p in bvh.prim_order[f:f + c]:
                seen[p] += 1
    if not np.all(seen == 1):
        raise AssertionError("BVH leaves do not partition the primitives")
