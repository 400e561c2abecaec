"""Multi-model scene flattening (numpy): counterpart of
``srt_tpu/utils/flatten.py``.

N models (mesh + BVH + materials) become global arrays with running
offsets: per-model node ranges and frames, BVH nodes with the merged
child/prim index fixed up, triangles with pre-gathered corners and
material offsets applied.  ``pad_to > 1`` pads each model's triangle block
with copies of its last real triangle so 128-triangle clusters never
straddle models.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from srt_tpu_torch.utils.bvh import FlatBVH, bvh_depth, triangle_bvh
from srt_tpu_torch.utils.obj_loader import MeshData
from srt_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class FlatScene:
    """Flattened multi-model scene (host numpy)."""

    model_first_node: np.ndarray  # [B] int32
    model_node_count: np.ndarray  # [B] int32
    model_first_tri: np.ndarray   # [B] int32
    model_tri_count: np.ndarray   # [B] int32
    frames: np.ndarray            # [B, 4, 4] float32 world->model
    node_min: np.ndarray          # [Nn, 3]
    node_max: np.ndarray          # [Nn, 3]
    node_first: np.ndarray        # [Nn] int32 (child idx or global tri idx)
    node_count: np.ndarray        # [Nn] int32 (0 = internal)
    tri_v0: np.ndarray            # [T, 3]
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    uv0: np.ndarray               # [T, 2]
    uv1: np.ndarray
    uv2: np.ndarray
    tri_mat: np.ndarray           # [T] int32
    tri_n0: np.ndarray            # [T, 3] shading normals (zero = geometric)
    tri_n1: np.ndarray
    tri_n2: np.ndarray
    tri_vidx: np.ndarray          # [T, 3] int32 into ``positions``
    positions: np.ndarray         # [V, 3] packed vertex buffer
    mat_diffuse: np.ndarray       # [M, 3]
    mat_specular: np.ndarray      # [M, 3]
    mat_emissive: np.ndarray      # [M, 3]
    mat_specular_ex: np.ndarray   # [M]
    mat_use_texture: np.ndarray   # [M] bool
    mat_tex_index: np.ndarray     # [M] int32 (-1 = none)
    tri_adj: np.ndarray = None    # [T, 3] int32 edge adjacency
    num_triangles: int = 0
    max_depth: int = 32

    @property
    def num_models(self) -> int:
        return self.model_first_node.shape[0]


def triangle_adjacency(vidx: np.ndarray, n_real: int,
                       positions: np.ndarray = None) -> np.ndarray:
    """Edge adjacency of one model's triangles: entry (t, k) is the local
    index of the triangle sharing edge k of t (corners k and (k+1)%3), -1
    at boundaries, padding rows and non-manifold extras.  Vertices are
    welded by exact coordinate equality when ``positions`` is given."""
    t_padded = vidx.shape[0]
    adj = np.full(3 * t_padded, -1, np.int64)
    if n_real:
        a = vidx[:n_real].astype(np.int64)
        if positions is not None:
            _, weld = np.unique(np.asarray(positions, np.float32),
                                axis=0, return_inverse=True)
            a = weld.reshape(-1).astype(np.int64)[a]
        e = np.concatenate([
            np.stack([a[:, 0], a[:, 1]], 1),
            np.stack([a[:, 1], a[:, 2]], 1),
            np.stack([a[:, 2], a[:, 0]], 1),
        ], axis=0)
        key = e.min(1) * (a.max() + 1) + e.max(1)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        pair = np.nonzero(ks[:-1] == ks[1:])[0]
        if pair.size:
            keep = np.ones(pair.size, bool)
            keep[1:] = pair[1:] != pair[:-1] + 1
            pair = pair[keep]
        ea, eb = order[pair], order[pair + 1]

        def eid(i):
            return (i // n_real) * t_padded + (i % n_real)
        adj[eid(ea)] = eb % n_real
        adj[eid(eb)] = ea % n_real
    return adj.reshape(3, t_padded).T.astype(np.int32)


def flatten_models(
    meshes: Sequence[MeshData],
    bvhs: Optional[Sequence[FlatBVH]] = None,
    frames: Optional[Sequence[np.ndarray]] = None,
    leaf_size: int = 2,
    pad_to: int = 1,
) -> FlatScene:
    """Flatten models into one FlatScene (``frames`` are world->model
    matrices, identity by default)."""
    with span("srt.setup.flatten"):
        if bvhs is None:
            bvhs = [triangle_bvh(m.positions, m.tri_vidx, leaf_size=leaf_size)
                    for m in meshes]
        if frames is None:
            frames = [np.eye(4, dtype=np.float32) for _ in meshes]

        first_nodes, node_counts, first_tris, tri_counts = [], [], [], []
        frame_list = []
        nmin, nmax, nfirst, ncount = [], [], [], []
        tv0, tv1, tv2, u0, u1, u2, tmat, tvidx = [], [], [], [], [], [], [], []
        tn0, tn1, tn2, tadj = [], [], [], []
        positions = []
        md, ms, mem, mex, mut, mti = [], [], [], [], [], []

        node_off = 0
        tri_off = 0
        mat_off = 0
        vert_off = 0
        depth = 1
        for mesh, bvh, frame in zip(meshes, bvhs, frames):
            depth = max(depth, bvh_depth(bvh))
            first_nodes.append(node_off)
            node_counts.append(bvh.num_nodes)
            first_tris.append(tri_off)
            tri_counts.append(mesh.num_triangles)
            frame_list.append(np.asarray(frame, np.float32))

            is_leaf = bvh.node_count > 0
            nfirst.append(
                np.where(is_leaf, bvh.node_first + tri_off,
                         bvh.node_first + node_off)
                .astype(np.int32)
            )
            ncount.append(bvh.node_count.astype(np.int32))
            nmin.append(bvh.node_min)
            nmax.append(bvh.node_max)

            order = bvh.prim_order
            vidx = mesh.tri_vidx[order]
            n_real = mesh.num_triangles
            n_padded = -(-n_real // pad_to) * pad_to if pad_to > 1 else n_real
            n_pad = n_padded - n_real

            def padded(arr, dtype=np.float32):
                # Copies of the last real triangle: they can tie the closest
                # hit but never change it, and keep cluster AABBs tight.
                arr = np.asarray(arr, dtype)
                if n_pad:
                    arr = np.concatenate(
                        [arr, np.repeat(arr[-1:], n_pad, axis=0)], axis=0
                    )
                return arr

            tv0.append(padded(mesh.positions[vidx[:, 0]]))
            tv1.append(padded(mesh.positions[vidx[:, 1]]))
            tv2.append(padded(mesh.positions[vidx[:, 2]]))
            u0.append(padded(mesh.uvs[vidx[:, 0]]))
            u1.append(padded(mesh.uvs[vidx[:, 1]]))
            u2.append(padded(mesh.uvs[vidx[:, 2]]))
            nsrc = mesh.normals
            if nsrc is None:
                nsrc = np.zeros_like(mesh.positions)
            tn0.append(padded(nsrc[vidx[:, 0]]))
            tn1.append(padded(nsrc[vidx[:, 1]]))
            tn2.append(padded(nsrc[vidx[:, 2]]))
            tmat.append(padded(mesh.tri_mat[order].astype(np.int64) + mat_off,
                               np.int32))
            tvidx.append(padded(vidx.astype(np.int64) + vert_off, np.int32))
            positions.append(mesh.positions)
            adj_local = triangle_adjacency(
                np.concatenate([vidx, np.repeat(vidx[-1:], n_pad, axis=0)])
                if n_pad else vidx, n_real, positions=mesh.positions)
            tadj.append(np.where(adj_local >= 0, adj_local + tri_off,
                                 -1).astype(np.int32))

            for m in mesh.materials:
                md.append(m.diffuse)
                ms.append(m.specular)
                mem.append(m.emissive)
                mex.append(m.specular_ex)
                mut.append(bool(m.use_texture))
                mti.append(-1)

            node_off += bvh.num_nodes
            tri_off += n_padded
            mat_off += len(mesh.materials)
            vert_off += mesh.positions.shape[0]

        def cat(parts, dtype=np.float32):
            return np.concatenate(parts, axis=0).astype(dtype)

        return FlatScene(
            model_first_node=np.asarray(first_nodes, np.int32),
            model_node_count=np.asarray(node_counts, np.int32),
            model_first_tri=np.asarray(first_tris, np.int32),
            model_tri_count=np.asarray(tri_counts, np.int32),
            frames=np.stack(frame_list, axis=0),
            node_min=np.concatenate(nmin).astype(np.float32),
            node_max=np.concatenate(nmax).astype(np.float32),
            node_first=np.concatenate(nfirst),
            node_count=np.concatenate(ncount),
            tri_v0=cat(tv0),
            tri_v1=cat(tv1),
            tri_v2=cat(tv2),
            uv0=cat(u0),
            uv1=cat(u1),
            uv2=cat(u2),
            tri_mat=cat(tmat, np.int32),
            tri_n0=cat(tn0),
            tri_n1=cat(tn1),
            tri_n2=cat(tn2),
            tri_vidx=cat(tvidx, np.int32),
            positions=np.concatenate(positions).astype(np.float32),
            tri_adj=cat(tadj, np.int32),
            mat_diffuse=np.asarray(md, np.float32).reshape(-1, 3),
            mat_specular=np.asarray(ms, np.float32).reshape(-1, 3),
            mat_emissive=np.asarray(mem, np.float32).reshape(-1, 3),
            mat_specular_ex=np.asarray(mex, np.float32).reshape(-1),
            mat_use_texture=np.asarray(mut, bool).reshape(-1),
            mat_tex_index=np.asarray(mti, np.int32).reshape(-1),
            num_triangles=tri_off,
            max_depth=depth,
        )


def set_frame(scene: FlatScene, model_index: int,
              matrix: np.ndarray) -> FlatScene:
    """Replace one model's world->model matrix (``UpdateModelMatrix``,
    gpu_loader.cpp:185-196).  Returns a new FlatScene (host arrays)."""
    frames = scene.frames.copy()
    frames[model_index] = np.asarray(matrix, np.float32)
    return dataclasses.replace(scene, frames=frames)
