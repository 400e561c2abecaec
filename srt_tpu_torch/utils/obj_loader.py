"""Wavefront OBJ/MTL host types and the pure-Python parsers (numpy).

Counterpart of ``srt_tpu/utils/obj_loader.py``: ``MaterialDef``,
``MeshData``, ``parse_obj``, ``parse_mtl``, ``compute_vertex_normals``
and ``load_object`` carried over unchanged in behaviour (reference
``model_loader.cpp``).  The native C++ parser (``native/srt_native.cpp``)
is not carried over: it drops ``vn`` and ``Ke``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MaterialDef:
    """One MTL material (reference ``AssetUtils::Material``)."""

    diffuse: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    specular_ex: float = 0.0
    use_texture: bool = False
    texture_path: Optional[str] = None
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class MeshData:
    """Host-side packed mesh before the BVH build.

    positions: [V, 3] float32 — duplicated per face corner
    uvs:       [V, 2] float32
    tri_vidx:  [T, 3] uint32 vertex indices
    tri_mat:   [T]    uint32 material index
    materials: ordered material defs
    normals:   optional [V, 3] per-corner shading normals (zero rows fall
               back to the geometric normal)
    """

    positions: np.ndarray
    uvs: np.ndarray
    tri_vidx: np.ndarray
    tri_mat: np.ndarray
    materials: List[MaterialDef]
    name: str = "mesh"
    normals: Optional[np.ndarray] = None

    @property
    def num_triangles(self) -> int:
        return self.tri_vidx.shape[0]


def _resolve_index(raw: int, count: int) -> int:
    """OBJ 1-based (or negative-relative) index -> 0-based."""
    return raw - 1 if raw > 0 else count + raw


def parse_obj(path: str):
    """Parse an OBJ file.

    Returns (vertices [V0,3], texcoords [Vt,2], normals [Vn,3],
    sub_geometries, mtl_files) where sub_geometries is a list of
    (material_name, faces) and each face is a list of (v, vt, vn) index
    triples (vt/vn may be None).  Quads split (0,1,2)+(0,2,3), n-gons
    fan-triangulate.
    """
    vertices: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    mtl_files: List[str] = []
    sub_geos: List[Tuple[str, list]] = []
    cur_material = ""
    cur_faces: list = []

    def flush():
        nonlocal cur_faces
        if cur_material or cur_faces:
            sub_geos.append((cur_material, cur_faces))
        cur_faces = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            prefix = parts[0]
            if prefix == "v" and len(parts) >= 4:
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif prefix == "vt" and len(parts) >= 3:
                texcoords.append((float(parts[1]), float(parts[2])))
            elif prefix == "vn" and len(parts) >= 4:
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif prefix == "f":
                corners = []
                for chunk in parts[1:]:
                    fields = chunk.split("/")
                    v = _resolve_index(int(fields[0]), len(vertices))
                    vt = (
                        _resolve_index(int(fields[1]), len(texcoords))
                        if len(fields) > 1 and fields[1] else None
                    )
                    vn = (
                        _resolve_index(int(fields[2]), len(normals))
                        if len(fields) > 2 and fields[2] else None
                    )
                    corners.append((v, vt, vn))
                if len(corners) == 3:
                    cur_faces.append(corners)
                elif len(corners) == 4:
                    cur_faces.append([corners[0], corners[1], corners[2]])
                    cur_faces.append([corners[0], corners[2], corners[3]])
                elif len(corners) > 4:
                    for k in range(1, len(corners) - 1):
                        cur_faces.append([corners[0], corners[k], corners[k + 1]])
            elif prefix == "usemtl":
                if cur_material or cur_faces:
                    flush()
                cur_material = parts[1] if len(parts) > 1 else ""
            elif prefix == "mtllib":
                if len(parts) > 1:
                    mtl_files.append(parts[1])

    flush()
    return (
        np.asarray(vertices, np.float32).reshape(-1, 3),
        np.asarray(texcoords, np.float32).reshape(-1, 2),
        np.asarray(normals, np.float32).reshape(-1, 3),
        sub_geos,
        mtl_files,
    )


def parse_mtl(path: str, materials: Dict[str, MaterialDef]) -> None:
    """Parse an MTL library into ``materials``; later duplicates of a
    material name are skipped."""
    if not os.path.exists(path):
        return
    folder = os.path.dirname(path)
    current: Optional[MaterialDef] = None
    skip = False
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            prefix = parts[0]
            if prefix == "newmtl":
                name = parts[1] if len(parts) > 1 else ""
                if name in materials:
                    skip = True
                    current = None
                else:
                    skip = False
                    current = MaterialDef()
                    materials[name] = current
                continue
            if skip or current is None:
                continue
            if prefix == "Kd" and len(parts) >= 4:
                current.diffuse = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif prefix == "Ks" and len(parts) >= 4:
                current.specular = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif prefix == "Ns" and len(parts) >= 2:
                current.specular_ex = float(parts[1])
            elif prefix == "map_Kd" and len(parts) >= 2:
                current.use_texture = True
                current.texture_path = os.path.join(folder, parts[-1])
            elif prefix == "Ke" and len(parts) >= 4:
                current.emissive = (float(parts[1]), float(parts[2]),
                                    float(parts[3]))


def compute_vertex_normals(mesh: MeshData) -> MeshData:
    """Area-weighted smooth vertex normals for a mesh without ``vn``.

    Corners are duplicated per face (model_loader.cpp:296-331 layout), so
    coincident positions are re-identified by exact coordinate match and
    face normals (cross product, area-weighted) are accumulated over each
    shared position.  Returns a new MeshData with ``normals`` set."""
    p = mesh.positions
    vidx = mesh.tri_vidx.astype(np.int64)
    fn = np.cross(p[vidx[:, 1]] - p[vidx[:, 0]],
                  p[vidx[:, 2]] - p[vidx[:, 0]])        # area-weighted
    _, group = np.unique(np.asarray(p, np.float32), axis=0,
                         return_inverse=True)
    group = group.ravel()
    acc = np.zeros((group.max() + 1, 3), np.float64)
    for c in range(3):
        np.add.at(acc, group[vidx[:, c]], fn)
    n = acc[group]
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-12), 0.0)
    return dataclasses.replace(mesh, normals=n.astype(np.float32))


def load_object(obj_path: str, use_native: str = "auto") -> MeshData:
    """Load an OBJ and its MTL libraries into a packed MeshData
    (``AssetUtils::LoadObject``, model_loader.cpp:20-32, and
    ``ConvertCPUGeometryToModel``, :280-365): vertices duplicated per face
    corner (positions and uvs packed), each triangle recording (v0, v1,
    v2, material).

    ``use_native`` keeps the JAX package's values ("auto", "never"); both
    take this Python parser, since the native one is not carried over."""
    vertices, texcoords, normals_in, sub_geos, mtl_files = parse_obj(obj_path)

    folder = os.path.dirname(obj_path)
    materials: Dict[str, MaterialDef] = {}
    for mtl in mtl_files:
        parse_mtl(os.path.join(folder, mtl), materials)

    mat_names = list(materials.keys())
    mat_index = {n: i for i, n in enumerate(mat_names)}
    mat_list = [materials[n] for n in mat_names]
    if not mat_list:
        mat_list = [MaterialDef()]

    positions: List[np.ndarray] = []
    uvs: List[Tuple[float, float]] = []
    nrm: List[Tuple[float, float, float]] = []
    tri_vidx: List[Tuple[int, int, int]] = []
    tri_mat: List[int] = []
    any_vn = False

    for mat_name, faces in sub_geos:
        midx = mat_index.get(mat_name, 0)
        for face in faces:
            corner_ids = []
            for (v, vt, vn) in face:
                corner_ids.append(len(positions))
                positions.append(vertices[v])
                uvs.append(tuple(texcoords[vt]) if vt is not None
                           else (0.0, 0.0))
                if vn is not None:
                    nrm.append(tuple(normals_in[vn]))
                    any_vn = True
                else:
                    nrm.append((0.0, 0.0, 0.0))
            tri_vidx.append(tuple(corner_ids))
            tri_mat.append(midx)

    return MeshData(
        positions=np.asarray(positions, np.float32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        tri_vidx=np.asarray(tri_vidx, np.uint32).reshape(-1, 3),
        tri_mat=np.asarray(tri_mat, np.uint32),
        materials=mat_list,
        name=os.path.splitext(os.path.basename(obj_path))[0],
        normals=(np.asarray(nrm, np.float32).reshape(-1, 3)
                 if any_vn else None),
    )
