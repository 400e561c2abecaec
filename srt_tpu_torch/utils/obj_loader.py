"""Wavefront OBJ/MTL host types and the pure-Python parsers (numpy).

Counterpart of ``srt_tpu/utils/obj_loader.py``: ``MaterialDef``,
``MeshData``, ``parse_obj`` and ``parse_mtl`` carried over unchanged in
behaviour (reference ``model_loader.cpp``).  The native C++ parser path
and ``load_object`` are not part of the port yet.
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
