"""Procedural meshes (numpy): counterpart of ``srt_tpu/utils/procgen.py``.

``uv_sphere(160, 320, radius=2.0)`` is the 101,760-triangle headline
scene; ``rubik_grid`` stands in for the Rubik OBJ fixture (config3);
``cube`` and small spheres are test fixtures; ``write_obj`` writes a mesh
as OBJ + MTL.  Same vertex order, corner duplication, materials and file
text as the JAX package, so both packages flatten to identical tables.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from srt_tpu_torch.utils.obj_loader import MaterialDef, MeshData


def _mesh_from_quads(verts: np.ndarray, quads: List[Tuple[int, int, int, int]],
                     mat_per_face: List[int], materials: List[MaterialDef],
                     name: str) -> MeshData:
    """Split quads (0,1,2)+(0,2,3) and duplicate vertices per corner."""
    positions, uvs, tri_vidx, tri_mat = [], [], [], []
    for (a, b, c, d), m in zip(quads, mat_per_face):
        for tri in ((a, b, c), (a, c, d)):
            base = len(positions)
            for vi in tri:
                positions.append(verts[vi])
                uvs.append((0.0, 0.0))
            tri_vidx.append((base, base + 1, base + 2))
            tri_mat.append(m)
    return MeshData(
        positions=np.asarray(positions, np.float32),
        uvs=np.asarray(uvs, np.float32),
        tri_vidx=np.asarray(tri_vidx, np.uint32),
        tri_mat=np.asarray(tri_mat, np.uint32),
        materials=materials,
        name=name,
    )


def cube(size: float = 1.0, center=(0.0, 0.0, 0.0),
         material: MaterialDef = None) -> MeshData:
    """Axis-aligned cube: 8 verts, 6 quads -> 12 triangles."""
    s = size / 2.0
    c = np.asarray(center, np.float32)
    verts = np.asarray(
        [
            (-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s),
            (-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s),
        ],
        np.float32,
    ) + c
    quads = [
        (0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7),
        (1, 5, 6, 2), (3, 2, 6, 7), (4, 5, 1, 0),
    ]
    mat = material or MaterialDef(diffuse=(0.8, 0.8, 0.8), specular=(0.5, 0.5, 0.5),
                                  specular_ex=32.0)
    return _mesh_from_quads(verts, quads, [0] * 6, [mat], "cube")


def rubik_grid(spacing: float = 1.05, size: float = 1.0) -> MeshData:
    """3x3x3 grid of cubes (324 triangles), one material per axis layer:
    a stand-in workload shaped like the Rubik fixture."""
    positions, uvs, tri_vidx, tri_mat = [], [], [], []
    mats = [
        MaterialDef(diffuse=(0.9, 0.1, 0.1), specular=(0.6, 0.6, 0.6), specular_ex=64.0),
        MaterialDef(diffuse=(0.1, 0.9, 0.1), specular=(0.6, 0.6, 0.6), specular_ex=64.0),
        MaterialDef(diffuse=(0.1, 0.1, 0.9), specular=(0.6, 0.6, 0.6), specular_ex=64.0),
    ]
    for gx in range(3):
        for gy in range(3):
            for gz in range(3):
                sub = cube(size, ((gx - 1) * spacing, (gy - 1) * spacing,
                                  (gz - 1) * spacing))
                base = len(positions)
                positions.extend(sub.positions)
                uvs.extend(sub.uvs)
                tri_vidx.extend((sub.tri_vidx + base).tolist())
                tri_mat.extend([gx % 3] * sub.num_triangles)
    return MeshData(
        positions=np.asarray(positions, np.float32),
        uvs=np.asarray(uvs, np.float32),
        tri_vidx=np.asarray(tri_vidx, np.uint32),
        tri_mat=np.asarray(tri_mat, np.uint32),
        materials=mats,
        name="rubik_grid",
    )


def uv_sphere(rows: int, cols: int, radius: float = 1.0,
              center=(0.0, 0.0, 0.0), material: MaterialDef = None) -> MeshData:
    """UV sphere with ~2*rows*cols triangles and spherical UVs."""
    c = np.asarray(center, np.float32)
    mat = material or MaterialDef(diffuse=(0.7, 0.7, 0.75),
                                  specular=(0.8, 0.8, 0.8), specular_ex=96.0)
    positions, uvs, tri_vidx, tri_mat = [], [], [], []

    def pt(r, s):
        theta = np.pi * r / rows
        phi = 2 * np.pi * s / cols
        return c + radius * np.asarray(
            [np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)],
            np.float32,
        )

    def uv(r, s):
        return (s / cols, 1.0 - r / rows)

    for r in range(rows):
        for s in range(cols):
            quad = [(r, s), (r + 1, s), (r + 1, s + 1), (r, s + 1)]
            tris = []
            if r > 0:
                tris.append((quad[0], quad[1], quad[2]))
            if r < rows - 1:
                tris.append((quad[0], quad[2], quad[3]))
            for tri in tris:
                base = len(positions)
                for (rr, ss) in tri:
                    positions.append(pt(rr, ss))
                    uvs.append(uv(rr, ss))
                tri_vidx.append((base, base + 1, base + 2))
                tri_mat.append(0)

    return MeshData(
        positions=np.asarray(positions, np.float32),
        uvs=np.asarray(uvs, np.float32),
        tri_vidx=np.asarray(tri_vidx, np.uint32),
        tri_mat=np.asarray(tri_mat, np.uint32),
        materials=[mat],
        name=f"uv_sphere_{rows}x{cols}",
    )


def write_obj(path: str, mesh: MeshData, mtl_name: str = None) -> None:
    """Write MeshData as OBJ, with its MTL beside it."""
    import os

    mtl_name = mtl_name or mesh.name + ".mtl"
    mat_names = [f"mat{i}" for i in range(len(mesh.materials))]
    with open(os.path.join(os.path.dirname(path), mtl_name), "w") as f:
        for name, m in zip(mat_names, mesh.materials):
            f.write(f"newmtl {name}\n")
            f.write("Kd %g %g %g\n" % tuple(m.diffuse))
            f.write("Ks %g %g %g\n" % tuple(m.specular))
            f.write("Ns %g\n" % m.specular_ex)
            if m.use_texture and m.texture_path:
                f.write("map_Kd %s\n" % os.path.basename(m.texture_path))
    with open(path, "w") as f:
        f.write(f"mtllib {mtl_name}\n")
        for p in mesh.positions:
            f.write("v %g %g %g\n" % tuple(p))
        for t in mesh.uvs:
            f.write("vt %g %g\n" % tuple(t))
        current = -1
        for (a, b, c), m in zip(mesh.tri_vidx, mesh.tri_mat):
            if m != current:
                f.write(f"usemtl {mat_names[m]}\n")
                current = m
            f.write("f %d/%d %d/%d %d/%d\n" % (a + 1, a + 1, b + 1, b + 1,
                                               c + 1, c + 1))
