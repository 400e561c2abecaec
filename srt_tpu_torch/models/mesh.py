"""Triangle-mesh scenes: device tables, traversal strategies, shading
hookup (counterpart of ``srt_tpu/models/mesh.py``).

Traversal methods:

* ``"walk"`` — the walk schedule of ``ops/traversal.model_hit``: the CUDA
  kernels on CUDA tensors, their plain versions on CPU tensors.  The
  port's default on both devices.
* ``"dense"`` — every ray against every triangle (Moller-Trumbore, in ray
  chunks): the independent traversal baseline.
* ``"bvh"`` — the reference's per-ray stack walk of the BVH
  (``_bvh_traverse``), plain PyTorch on the scene's device: a validation
  route.  ``refit_accel`` leaves the node bounds stale, and the route
  then refuses the scene.

Gradients flow through the hit record to ``mat_diffuse`` and the other
material rows, the vertices (``tri_v0/v1/v2``, or a shared ``positions``
buffer through ``with_positions``), ``frames`` and the rays.  The walk
is a candidate search outside the autograd graph; the exact refine of
its winner is where its hits depend on them.  ``refit_accel`` rebuilds
the walk tables after vertices move.  The record gather and the table
gathers that feed it go through ``ops/gather.gather_rows``, whose backward
sums the duplicated rows (every missed ray reads row 0) with a kernel.

Textured scenes: ``upload(atlas=...)`` keeps a packed atlas, its rects,
its mip rects and (``quad_pack``) the quad table on the scene's device;
the hit record's albedo is then a bilinear or trilinear fetch at the
winner's interpolated UV, its mip level chosen from the hit distance or,
with ``cone=(width, spread)`` from ``RenderConfig.ray_cones``, from the
ray cone's footprint (``_mip_lod``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models.pathtracer import Hit
from srt_tpu_torch.ops import intersect, traversal, vec
from srt_tpu_torch.ops.gather import gather_rows
from srt_tpu_torch.ops.safemath import maximum
from srt_tpu_torch.ops.texture import sample_atlas
from srt_tpu_torch.scene import Materials
from srt_tpu_torch.utils.atlas import build_quad_table
from srt_tpu_torch.utils.flatten import FlatScene, flatten_models
from srt_tpu_torch.utils.obj_loader import load_object

MISS = -1
# ``TriangleToSupportedMat`` constants (raytrace_utils.glsl:169-173).
MESH_METALNESS = 0.1
ROUGHNESS_EPS = 1e-7
# Rays x triangles per dense-strategy chunk.
DENSE_CHUNK = 1 << 22

ARRAY_FIELDS = (
    "frames", "node_min", "node_max", "node_first", "node_count",
    "tri_v0", "tri_v1", "tri_v2", "uv0", "uv1", "uv2", "tri_mat",
    "tri_n0", "tri_n1", "tri_n2", "mat_diffuse", "mat_specular",
    "mat_emissive", "mat_specular_ex", "mat_use_texture", "mat_tex_index",
    "atlas", "atlas_rects", "atlas_mip_rects", "atlas_quad", "woop",
    "cluster_min", "cluster_max", "tri_vidx", "positions", "tri_adj",
)
STATIC_FIELDS = (
    "mip_lod_scale", "model_first_node", "model_first_tri",
    "model_tri_count", "model_padded_tri_count", "num_triangles",
    "stack_depth", "max_leaf", "stale_node_bounds",
)


@dataclasses.dataclass(frozen=True)
class MeshScene:
    """Device-resident flattened multi-model scene; the field names and
    layouts are those of the JAX ``MeshScene`` (``woop`` is the walk
    kernels' [C, 16, 128] table, ``cluster_min``/``max`` [C, 3])."""

    frames: torch.Tensor       # [B, 4, 4] world->model
    node_min: torch.Tensor     # [Nn, 3]
    node_max: torch.Tensor
    node_first: torch.Tensor   # [Nn] int32
    node_count: torch.Tensor   # [Nn] int32
    tri_v0: torch.Tensor       # [T, 3]
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    uv0: torch.Tensor          # [T, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    tri_mat: torch.Tensor      # [T] int32
    tri_n0: torch.Tensor       # [T, 3] shading normals (zero = geometric)
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    mat_diffuse: torch.Tensor  # [M, 3]
    mat_specular: torch.Tensor
    mat_emissive: torch.Tensor
    mat_specular_ex: torch.Tensor  # [M]
    mat_use_texture: torch.Tensor  # [M] bool
    mat_tex_index: torch.Tensor    # [M] int32
    atlas: Optional[torch.Tensor] = None            # [H, W, 3] or None
    atlas_rects: Optional[torch.Tensor] = None      # [K, 4] (x, y, w, h)
    atlas_mip_rects: Optional[torch.Tensor] = None  # [K, L, 4]
    # [H*W, 12] quad table (utils/atlas.build_quad_table): one row gather
    # per bilinear fetch; None when differentiating with respect to texels.
    atlas_quad: Optional[torch.Tensor] = None
    woop: Optional[torch.Tensor] = None
    cluster_min: Optional[torch.Tensor] = None
    cluster_max: Optional[torch.Tensor] = None
    tri_vidx: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None
    tri_adj: Optional[torch.Tensor] = None
    mip_lod_scale: float = 0.0
    model_first_node: tuple = (0,)
    model_first_tri: tuple = (0,)
    model_tri_count: tuple = (0,)
    model_padded_tri_count: tuple = (0,)
    num_triangles: int = 0
    stack_depth: int = 34
    max_leaf: int = 2
    stale_node_bounds: bool = False

    @property
    def num_models(self) -> int:
        return len(self.model_first_node)

    @property
    def device(self) -> torch.device:
        return self.frames.device


def upload(scene: FlatScene, device=None, atlas=None, atlas_rects=None,
           atlas_mip_rects=None, mip_lod_scale: float = 0.0,
           quad_pack: bool = True) -> MeshScene:
    """Host FlatScene -> MeshScene on ``device`` (None: the card,
    ``devices.resolve``).  A cluster-aligned scene (flatten_models
    pad_to=128) also gets the walk tables: the Woop table [C, 16, 128] and
    the cluster AABBs.

    ``atlas`` [H, W, 3], ``atlas_rects`` [K, 4] and ``atlas_mip_rects``
    [K, L, 4] (``utils/atlas.pack_atlas``) texture the materials with
    ``mat_use_texture``; ``mip_lod_scale`` > 0 turns on the mip LOD
    (``_mip_lod``).  ``quad_pack`` also builds the quad table on the host;
    pass False to differentiate with respect to the atlas texels."""
    device = resolve(device)
    t_total = scene.tri_v0.shape[0]
    firsts = [int(x) for x in scene.model_first_tri]
    padded_counts = tuple(
        (firsts[i + 1] if i + 1 < len(firsts) else t_total) - firsts[i]
        for i in range(len(firsts)))

    arrays = {f: getattr(scene, f) for f in ARRAY_FIELDS
              if f not in ("woop", "cluster_min", "cluster_max", "atlas",
                           "atlas_rects", "atlas_mip_rects", "atlas_quad")}
    # float32 and int32, as ``jnp.asarray`` makes them in the JAX package.
    arrays.update({f: None if x is None else np.asarray(x, dt)
                   for f, x, dt in (("atlas", atlas, np.float32),
                                    ("atlas_rects", atlas_rects, np.int32),
                                    ("atlas_mip_rects", atlas_mip_rects,
                                     np.int32))})
    if quad_pack and atlas is not None and atlas_rects is not None:
        arrays["atlas_quad"] = build_quad_table(
            np.asarray(atlas), np.asarray(atlas_rects),
            None if atlas_mip_rects is None
            else np.asarray(atlas_mip_rects))
    cl = traversal.CLUSTER
    if t_total > 0 and t_total % cl == 0 and all(
            c % cl == 0 for c in padded_counts):
        w = traversal.build_woop(scene.tri_v0, scene.tri_v1, scene.tri_v2)
        w16 = np.zeros((16, t_total), np.float32)
        w16[:13] = w
        arrays["woop"] = w16.reshape(16, t_total // cl, cl).transpose(
            1, 0, 2).copy()
        arrays["cluster_min"], arrays["cluster_max"] = \
            traversal.build_clusters(scene.tri_v0, scene.tri_v1,
                                     scene.tri_v2)
    static = dict(
        mip_lod_scale=float(mip_lod_scale),
        model_first_node=tuple(int(x) for x in scene.model_first_node),
        model_first_tri=tuple(firsts),
        model_tri_count=tuple(int(x) for x in scene.model_tri_count),
        model_padded_tri_count=padded_counts,
        num_triangles=int(scene.num_triangles),
        stack_depth=int(scene.max_depth) + 2,
        max_leaf=int(scene.node_count.max()),
    )
    return scene_from_arrays(arrays, static, device)


def scene_from_arrays(d: dict, static: dict, device) -> MeshScene:
    """Build a MeshScene from numpy arrays keyed by field name (for example
    ``np.asarray`` of each leaf of a JAX ``MeshScene``) and its static
    fields.  Missing or None optional fields stay None."""
    arrays = {}
    for f in ARRAY_FIELDS:
        x = d.get(f)
        arrays[f] = None if x is None else torch.tensor(
            np.asarray(x), device=device)
    return MeshScene(**arrays, **{k: static[k] for k in STATIC_FIELDS
                                  if k in static})


def with_positions(scene: MeshScene, positions) -> MeshScene:
    """Re-gather the per-corner vertex arrays ``tri_v0/v1/v2`` from a
    shared vertex buffer ``positions`` [V, 3] through ``tri_vidx``: the
    differentiable-geometry entry point.  The gather's backward
    scatter-adds each corner's gradient into its shared vertex (padding
    triangles alias real vertices, so theirs land there too).

    The walk tables (``woop``, cluster boxes) stay those of the uploaded
    geometry; after an optimizer step moves vertices, ``refit_accel``
    rebuilds them.  Shading normals are not re-derived."""
    vidx = scene.tri_vidx.long()
    return dataclasses.replace(
        scene, positions=positions,
        tri_v0=gather_rows(positions, vidx[:, 0]),
        tri_v1=gather_rows(positions, vidx[:, 1]),
        tri_v2=gather_rows(positions, vidx[:, 2]))


def refit_accel(scene: MeshScene) -> MeshScene:
    """Rebuild the walk tables (the Woop table [C, 16, 128] and the cluster
    boxes) from the scene's current ``tri_v0/v1/v2``, in float32 torch on
    the scene's device (no host round trip: it runs between optimizer
    steps).  As in the JAX package: a determinant threshold of 1e-12 (the
    host build's float64 uses 1e-18; near-singular inverses overflow
    float32, and such slivers never win a closest hit) and row 12 =
    ``MT_PARALLEL_EPS / |n|^2`` (inf for a singular triangle).  The tables
    are built from detached vertices (kernel operands carry no history).
    BVH node bounds are not refit: the result is flagged
    ``stale_node_bounds``.  A scene without walk tables is returned as
    it is."""
    if scene.woop is None:
        return scene
    v0, v1, v2 = (x.detach() for x in (scene.tri_v0, scene.tri_v1,
                                       scene.tri_v2))
    e1 = v1 - v0
    e2 = v2 - v0
    nrm = torch.linalg.cross(e1, e2)
    a = torch.stack([e1, e2, nrm], dim=-1)                # [T, 3, 3]
    ok = torch.linalg.det(a).abs() > 1e-12
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    a_inv = torch.linalg.inv(torch.where(ok[:, None, None], a, eye))
    trans = -torch.einsum("tij,tj->ti", a_inv, v0)
    rows = [a_inv[:, r // 4, r % 4] if r % 4 < 3 else trans[:, r // 4]
            for r in range(12)]
    n2 = (nrm * nrm).sum(1)
    eps = torch.where(ok, intersect.MT_PARALLEL_EPS
                      / torch.clamp_min(n2, 1e-30),
                      torch.full_like(n2, float("inf")))
    t_count = v0.shape[0]
    w16 = torch.zeros((16, t_count), dtype=torch.float32, device=v0.device)
    w16[:13] = torch.stack(rows + [eps])
    c_total = t_count // traversal.CLUSTER
    woop = w16.view(16, c_total, traversal.CLUSTER).transpose(0, 1)

    def chunk(x):
        return x.view(c_total, traversal.CLUSTER, 3)

    cmin = torch.minimum(torch.minimum(chunk(v0).amin(1), chunk(v1).amin(1)),
                         chunk(v2).amin(1))
    cmax = torch.maximum(torch.maximum(chunk(v0).amax(1), chunk(v1).amax(1)),
                         chunk(v2).amax(1))
    return dataclasses.replace(scene, woop=woop.contiguous(),
                               cluster_min=cmin, cluster_max=cmax,
                               stale_node_bounds=True)


def transform_rays(frame, origins, dirs):
    """World ray -> model space: origin as a point, direction as a vector
    (no normalize).  origins/dirs: [3, N]."""
    rot = frame[:3, :3]
    return rot @ origins + frame[:3, 3][:, None], rot @ dirs


def _dense_model_hit(scene: MeshScene, b: int, origins, dirs, t_best):
    """All-triangles sweep for model ``b`` in ray chunks; returns (t,
    tri_idx, u, v) with t = inf and an arbitrary index on a miss."""
    lo = scene.model_first_tri[b]
    hi = lo + scene.model_tri_count[b]
    o_m, d_m = transform_rays(scene.frames[b], origins, dirs)
    n = origins.shape[1]
    t_best = torch.as_tensor(t_best, dtype=torch.float32,
                             device=origins.device).expand(n)
    v0, v1, v2 = scene.tri_v0[lo:hi], scene.tri_v1[lo:hi], scene.tri_v2[lo:hi]
    step = max(1, DENSE_CHUNK // max(1, hi - lo))
    outs = []
    for r0 in range(0, n, step):
        t_all, u_all, v_all = intersect.moller_trumbore(
            o_m[:, r0:r0 + step].T, d_m[:, r0:r0 + step].T, v0, v1, v2)
        t_all = torch.where(t_all < t_best[r0:r0 + step, None], t_all,
                            torch.full_like(t_all, float("inf")))
        k = torch.argmin(t_all, dim=1, keepdim=True)
        outs.append((t_all.gather(1, k)[:, 0], (k[:, 0] + lo).to(torch.int32),
                     u_all.gather(1, k)[:, 0], v_all.gather(1, k)[:, 0]))
    return tuple(torch.cat(x) for x in zip(*outs))


def _bvh_traverse(scene: MeshScene, root: int, o, d, t_init):
    """Every ray through one model's BVH from node ``root``: ``Intersects``
    (ray_intersects.glsl:99-133), the JAX package's per-ray
    ``lax.while_loop`` run for all rays at once.  o/d [N, 3] model-space
    rays, ``t_init`` [N] the running bound; returns (t, tri_idx, u, v) [N],
    (t_init, -1, 0, 0) where the ray hits nothing nearer.

    Each ray keeps its own stack ([N, stack_depth]) and stack pointer
    ([N]); a ray whose stack is empty takes no more steps.  One step pops
    a node, enters it when its slab distance is finite and below the
    ray's closest t, tests a leaf's triangles (``max_leaf`` slots masked
    by the leaf's count, in one batch; a strict ``t < best_t``) and
    pushes an inner node's children, right first so the left is popped
    first (the second push clamped to the stack's last slot, as in JAX).
    Ties go to the first triangle visited.  The loop ends when every
    stack is empty, which costs one read of the device per step."""
    n = o.shape[0]
    dev = o.device
    depth = scene.stack_depth
    n_tri = scene.tri_v0.shape[0]
    rows = torch.arange(n, device=dev)
    stack = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    stack[:, 0] = root
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t = t_init
    best_i = torch.full((n,), MISS, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    node_first = scene.node_first.long()
    node_count = scene.node_count.long()
    slots = torch.arange(scene.max_leaf, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    while bool((sp > 0).any()):
        active = sp > 0
        top = torch.clamp_min(sp - 1, 0)
        ni = stack[rows, top]
        dist = intersect.ray_aabb(o, d, scene.node_min[ni],
                                  scene.node_max[ni])
        enter = active & (dist < best_t) & torch.isfinite(dist)
        first = node_first[ni]
        count = node_count[ni]
        is_leaf = count > 0
        # A leaf's triangles, all max_leaf slots at once: the first of the
        # smallest t below the ray's best is the winner of JAX's unrolled
        # loop with its strict t < best_t.  Slots past the leaf's count
        # read a clamped row, as JAX's gather clamps, and are masked out.
        idx = first[:, None] + slots[None, :]
        valid = (enter & is_leaf)[:, None] & (slots[None, :] < count[:, None])
        g = torch.clamp(idx, 0, n_tri - 1)
        t, u, v = intersect.mt_hits(o[:, None, :], d[:, None, :],
                                    scene.tri_v0[g], scene.tri_v1[g],
                                    scene.tri_v2[g])
        t = torch.where(valid & (t < best_t[:, None]), t, inf)
        k = torch.argmin(t, dim=1, keepdim=True)
        t = t.gather(1, k)[:, 0]
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, idx.gather(1, k)[:, 0].to(torch.int32),
                             best_i)
        best_u = torch.where(better, u.gather(1, k)[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, k)[:, 0], best_v)
        push = enter & ~is_leaf
        stack[rows, top] = torch.where(push, first + 1, stack[rows, top])
        nxt = torch.clamp_max(top + 1, depth - 1)
        stack[rows, nxt] = torch.where(push, first, stack[rows, nxt])
        sp = torch.where(active, torch.where(push, top + 2, top), sp)
    return best_t, best_i, best_u, best_v


def _bvh_model_hit(scene: MeshScene, b: int, origins, dirs, t_best):
    """Model ``b`` through its BVH (``_bvh_traverse``); origins/dirs
    [3, N].  Plain PyTorch on the scene's device: in JAX this route is XLA
    code, not a kernel.  Refuses a scene whose node bounds are stale
    (``refit_accel``)."""
    if scene.stale_node_bounds:
        raise ValueError(
            "scene was refit_accel'd after a vertex update: BVH node "
            "bounds are stale (refit_accel only rebuilds the walk "
            "tables). Use method='dense'/'walk', or re-upload the scene.")
    o_m, d_m = transform_rays(scene.frames[b], origins, dirs)
    n = origins.shape[1]
    t_best = torch.as_tensor(t_best, dtype=torch.float32,
                             device=origins.device).expand(n)
    return _bvh_traverse(scene, scene.model_first_node[b], o_m.T, d_m.T,
                         t_best)


def _tri_record(scene: MeshScene) -> torch.Tensor:
    """Everything shading needs per triangle, one [T, 36] table: v0 v1 v2
    (0-8), uv0 uv1 uv2 (9-14), Kd (15-17), Ks (18-20), Ns (21), use_tex
    (22), tex_idx (23), Ke (24-26), shading normals n0 n1 n2 (27-35)."""
    m = scene.tri_mat.long()
    return torch.cat([
        scene.tri_v0, scene.tri_v1, scene.tri_v2,
        scene.uv0, scene.uv1, scene.uv2,
        gather_rows(scene.mat_diffuse, m), gather_rows(scene.mat_specular, m),
        scene.mat_specular_ex[m][:, None],
        scene.mat_use_texture[m][:, None].to(torch.float32),
        scene.mat_tex_index[m][:, None].to(torch.float32),
        gather_rows(scene.mat_emissive, m),
        scene.tri_n0, scene.tri_n1, scene.tri_n2,
    ], dim=1)


def _mip_lod(scene: MeshScene, t, cone=None):
    """Mip level [N] of hits at distance ``t`` [N]; None when the scene has
    no mips or ``mip_lod_scale`` is 0.

    Without a cone: log2(t * scale), the distance heuristic.  With a ray
    ``cone`` (width at the origin [N], spread [N]; RenderConfig.ray_cones)
    the footprint at the hit is width + t * spread, and ``mip_lod_scale``
    is texels per world unit (the GL analog: derivative-driven mipmapped
    samplers, gpu_texture.h:39-53)."""
    if scene.atlas_mip_rects is None or scene.mip_lod_scale <= 0.0:
        return None
    if cone is not None:
        width, spread = cone
        fp = width + t * spread
        return torch.log2(maximum(fp * scene.mip_lod_scale, 1.0))
    return torch.log2(maximum(t * scene.mip_lod_scale, 1.0))


def _albedo(scene: MeshScene, kd, use_tex, tex_index, uv, t, cone):
    """Kd [N, 3], or the atlas fetch at ``uv`` [N, 2] where ``use_tex``
    [N] (trilinear through the mips when ``t`` is given and the scene has
    them)."""
    if scene.atlas is None:
        return kd
    lod = None if t is None else _mip_lod(scene, t, cone=cone)
    tex_rgb = sample_atlas(scene.atlas, scene.atlas_rects, tex_index, uv,
                           mip_rects=scene.atlas_mip_rects, lod=lod,
                           quad=scene.atlas_quad)
    return torch.where(use_tex[:, None], tex_rgb, kd)


def triangle_material(scene: MeshScene, tri_idx, u, v, t=None,
                      cone=None) -> Materials:
    """OBJ material -> shading material (``TriangleToSupportedMat``,
    raytrace_utils.glsl:140-175) of triangles ``tri_idx`` [N] at
    barycentrics (u, v): the textured albedo at the interpolated UV, else
    Kd; roughness 1/(Ns + eps); metalness 0.1; use_spec true.  Per-ray
    fields are [N, 3] / [N], as in the JAX package."""
    ti = tri_idx.long()
    midx = scene.tri_mat[ti].long()
    albedo = scene.mat_diffuse[midx]
    if scene.atlas is not None:
        uv = ((1.0 - u - v)[:, None] * scene.uv0[ti]
              + u[:, None] * scene.uv1[ti]
              + v[:, None] * scene.uv2[ti])
        albedo = _albedo(scene, albedo, scene.mat_use_texture[midx],
                         scene.mat_tex_index[midx], uv, t, cone)
    n = ti.shape[0]
    dev = ti.device
    return Materials(
        albedo=albedo,
        specular=scene.mat_specular[midx],
        roughness=1.0 / (scene.mat_specular_ex[midx] + ROUGHNESS_EPS),
        metalness=torch.full((n,), MESH_METALNESS, dtype=torch.float32,
                             device=dev),
        use_spec=torch.ones((n,), dtype=torch.bool, device=dev),
    )


def _record_material(scene: MeshScene, rec_t, u, v, t=None,
                     cone=None) -> Materials:
    """``TriangleToSupportedMat`` (raytrace_utils.glsl:140-175) from the
    packed record [36, N]: Kd albedo, or the atlas fetch at the UV
    interpolated at barycentrics (u, v) for textured materials (mip level
    from ``t`` and ``cone``, ``_mip_lod``); roughness 1/(Ns + eps),
    metalness 0.1, use_spec true."""
    albedo = rec_t[15:18]
    if scene.atlas is not None:
        uv = ((1.0 - u - v)[None, :] * rec_t[9:11]
              + u[None, :] * rec_t[11:13]
              + v[None, :] * rec_t[13:15])
        albedo = _albedo(scene, albedo.T, rec_t[22] > 0.5,
                         rec_t[23].to(torch.int32), uv.T, t, cone).T
    n = rec_t.shape[1]
    dev = rec_t.device
    return Materials(
        albedo=albedo,
        specular=rec_t[18:21],
        roughness=1.0 / (rec_t[21] + ROUGHNESS_EPS),
        metalness=torch.full((n,), MESH_METALNESS, dtype=torch.float32,
                             device=dev),
        use_spec=torch.ones((n,), dtype=torch.bool, device=dev),
    )


def n_superclusters(scene: MeshScene) -> int:
    """Superclusters of the walk tables (1 for a scene without them)."""
    if scene.woop is None:
        return 1
    return -(-scene.woop.shape[0] // traversal.SUPER)


def default_kernel_tile(scene: MeshScene) -> int:
    """The tiled walk's rays per tile when a schedule names none: 128
    above eight superclusters, else 512."""
    return 128 if n_superclusters(scene) > 8 else traversal.DEFAULT_TILE


def _cat_hits(parts):
    """Concatenate per-chunk ``Hit`` records along the ray axis."""
    def cat(xs):
        return None if xs[0] is None else torch.cat(xs, dim=-1)

    mats = [h.mat for h in parts]
    return Hit(**{
        f.name: cat([getattr(h, f.name) for h in parts])
        for f in dataclasses.fields(Hit) if f.name != "mat"},
        mat=Materials(**{f.name: cat([getattr(m, f.name) for m in mats])
                         for f in dataclasses.fields(Materials)}))


def mesh_hit_fn(scene: MeshScene, method: str = "walk",
                flip_normals: bool = True, ray_tile: int = 0,
                kernel_tile: int = 0, binned=False, binned_anyhit=None,
                plain: bool = False):
    """The integrator's closest-hit callable ``hit_fn(origins, dirs, t_min,
    t_max, any_hit=False, cone=None) -> Hit`` for a mesh scene: per-model
    frame transform, traversal bounded by the running closest t across
    models, exact Moller-Trumbore refine of the winner, smooth-normal
    blend, the normal flipped to face the ray (``flip_normals``; False
    keeps the interpolated normal as it is), and the winning triangle's
    material (textured where the scene has an atlas; ``cone`` = (width,
    spread) [N] each picks the mip level from the ray cone's footprint).
    ``method`` is ``"walk"``, ``"dense"`` or ``"bvh"`` (module docstring).

    ``ray_tile > 0`` traces the rays in chunks of that many, one after the
    other (it bounds the dense sweep's working set); the result is the
    same bit for bit.  The walk ignores it: its kernels tile rays
    themselves.
    ``kernel_tile`` is the tiled walk's rays per tile (0:
    ``default_kernel_tile``); ``binned`` selects the closest-hit walk
    (False = tiled, True = pair-binned, ``"pg"`` = mask-scan,
    ``"pg2:G:W"`` = per-group; ``traversal.model_hit``) and
    ``binned_anyhit`` the shadow-ray walk (None = same).  ``plain`` runs the kernels' plain
    versions on CUDA tensors (comparison runs only).
    """
    if method == "walk":
        if scene.woop is None:
            raise ValueError("the walk needs flatten_models(..., pad_to=128)")
        kernel_tile = kernel_tile or default_kernel_tile(scene)
        model_hit = functools.partial(traversal.model_hit, tile=kernel_tile,
                                      binned=binned, plain=plain)
        model_hit_any = functools.partial(
            traversal.model_hit, tile=kernel_tile,
            binned=binned if binned_anyhit is None else binned_anyhit,
            plain=plain)
        ray_tile = 0  # the kernel tiles rays itself
    elif method == "dense":
        model_hit = _dense_model_hit
    elif method == "bvh":
        model_hit = _bvh_model_hit
    else:
        raise ValueError(f"unknown traversal method: {method}")
    record = _tri_record(scene)

    def hit_fn(origins, dirs, t_min, t_max, any_hit=False, cone=None):
        n = origins.shape[1]
        dev = origins.device
        best_t = torch.as_tensor(t_max, dtype=torch.float32,
                                 device=dev).expand(n).clone()
        best_i = torch.full((n,), MISS, dtype=torch.int32, device=dev)
        best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
        best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
        best_b = torch.zeros((n,), dtype=torch.int32, device=dev)
        for b in range(scene.num_models):
            if method == "walk":
                # Candidates only; the exact refine runs once below.
                mh = model_hit_any if any_hit else model_hit
                t, i, u, v = mh(scene, b, origins, dirs, best_t,
                                any_hit=any_hit, refine=False, t_min=t_min)
            else:
                t, i, u, v = model_hit(scene, b, origins, dirs, best_t)
            better = (i != MISS) & (t < best_t) & (t > t_min)
            best_t = torch.where(better, t, best_t)
            best_i = torch.where(better, i, best_i)
            best_u = torch.where(better, u, best_u)
            best_v = torch.where(better, v, best_v)
            best_b = torch.where(better, torch.full_like(best_b, b), best_b)

        hit = best_i != MISS
        one = torch.ones_like(best_t)
        if any_hit:
            # Occlusion only: no shading data.
            p = origins + torch.where(hit, best_t, one)[None, :] * dirs
            zeros = torch.zeros_like(p)
            return Hit(hit=hit, t=best_t, p=p, normal=zeros, mat=Materials(
                albedo=zeros, specular=zeros, roughness=one,
                metalness=torch.zeros_like(best_t),
                use_spec=torch.zeros_like(hit)))

        idx = torch.clamp_min(best_i, 0)
        rec_t = gather_rows(record, idx, cf=True)           # [36, N]
        v0, v1, v2 = rec_t[0:3], rec_t[3:6], rec_t[6:9]
        e1 = v1 - v0
        e2 = v2 - v0

        o_m = d_m = None
        for b in range(scene.num_models):
            o_b, d_b = transform_rays(scene.frames[b], origins, dirs)
            if o_m is None:
                o_m, d_m = o_b, d_b
            else:
                m = (best_b == b)[None, :]
                o_m = torch.where(m, o_b, o_m)
                d_m = torch.where(m, d_b, d_m)

        if method == "walk":
            t_r, u_r, v_r = intersect.mt_refine(o_m, d_m, v0, e1, e2)
            zero = torch.zeros_like(best_t)
            best_t = torch.where(hit, t_r, best_t)
            best_u = torch.where(hit, u_r, zero)
            best_v = torch.where(hit, v_r, zero)

        # Smooth shading normal, falling back to the geometric normal
        # wherever the interpolated vector is ~zero.
        n_geom = vec.normalize(vec.cross(e1, e2))
        n_sm = ((1.0 - best_u - best_v)[None, :] * rec_t[27:30]
                + best_u[None, :] * rec_t[30:33]
                + best_v[None, :] * rec_t[33:36])
        sm_len2 = (n_sm * n_sm).sum(0)
        use_sm = sm_len2 > 1e-12
        inv_sm = torch.rsqrt(torch.where(use_sm, sm_len2, one))
        n_model = torch.where(use_sm[None, :], n_sm * inv_sm[None, :], n_geom)

        # Normal to world via the transpose of world->model.
        normal = None
        for b in range(scene.num_models):
            n_b = scene.frames[b][:3, :3].T @ n_model
            normal = n_b if normal is None else torch.where(
                (best_b == b)[None, :], n_b, normal)
        normal = vec.normalize(normal)

        t_safe = torch.where(hit, best_t, one)
        p = origins + t_safe[None, :] * dirs
        if flip_normals:
            facing = (normal * dirs).sum(0) < 0.0
            normal = torch.where(facing[None, :], normal, -normal)

        emitted = torch.where(hit[None, :], rec_t[24:27],
                              torch.zeros_like(rec_t[24:27]))
        return Hit(hit=hit, t=best_t, p=p, normal=normal,
                   mat=_record_material(scene, rec_t, best_u, best_v,
                                       t=t_safe, cone=cone),
                   emitted=emitted,
                   tri=torch.where(hit, idx, torch.full_like(idx, -1)))

    if ray_tile <= 0:
        return hit_fn

    def hit_tiled(origins, dirs, t_min, t_max, any_hit=False, cone=None):
        n = origins.shape[1]
        if n <= ray_tile:
            return hit_fn(origins, dirs, t_min, t_max, any_hit=any_hit,
                          cone=cone)
        t_max = torch.as_tensor(t_max, dtype=torch.float32,
                                device=origins.device).expand(n)
        return _cat_hits([
            hit_fn(origins[:, a:a + ray_tile], dirs[:, a:a + ray_tile],
                   t_min, t_max[a:a + ray_tile], any_hit=any_hit,
                   cone=None if cone is None else
                   (cone[0][a:a + ray_tile], cone[1][a:a + ray_tile]))
            for a in range(0, n, ray_tile)])

    return hit_tiled


def load_mesh_scene(obj_paths, frames=None, method_pad: int = 1,
                    leaf_size: int = 2, device=None) -> MeshScene:
    """OBJ paths -> flattened MeshScene on ``device`` (None: the card,
    ``devices.resolve``)."""
    meshes = [load_object(p) for p in obj_paths]
    flat = flatten_models(meshes, frames=frames, leaf_size=leaf_size,
                          pad_to=method_pad)
    return upload(flat, device)
