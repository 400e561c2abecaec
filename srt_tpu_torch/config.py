"""Configuration dataclasses (counterpart of ``srt_tpu/config.py``).

Copied field for field, so a JAX config and a port config built from the
same arguments describe the same render.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera settings (reference ``CameraSettings``, camera.h:16-28).

    ``viewport_mode``:
      * ``"reference"`` — square 1x1 viewport at ``focus_dist`` regardless of
        aspect, exactly like ``GetCamera`` (raytrace_compute.glsl:47-76).
      * ``"vfov"`` — viewport derived from ``vfov`` degrees and the true
        aspect ratio (square pixels).
    """

    width: int = 256
    height: int = 256
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    look_at: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    v_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov: float = 90.0
    focus_dist: float = 1.0
    defocus_angle: float = 0.0
    viewport_mode: str = "reference"

    @property
    def aspect(self) -> float:
        return self.width / self.height


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Path-tracing settings; see ``srt_tpu.config.RenderConfig`` for the
    meaning of each field.  ``max_depth + rr_bounces`` masked bounces run;
    paths alive after that are terminated as a miss."""

    max_depth: int = 5
    rr_bounces: int = 3
    spp: int = 1
    t_min: float = 1e-3
    sky_color: Tuple[float, float, float] = (0.05, 0.05, 0.05)
    sky_gradient: bool = False
    sky_always: bool = True
    flip_mesh_normals: bool = True
    # Every material is specular (mesh material conversion sets use_spec
    # for every triangle): skip the diffuse direct-light variant.
    uniform_use_spec: bool = False
    ray_tile: int = 2048
    # Trace rays in Morton (Z-order) pixel order (bit-exact either way).
    morton_order: bool = True
    # Re-sort the wavefront between bounces (dead-last, coherence keys).
    sort_bounces: bool = False
    # Re-sort each shadow batch by (dead-last, light, origin cell) from
    # this bounce index on (None = off).
    sort_shadows_from: Optional[int] = None
    # Next-event estimation toward emissive triangles, combined with BSDF
    # sampling by the balance heuristic; needs an emitter table
    # (trace_wavefront / trace_image_compact ``emitters=``;
    # make_render_plan builds it from the scene).
    nee: bool = False
    # Ray-cone footprints (width, spread) carried through the bounces to
    # pick texture mips; without mips in the scene the LOD stays None.
    ray_cones: bool = False
    primary_spread: float = 0.0
    cone_diffuse_spread: float = 0.35
    cone_spec_spread: float = 0.25


# Reference defaults (src/main.cpp:137-138, raytrace_compute.glsl:366-384).
REFERENCE_WIDTH = 1000
REFERENCE_HEIGHT = 800

SPHERES_CAMERA = CameraConfig(
    width=REFERENCE_WIDTH,
    height=REFERENCE_HEIGHT,
    origin=(0.0, 0.0, 0.0),
    look_at=(0.0, 0.0, -1.0),
)

MODEL_CAMERA = CameraConfig(
    width=REFERENCE_WIDTH,
    height=REFERENCE_HEIGHT,
    origin=(0.0, 20.0, 20.0),
    look_at=(0.0, 1.0, -1.0),
)
