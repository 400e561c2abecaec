"""Texture sampling from a packed atlas (counterpart of
``srt_tpu/ops/texture.py``).

The reference fetches through bindless ``sampler2D`` handles
(raytrace_utils.glsl:165-166, gpu_texture.h:60-63); here every texture is
packed into one ``[H, W, 3]`` atlas tensor at load time
(``utils/atlas.py``) and a fetch is a bilinear gather inside a per-texture
rect, differentiable with respect to the atlas texels.  Plain PyTorch:
the JAX package's version is XLA code, not a Pallas kernel.

The wrap is floor modulo (``torch.remainder``, as ``%`` on JAX arrays),
never ``torch.fmod``: barycentric UVs leave [0, 1] by the walk's edge slop
and negative UVs occur.  ``torch.round`` rounds half to even, as
``jnp.round`` does, and the float-to-int casts truncate after the modulo,
in the JAX package's order.
"""

from __future__ import annotations

import torch

from srt_tpu_torch.ops.safemath import clip


def _sample_rect(atlas, r, uv, bilinear: bool, quad=None, atlas_w: int = 0):
    """Bilinear (or nearest) fetch inside per-ray rects r [N, 4] at uv
    [N, 2]; returns [N, 3].

    ``quad`` [H*W, 12] (``utils/atlas.build_quad_table``) serves the four
    bilinear taps from one row.  It is a host-built copy of the atlas, so
    callers that differentiate with respect to the texels keep
    ``quad=None``: the per-tap gathers' backward lands in the atlas."""
    rx, ry = r[:, 0].to(torch.float32), r[:, 1].to(torch.float32)
    rw, rh = r[:, 2].to(torch.float32), r[:, 3].to(torch.float32)

    u = torch.remainder(uv[:, 0], 1.0)
    v = torch.remainder(uv[:, 1], 1.0)

    # Texel-space coordinates inside the rect (half-texel centred).
    x = u * rw - 0.5
    y = v * rh - 0.5

    if not bilinear:
        xi = rx + torch.clamp(torch.round(x), torch.zeros_like(rw), rw - 1)
        yi = ry + torch.clamp(torch.round(y), torch.zeros_like(rh), rh - 1)
        return atlas[yi.to(torch.int32).long(), xi.to(torch.int32).long()]

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    if quad is not None:
        # The quad row at the wrapped base tap holds all four taps, the
        # per-rect repeat wrap applied on the host.
        xi = (rx + torch.remainder(x0, rw)).to(torch.int32)
        yi = (ry + torch.remainder(y0, rh)).to(torch.int32)
        q = quad[(yi * atlas_w + xi).long()]
        c00, c10 = q[:, 0:3], q[:, 3:6]
        c01, c11 = q[:, 6:9], q[:, 9:12]
    else:
        def fetch(xo, yo):
            # Repeat-wrap inside the rect, then offset into the atlas.
            xi = (rx + torch.remainder(x0 + xo, rw)).to(torch.int32)
            yi = (ry + torch.remainder(y0 + yo, rh)).to(torch.int32)
            return atlas[yi.long(), xi.long()]

        c00 = fetch(0.0, 0.0)
        c10 = fetch(1.0, 0.0)
        c01 = fetch(0.0, 1.0)
        c11 = fetch(1.0, 1.0)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_atlas(atlas, rects, tex_index, uv, bilinear: bool = True,
                 mip_rects=None, lod=None, quad=None):
    """Sample RGB [N, 3] from the atlas.

    atlas [H, W, 3] float32; rects [K, 4] int32 (x, y, w, h) texel rects;
    tex_index [N] int32 (clamped to the table; callers mask untextured
    hits); uv [N, 2] with the OBJ convention (v up).  Wrap mode: repeat.

    ``mip_rects`` [K, L, 4] with ``lod`` [N] sample trilinearly
    (GL_LINEAR_MIPMAP_LINEAR, gpu_texture.h:39-53): bilinear taps at
    floor(lod) and floor(lod) + 1 blended by the fraction, lod clamped to
    the chain."""
    idx = torch.clamp(tex_index, 0, rects.shape[0] - 1).long()
    aw = atlas.shape[1]
    if mip_rects is None or lod is None:
        return _sample_rect(atlas, rects[idx], uv, bilinear, quad=quad,
                            atlas_w=aw)

    levels = mip_rects.shape[1]
    lod = clip(lod.to(torch.float32), 0.0, levels - 1.0)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp_max(l0 + 1, levels - 1)
    frac = (lod - l0.to(torch.float32))[:, None]
    c0 = _sample_rect(atlas, mip_rects[idx, l0.long()], uv, bilinear,
                      quad=quad, atlas_w=aw)
    c1 = _sample_rect(atlas, mip_rects[idx, l1.long()], uv, bilinear,
                      quad=quad, atlas_w=aw)
    return c0 * (1 - frac) + c1 * frac
