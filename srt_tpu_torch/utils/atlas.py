"""Host-side texture atlas packing (numpy): counterpart of
``srt_tpu/utils/atlas.py``, carried over unchanged in behaviour.

Replaces the reference's bindless texture manager
(include/asset_utils/gpu_texture.h): every ``map_Kd`` image is decoded
once (PIL, where it is installed), converted to linear float RGB, packed
shelf-style into one atlas array, and referenced by integer rects.
Images are cached by path like the reference's ``LoadedTextures`` map
(gpu_texture.h:21-29).  Without PIL ``load_image`` returns None and the
material keeps its Kd; atlases built from arrays (``pack_atlas``) need no
decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Atlas:
    """Packed texture atlas: image [H, W, 3] float32 linear + rects [K, 4]
    int32 (x, y, w, h).  When built with ``mip_levels > 1``, ``mip_rects``
    [K, L, 4] locates each texture's mip chain inside the same image
    (level 0 == rects; textures that bottom out early repeat their last
    level) — the analog of the reference's ``glGenerateMipmap`` +
    ``GL_LINEAR_MIPMAP_LINEAR`` sampler state (gpu_texture.h:39-53)."""

    image: np.ndarray
    rects: np.ndarray
    mip_rects: Optional[np.ndarray] = None

    @property
    def num_textures(self) -> int:
        return self.rects.shape[0]

    @property
    def num_levels(self) -> int:
        return 1 if self.mip_rects is None else self.mip_rects.shape[1]


def build_mip_chain(img: np.ndarray, levels: int) -> List[np.ndarray]:
    """Box-filtered mip chain (level 0 = img), up to ``levels`` entries or
    until a dimension reaches 1.  Odd dimensions drop the last row/column
    before the 2x2 average (GL-style floor halving)."""
    chain = [np.asarray(img, np.float32)]
    while len(chain) < levels:
        prev = chain[-1]
        h, w = prev.shape[:2]
        if h < 2 or w < 2:
            break
        h2, w2 = h // 2, w // 2
        crop = prev[: h2 * 2, : w2 * 2]
        chain.append(
            crop.reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3)).astype(np.float32)
        )
    return chain


_image_cache: Dict[str, np.ndarray] = {}


def load_image(path: str) -> Optional[np.ndarray]:
    """Decode an image to float32 linear RGB [h, w, 3]; cached by path.

    Returns None when the file is missing or no decoder is available (the
    caller falls back to Kd, keeping the pipeline usable without PIL)."""
    if path in _image_cache:
        return _image_cache[path]
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"), np.float32) / 255.0
    except OSError:
        return None
    # sRGB -> linear (the GL path sampled sRGB-decoded texels implicitly).
    linear = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    # OBJ UV v runs bottom-up; image rows run top-down.
    linear = np.flipud(linear).copy()
    _image_cache[path] = linear.astype(np.float32)
    return _image_cache[path]


def pack_atlas(images: Sequence[np.ndarray], mip_levels: int = 1) -> Atlas:
    """Shelf-pack images into one array (simple height-sorted shelves).

    ``mip_levels > 1`` also packs each image's box-filtered mip chain and
    records it in ``Atlas.mip_rects`` [K, L, 4] (short chains repeat their
    last level so every texture has exactly L entries)."""
    if not images:
        return Atlas(image=np.zeros((1, 1, 3), np.float32),
                     rects=np.zeros((0, 4), np.int32))
    chains = [build_mip_chain(im, max(1, mip_levels)) for im in images]
    flat: List[np.ndarray] = []
    flat_of: List[Tuple[int, int]] = []   # flat index -> (texture, level)
    for ti, chain in enumerate(chains):
        for li, im in enumerate(chain):
            flat_of.append((ti, li))
            flat.append(im)

    order = sorted(range(len(flat)), key=lambda i: -flat[i].shape[0])
    max_w = max(im.shape[1] for im in flat)
    atlas_w = max(max_w, 1 << int(np.ceil(np.log2(max_w))))

    frects: List[Tuple[int, int, int, int]] = [None] * len(flat)  # type: ignore
    shelf_y = 0
    shelf_h = 0
    x = 0
    placements = []
    for i in order:
        h, w = flat[i].shape[:2]
        if x + w > atlas_w:
            shelf_y += shelf_h
            shelf_h = 0
            x = 0
        placements.append((i, x, shelf_y))
        frects[i] = (x, shelf_y, w, h)
        x += w
        shelf_h = max(shelf_h, h)
    atlas_h = shelf_y + shelf_h

    image = np.zeros((atlas_h, atlas_w, 3), np.float32)
    for i, px, py in placements:
        h, w = flat[i].shape[:2]
        image[py:py + h, px:px + w] = flat[i]

    k = len(images)
    level_count = max(len(c) for c in chains)
    rects = np.zeros((k, 4), np.int32)
    mip_rects = np.zeros((k, level_count, 4), np.int32)
    for fi, (ti, li) in enumerate(flat_of):
        if li == 0:
            rects[ti] = frects[fi]
        mip_rects[ti, li:] = frects[fi]    # short chains repeat last level
    if mip_levels <= 1:
        return Atlas(image=image, rects=rects)
    return Atlas(image=image, rects=rects, mip_rects=mip_rects)


def build_quad_table(image: np.ndarray, rects: np.ndarray,
                     mip_rects: np.ndarray = None) -> np.ndarray:
    """Quad-packed atlas for single-gather bilinear taps: row ``y*W + x``
    holds the 2x2 texel block [c00 c10 c01 c11] with REPEAT wrap applied
    per rect (gutter-free).  A bilinear fetch then needs ONE packed row
    gather instead of four 2D gathers (the JAX package's fast path for
    the TPU, where arbitrary gathers are slow; its speed on the GPU is
    not measured).
    4x the atlas memory; texels outside every rect stay zero (never
    addressed: tap coordinates are always wrapped into a rect)."""
    h, w = image.shape[:2]
    quad = np.zeros((h, w, 12), np.float32)
    all_rects = [tuple(int(v) for v in r) for r in np.asarray(rects)]
    if mip_rects is not None:
        all_rects += [tuple(int(v) for v in r)
                      for r in np.asarray(mip_rects).reshape(-1, 4)]
    for (x, y, rw, rh) in dict.fromkeys(all_rects):
        if rw <= 0 or rh <= 0:
            continue
        sub = np.asarray(image[y:y + rh, x:x + rw], np.float32)
        r1 = np.roll(sub, -1, axis=1)
        d1 = np.roll(sub, -1, axis=0)
        d1r1 = np.roll(r1, -1, axis=0)
        quad[y:y + rh, x:x + rw] = np.concatenate([sub, r1, d1, d1r1],
                                                  axis=-1)
    return quad.reshape(h * w, 12)


def build_atlas_for_materials(materials, mip_levels: int = 1
                              ) -> Tuple[Optional[Atlas], np.ndarray]:
    """Load every material's texture and pack an atlas.

    materials: sequence of MaterialDef.  Returns (atlas or None,
    tex_index [M] int32 with -1 for untextured/undecodable).
    ``mip_levels > 1`` packs box-filtered mip chains for trilinear
    minification (ops/texture.sample_atlas with lod)."""
    images: List[np.ndarray] = []
    index = np.full(len(materials), -1, np.int32)
    seen: Dict[str, int] = {}
    for mi, m in enumerate(materials):
        if not getattr(m, "use_texture", False) or not m.texture_path:
            continue
        if m.texture_path in seen:
            index[mi] = seen[m.texture_path]
            continue
        img = load_image(m.texture_path)
        if img is None:
            continue
        seen[m.texture_path] = len(images)
        index[mi] = len(images)
        images.append(img)
    if not images:
        return None, index
    return pack_atlas(images, mip_levels=mip_levels), index
