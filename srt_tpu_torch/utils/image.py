"""Image output (counterpart of ``srt_tpu/utils/image.py``): PPM, as the
reference CPU renderer writes it (src/raytracer/raytracer.cpp:10-25,
59-61), and PNG through PIL where it is installed.

Images are float [H, W, 3] in display space ([0, 1]), as numpy arrays or
tensors on any device (copied to the host)."""

from __future__ import annotations

import numpy as np
import torch


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_uint8(img) -> np.ndarray:
    return (np.clip(_host(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_ppm(path: str, img, flip_vertical: bool = True) -> None:
    """Write a binary P6 PPM.  ``flip_vertical`` converts the renderer's
    y-up row order to the top-down file order."""
    data = to_uint8(img)
    if flip_vertical:
        data = np.flipud(data)
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(data.tobytes())


def write_png(path: str, img, flip_vertical: bool = True) -> bool:
    """Write a PNG if PIL is available; returns False otherwise."""
    try:
        from PIL import Image
    except ImportError:
        return False
    data = to_uint8(img)
    if flip_vertical:
        data = np.flipud(data)
    Image.fromarray(data).save(path)
    return True


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM to float [H, W, 3] in [0, 1] (file row
    order)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"P6":
            raise ValueError(f"{path}: not a binary P6 PPM")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        maxval = int(f.readline())
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    return data.reshape(h, w, 3).astype(np.float32) / maxval
