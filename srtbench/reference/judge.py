"""The comparisons that decide ``correct`` (frozen).

``pixel_readings``: the program's frames against the plain reference at
pixels drawn from the seed, half over the whole frame and half where the
pixel's centre ray meets the mesh's bounding sphere.  A pixel is off when
a channel differs by more than ``atol + rtol * |reference|``; rounding
alone moves a pixel by about 1e-6 of its value, while a path that takes
another branch (a hit on the neighbouring triangle at an edge) moves it
by percents, so the share of pixels off counts such paths.

``train_readings``: the first steps of inverse rendering against the
reference's own steps: the loss of each step, the first gradient as the
optimizer got it, and the parameters' change after the steps, each by its
worst leaf.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from srtbench.lib import config as config_mod
from srtbench.lib import threefry
from srtbench.reference import pathtrace

# A pixel is off when a channel differs by more than ATOL + RTOL * |ref|.
RTOL = 1e-4
ATOL = 1e-6


def reference_scene(cfg: dict, mesh, device, dtype=torch.float32,
                    positions=None, kd=None) -> pathtrace.Scene:
    """The reference's scene from the configuration and the mesh arrays
    that both sides were handed; ``positions`` / ``kd`` replace the
    shading positions and the diffuse colour (the trained parameters)."""
    pos, _, vidx = mesh
    pos_t = torch.as_tensor(pos, device=device)
    vidx_t = torch.as_tensor(vidx.astype(np.int64), device=device)
    search = pathtrace.Mesh(pos_t, vidx_t, dtype)
    mat = cfg["material"]
    lights = tuple(torch.tensor(cfg["lights"][k], dtype=torch.float32,
                                device=device)
                   for k in ("position", "color", "intensity"))
    r = cfg["render"]
    return pathtrace.Scene(
        search, pos_t if positions is None else positions,
        torch.tensor(mat["diffuse"], device=device) if kd is None else kd,
        torch.tensor(mat["specular"], device=device),
        float(mat["specular_ex"]), lights,
        torch.tensor(r["sky_color"], device=device), float(r["t_min"]),
        int(r["max_depth"]), int(r["rr_bounces"]))


def sample_keys(scheme: str, frame_key, spp: int):
    """(key, paths, ids-of-pixel) for each sample of a frame: the compact
    driver draws one stream over pixel * spp + s; the scan and sharded
    drivers draw sample s from ``fold_in(frame_key, s)`` over pixels."""
    if scheme == "stream_spp":
        return [(frame_key, spp, lambda pix, s: pix * spp + s)
                for s in range(spp)]
    return [(threefry.fold_in(frame_key, s), 1, lambda pix, s: pix)
            for s in range(spp)]


def draw_pixels(seed: int, frame: int, cfg: dict, mesh, n: int):
    """``n`` pixel indices drawn from the seed: half uniform, half among
    pixels whose centre ray meets the mesh's bounding sphere."""
    cam = cfg["camera"]
    w, h = cam["width"], cam["height"]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, frame])
    uniform = rng.integers(0, w * h, n // 2)
    c, rad = config_mod.bounding_sphere(mesh[0])
    cand = rng.integers(0, w * h, 16 * n)
    o, d = pathtrace.camera_rays(
        cam, torch.as_tensor(cand % w), torch.as_tensor(cand // w),
        torch.full((2, cand.shape[0]), 0.5, dtype=torch.float64),
        torch.float64)
    o, d = o.numpy(), d.numpy()
    oc = o - c
    b = (oc * d).sum(1)
    a = (d * d).sum(1)
    disc = b * b - a * ((oc * oc).sum(1) - rad * rad)
    inside = cand[disc >= 0][: n - n // 2]
    return np.concatenate([uniform, inside])


def reference_pixels(ref: pathtrace.Scene, cfg: dict, scheme: str,
                     layout: str, frame_key, pix: torch.Tensor):
    """Reference radiance [P, 3] of pixels ``pix`` (the mean of their
    samples)."""
    cam = cfg["camera"]
    spp = int(cfg["render"]["spp"])
    n_pix = cam["width"] * cam["height"]
    acc = 0
    for s, (key, per, ids_of) in enumerate(sample_keys(scheme, frame_key,
                                                       spp)):
        ids = ids_of(pix, s if per > 1 else 0)
        acc = acc + pathtrace.render_paths(ref, cam, layout, key,
                                           n_pix * per, ids, spp_of=per)
    return acc / spp


def pixel_readings(frames, seed: int, cfg: dict, mesh, scheme: str,
                   layout: str, device, n_pixels: int,
                   control=None) -> dict:
    """Compare the program's images at pixels drawn from the seed.
    ``frames``: (frame index, image [H, W, 3]) with frame i keyed
    ``fold_in(key(seed), i)``.  ``control`` (a dtype) puts the reference,
    computed in that precision, in the program's place.  Returns the share
    of pixels off (%) and the largest relative gap seen."""
    ref = reference_scene(cfg, mesh, device)
    low = None if control is None else reference_scene(cfg, mesh, device,
                                                        control)
    w = cfg["camera"]["width"]
    off = total = 0
    worst = 0.0
    for i, img in frames:
        pix = torch.as_tensor(draw_pixels(seed, i, cfg, mesh, n_pixels),
                              device=device)
        key = threefry.fold_in(threefry.key(seed, device), i)
        want = reference_pixels(ref, cfg, scheme, layout, key, pix).float()
        if low is None:
            got = img[pix // w, pix % w].float().to(device)
        else:
            got = reference_pixels(low, cfg, scheme, layout, key,
                                   pix).float()
        gap = (got - want).abs()
        bad = ~(gap <= ATOL + RTOL * want.abs()).all(-1)
        off += int(bad.sum())
        total += pix.shape[0]
        rel = (gap / (want.abs() + ATOL)).amax()
        worst = max(worst, float(torch.nan_to_num(rel, nan=math.inf)))
    return {"px_off_pct": 100.0 * off / total, "px_worst_rel": worst,
            "pixels": total}


# ----------------------------- inverse rendering ---------------------------

def adam_steps(params, grads_of, lr: float, steps: int,
               betas=(0.9, 0.999), eps: float = 1e-8):
    """Plain Adam: ``grads_of(params, i) -> (loss, grads)``; returns the
    losses, the first gradients and the parameters after ``steps``."""
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first = [], None
    params = [p.detach().clone() for p in params]
    for i in range(steps):
        loss, grads = grads_of(params, i)
        losses.append(float(loss))
        if first is None:
            first = [g.detach().clone() for g in grads]
        t = i + 1
        for p, g, mi, vi in zip(params, grads, m, v):
            mi.mul_(betas[0]).add_(g, alpha=1 - betas[0])
            vi.mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
            denom = (vi.sqrt() / math.sqrt(1 - betas[1] ** t)).add_(eps)
            p.addcdiv_(mi, denom, value=-lr / (1 - betas[0] ** t))
    return losses, first, params


def worst_leaf_gap(prog_norms, ref_norms) -> float:
    """The largest gap between the program's and the reference's norm of
    a leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    med = statistics.median(ref_norms)
    return max(abs(a - b) / max(b, med, 1e-30)
               for a, b in zip(prog_norms, ref_norms))


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` [steps], ``grad_norms`` and
    ``change_norms`` [leaves].  Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                       ref["losses"]))
    med = statistics.median(ref["grad_norms"])
    keep = [i for i, g in enumerate(ref["grad_norms"]) if g >= 1e-3 * med]
    return {
        "loss_gap": loss_gap,
        "grad_gap": worst_leaf_gap(prog["grad_norms"], ref["grad_norms"]),
        "change_gap": worst_leaf_gap([prog["change_norms"][i] for i in keep],
                                     [ref["change_norms"][i] for i in keep]),
    }
