"""A bounce's GGX shading, AoS against SoA (``tools/micro_layout.py``'s
counterpart): mixed [N, 3] / [N] ops (AoS) against pure [N] ops (SoA) at
a bounce's op count, once and over four bounces whose light direction
turns (a cross product and a normalise) into an accumulator.

Run as ``python3 -m srt_tpu_torch.tools.micro_layout [--device DEV] [--n
N] [--reps R]``.  Each line gives the wall ms of a call (JAX's
``timeit``), and the device ms and device operations of one call
(``micro_soa.time_case``); JAX's constants and order of operations are
kept.  The data is drawn from a seeded ``torch.Generator`` on the device.
"""

from __future__ import annotations

import argparse
import functools
import sys

import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.tools import common
from srt_tpu_torch.tools.micro_soa import soa, time_case

N = 512 * 512
LUMA = (0.2126, 0.7152, 0.0722)


@functools.lru_cache(maxsize=None)
def _luma(device: torch.device):
    return torch.tensor(LUMA, dtype=torch.float32, device=device)


def make_data(n: int, dev):
    """(nrm, ldir, vdir) [n, 3] unit normal draws, alb [n, 3], rough [n],
    metal [n] uniform in [0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit():
        x = torch.randn((n, 3), generator=gen, device=dev)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    nrm, ldir, vdir = unit(), unit(), unit()
    alb = torch.rand((n, 3), generator=gen, device=dev)
    rough = torch.rand((n,), generator=gen, device=dev)
    metal = torch.rand((n,), generator=gen, device=dev)
    return nrm, ldir, vdir, alb, rough, metal


def soa_args(nrm, ldir, vdir, alb, rough, metal):
    return soa(nrm) + soa(ldir) + soa(vdir) + soa(alb) + (rough, metal)


def dot3(a, b):
    return torch.sum(a * b, dim=-1)


def shade_aos(nrm, ldir, vdir, alb, rough, metal):
    h = ldir + vdir
    h = h / torch.sqrt(torch.clamp_min(dot3(h, h), 1e-12))[:, None]
    ndl = torch.clamp(dot3(nrm, ldir), 0, 1)
    ndv = torch.clamp(dot3(nrm, vdir), 0, 1)
    ndh = torch.clamp(dot3(nrm, h), 0, 1)
    ldh = torch.clamp(dot3(ldir, h), 0, 1)
    f0 = (1 - metal[:, None]) * 0.04 + metal[:, None] * alb
    lum = f0 @ _luma(f0.device)
    f90 = torch.clamp_max(25.0 * lum, 1.0)
    fres = f0 + (f90[:, None] - f0) * (1 - ldh[:, None]) ** 5
    a2 = (rough * rough) ** 2
    b = (a2 - 1) * ndh * ndh + 1
    d = a2 / torch.clamp_min(3.14159 * b * b, 1e-3)
    gl = (ndl / torch.clamp_min(rough, 1e-4)
          / torch.sqrt(1 - torch.clamp_max(ndl * ndl, 0.999)))
    gv = (ndv / torch.clamp_min(rough, 1e-4)
          / torch.sqrt(1 - torch.clamp_max(ndv * ndv, 0.999)))
    g = 1 / (1 + 0.5 / gl + 0.5 / gv)
    spec = fres * (d * g / torch.clamp_min(4 * ndl * ndv, 1e-3) * ndl)[:, None]
    diff = alb * (1 - metal[:, None]) * (ndl / 3.14159)[:, None]
    return (1 - fres) * diff + spec


def shade_soa(nx, ny, nz, lx, ly, lz, vx, vy, vz, ar, ag, ab, rough, metal):
    hx, hy, hz = lx + vx, ly + vy, lz + vz
    hl = 1.0 / torch.sqrt(torch.clamp_min(hx * hx + hy * hy + hz * hz, 1e-12))
    hx, hy, hz = hx * hl, hy * hl, hz * hl
    ndl = torch.clamp(nx * lx + ny * ly + nz * lz, 0, 1)
    ndv = torch.clamp(nx * vx + ny * vy + nz * vz, 0, 1)
    ndh = torch.clamp(nx * hx + ny * hy + nz * hz, 0, 1)
    ldh = torch.clamp(lx * hx + ly * hy + lz * hz, 0, 1)
    f0r = (1 - metal) * 0.04 + metal * ar
    f0g = (1 - metal) * 0.04 + metal * ag
    f0b = (1 - metal) * 0.04 + metal * ab
    lum = 0.2126 * f0r + 0.7152 * f0g + 0.0722 * f0b
    f90 = torch.clamp_max(25.0 * lum, 1.0)
    k = (1 - ldh) ** 5
    fr = f0r + (f90 - f0r) * k
    fg = f0g + (f90 - f0g) * k
    fb = f0b + (f90 - f0b) * k
    a2 = (rough * rough) ** 2
    b = (a2 - 1) * ndh * ndh + 1
    d = a2 / torch.clamp_min(3.14159 * b * b, 1e-3)
    gl = (ndl / torch.clamp_min(rough, 1e-4)
          / torch.sqrt(1 - torch.clamp_max(ndl * ndl, 0.999)))
    gv = (ndv / torch.clamp_min(rough, 1e-4)
          / torch.sqrt(1 - torch.clamp_max(ndv * ndv, 0.999)))
    g = 1 / (1 + 0.5 / gl + 0.5 / gv)
    s = d * g / torch.clamp_min(4 * ndl * ndv, 1e-3) * ndl
    dl = (1 - metal) * (ndl / 3.14159)
    return ((1 - fr) * ar * dl + fr * s,
            (1 - fg) * ag * dl + fg * s,
            (1 - fb) * ab * dl + fb * s)


def shade_aos_x4(nrm, ldir, vdir, alb, rough, metal):
    acc = torch.zeros((nrm.shape[0], 3), device=nrm.device)
    l = ldir
    for _ in range(4):
        out = shade_aos(nrm, l, vdir, alb, rough, metal)
        acc = acc + out
        l = torch.linalg.cross(l, nrm, dim=-1)
        l = l / torch.sqrt(torch.clamp_min(dot3(l, l), 1e-9))[:, None]
    return acc


def shade_soa_x4(*a):
    accr = accg = accb = torch.zeros(a[0].shape, device=a[0].device)
    (nx, ny, nz, lx, ly, lz, vx, vy, vz, ar, ag, ab, rough, metal) = a
    for _ in range(4):
        r, g, b = shade_soa(nx, ny, nz, lx, ly, lz, vx, vy, vz, ar, ag, ab,
                            rough, metal)
        accr, accg, accb = accr + r, accg + g, accb + b
        cx = ly * nz - lz * ny
        cy = lz * nx - lx * nz
        cz = lx * ny - ly * nx
        il = 1.0 / torch.sqrt(torch.clamp_min(cx * cx + cy * cy + cz * cz,
                                              1e-9))
        lx, ly, lz = cx * il, cy * il, cz * il
    return accr, accg, accb


def cases(data):
    """JAX's four timed lines: (label, fn, args)."""
    args_soa = soa_args(*data)
    return [("shade AoS [N,3]", shade_aos, data),
            ("shade SoA [N]x3", shade_soa, args_soa),
            ("shade AoS x4 bounces", shade_aos_x4, data),
            ("shade SoA x4 bounces", shade_soa_x4, args_soa)]


def run(device=None, n: int = N, reps: int = 20, verbose: bool = True):
    """One record a line (``micro_soa.time_case``'s keys, and ``n``)."""
    dev = resolve(device)
    card = common.header("micro_layout", dev, verbose)
    return [time_case(what, fn, args, dev, reps, card, verbose, n=n)
            for what, fn, args in cases(make_data(n, dev))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_layout", args.device)
    if dev is None:
        return 2
    run(dev, args.n, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
