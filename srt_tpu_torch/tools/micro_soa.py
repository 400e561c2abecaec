"""Eight dependent dot products, AoS against SoA (``tools/micro_soa.py``'s
counterpart): the same bounce-style chain on [N, 3] tensors (a sum
reduce, then sliced components) and on three [N] tensors.

Run as ``python3 -m srt_tpu_torch.tools.micro_soa [--device DEV] [--n N]
[--reps R]``.  Each line gives the wall ms of a call (JAX's ``timeit``),
and the device ms and device operations of one call (``common.
device_ops``: their sum in a ``torch.profiler`` trace): in eager
PyTorch every op is a launch, so the layouts differ in launches as well
as in bytes.  Device ms and launches are "not measured" on the CPU.  The
data is drawn from a seeded ``torch.Generator`` on the device.
"""

from __future__ import annotations

import argparse
import sys

import torch

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.tools import common

N = 512 * 512


def dot_aos(a, b):
    # chain of 8 dependent dot products, like a bounce's brdf math
    x = a
    for _ in range(8):
        d = torch.sum(x * b, dim=-1, keepdim=True)
        x = x * d + b
    return x


def dot_soa(ax, ay, az, bx, by, bz):
    x, y, z = ax, ay, az
    for _ in range(8):
        d = x * bx + y * by + z * bz
        x = x * d + bx
        y = y * d + by
        z = z * d + bz
    return x, y, z


def dot_unrolled_aos(a, b):
    x = a
    for _ in range(8):
        d = (x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1]
             + x[:, 2] * b[:, 2])[:, None]
        x = x * d + b
    return x


def make_data(n: int, dev):
    """(a, b) [n, 3] normal draws."""
    gen = torch.Generator(device=dev).manual_seed(0)
    return tuple(torch.randn((n, 3), generator=gen, device=dev)
                 for _ in range(2))


def soa(x):
    """The three columns of [n, 3] as contiguous [n] tensors."""
    return tuple(x[:, k].contiguous() for k in range(3))


def cases(a, b):
    """JAX's three timed lines: (label, fn, args)."""
    return [("aos [N,3] sum-reduce dots x8", dot_aos, (a, b)),
            ("aos [N,3] sliced dots x8", dot_unrolled_aos, (a, b)),
            ("soa 3x[N] dots x8", dot_soa, soa(a) + soa(b))]


def time_case(what, fn, args, dev, reps, card, verbose, **extra):
    """A record of one case: ``what``, ``ms`` (wall), ``device_ms`` and
    ``launches`` (None on the CPU); printed when ``verbose``.  Both device
    figures come from one call's ``torch.profiler`` trace: at 30 to 600
    launches a call, calls queued behind a spin (``common.device_ms``)
    would fill CUDA's launch queue and time the host's gaps."""
    ms = common.wall_s(fn, *args, dev=dev, reps=reps) * 1e3
    launches, d_ms = common.device_ops(lambda: fn(*args), dev)
    rec = dict(what=what, ms=ms, device_ms=d_ms, launches=launches,
               device=card, **extra)
    if verbose:
        dev_txt = ("device not measured" if d_ms is None
                   else f"device {d_ms:9.4f} ms, {launches} launches")
        print(f"{what:45s} {ms:9.3f} ms  ({dev_txt})", flush=True)
    return rec


def run(device=None, n: int = N, reps: int = 50, verbose: bool = True):
    """One record a line (``time_case``'s keys, and ``n``)."""
    dev = resolve(device)
    card = common.header("micro_soa", dev, verbose)
    return [time_case(what, fn, args, dev, reps, card, verbose, n=n)
            for what, fn, args in cases(*make_data(n, dev))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_soa", args.device)
    if dev is None:
        return 2
    run(dev, args.n, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
