"""Gathers, a one-hot matmul, an argsort and a select chain at N rays
(``tools/micro_gather.py``'s counterpart): the small-table row gathers
the integrator does per bounce (``record[idx]``, ``take_small_t``),
against the one-hot matmul that would replace them.

Run as ``python3 -m srt_tpu_torch.tools.micro_gather [--device DEV] [--n
N] [--reps R]``.  Each of JAX's seven lines gives the wall ms of a
forward call (calls back to back, one synchronise: JAX's ``timeit``) and
the device ms (CUDA events around calls queued behind a spin; "not
measured" on the CPU, "host-bound" if the spin ended first).  The data
is drawn from a seeded ``torch.Generator`` on the device, not from
``jax.random``.
"""

from __future__ import annotations

import argparse
import functools
import operator
import sys

import torch
import torch.nn.functional as F

from srt_tpu_torch.devices import resolve
from srt_tpu_torch.tools import common

N = 512 * 512
TABLE = 1280
SMALL = 6
# Calls queued behind the spin for a device time: up to 40 launches a
# call stay well inside CUDA's launch queue.
DEVICE_CALLS = 5


def make_data(n: int, dev) -> dict:
    """JAX's operands: ``table`` [1280, 3], ``table1`` [1280], ``small``
    [6, 3] (normal), ``idx`` [n] in [0, 1280), ``idx6`` [n] in [0, 6),
    ``occ`` [512, 10] in {0, 1}, ``a`` [n, 3] (normal), ``m`` = idx >
    640."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    data = dict(table=normal(TABLE, 3), table1=normal(TABLE),
                small=normal(SMALL, 3), idx=ints(TABLE, n),
                idx6=ints(SMALL, n), occ=ints(2, 512, 10), a=normal(n, 3))
    data["m"] = data["idx"] > TABLE // 2
    return data


def where_chain(a, m):
    x = a
    for _ in range(20):
        x = torch.where(m[:, None], x * 1.01, x)
    return x


def cases(data: dict):
    """JAX's seven timed lines: (label, fn, args), labels as JAX prints
    them."""
    table, table1, small = data["table"], data["table1"], data["small"]
    return [
        ("gather [N] from [1280,3]", lambda i: table[i], (data["idx"],)),
        ("gather [N] from [1280]", lambda i: table1[i], (data["idx"],)),
        ("gather [N] from [6,3]", lambda i: small[i], (data["idx6"],)),
        ("onehot matmul [N] from [6,3]",
         lambda i: F.one_hot(i, SMALL).to(small.dtype) @ small,
         (data["idx6"],)),
        ("gather x6 from [1280,3]",
         lambda i: functools.reduce(operator.add, (
             table[(i + k) % TABLE] for k in range(6))), (data["idx"],)),
        ("argsort [512,10]",
         lambda o: torch.argsort(1 - o, dim=1, stable=True), (data["occ"],)),
        ("where chain x20 [N,3]", where_chain, (data["a"], data["m"])),
    ]


def run(device=None, n: int = N, reps: int = 30, verbose: bool = True):
    """One record a line: ``what`` (JAX's label), ``ms`` (wall a call),
    ``device_ms`` and ``device_queued`` (False: the spin ended before the
    calls were queued; both None on the CPU)."""
    dev = resolve(device)
    card = common.header("micro_gather", dev, verbose)
    records = []
    for what, fn, args in cases(make_data(n, dev)):
        ms = common.wall_s(fn, *args, dev=dev, reps=reps) * 1e3
        d_ms, queued = common.device_ms(lambda f=fn, a=args: f(*a), dev,
                                        n=DEVICE_CALLS)
        records.append(dict(what=what, n=n, ms=ms, device_ms=d_ms,
                            device_queued=queued if d_ms else None,
                            device=card))
        if verbose:
            dev_txt = ("not measured" if d_ms is None else f"{d_ms:9.4f} ms"
                       + ("" if queued else ", host-bound"))
            print(f"{what:45s} {ms:9.3f} ms  (device {dev_txt})",
                  flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device(ap)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    dev = common.cli_device("micro_gather", args.device)
    if dev is None:
        return 2
    run(dev, args.n, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
