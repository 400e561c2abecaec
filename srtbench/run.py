"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m srtbench.run --workload headline.render --seed 1 \\
        --seconds 20 --trace 0

``--trace 0`` measures the cell's end-to-end metrics over ``--seconds``
of work; ``--trace 1`` reads its per-layer metrics from host spans and a
``torch.profiler`` window instead.  Both check the output against the
plain reference once the work is done.  The last lines on standard error
give each compared number beside its limit; the last line on standard
output is the result.  Exits non-zero, printing no result, without
enough CUDA devices or when JAX, flax or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from srtbench import core

    bench = core.load_benchmark()
    cell = core.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"srtbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {n}", file=sys.stderr)
        return 3
    entry = core.entry(cell.traffic["entry"])
    out = entry.run(cell, args.seed, args.seconds, bool(args.trace),
                    T_START)
    found = core.forbidden_loaded() + out.device.pop("forbidden", [])
    if found:
        print(f"srtbench: the run loaded {sorted(set(found))}",
              file=sys.stderr)
        return 4
    line = core.result_line(cell, out, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
