"""Readings that set a cell's limits: the compared numbers of the program
on many seeds and of the control, the plain reference put in the
program's place and computed in the next lower precision (bfloat16 for
the float32 configurations).  One process, one set-up:

    python3 -m srtbench.control --workload headline.render \\
        --seeds 11,12,13 --control bfloat16

Prints one JSON line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control", default="bfloat16",
                    help="dtype of the control, or 'none'")
    ap.add_argument("--fault", default="none",
                    help="a fault planted in the program (entry-specific)")
    args = ap.parse_args(argv)

    from srtbench import core

    cell = core.cell(core.load_benchmark(), args.workload)
    entry = core.entry(cell.traffic["entry"])
    control = (None if args.control == "none"
               else getattr(torch, args.control))
    kwargs = {} if args.fault == "none" else {"fault": args.fault}
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, prog, ctrl in entry.readings(cell, seeds, control=control,
                                           **kwargs):
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
