"""Sum the device operations of a chrome trace written by
``torch.profiler`` (``export_chrome_trace``, ``utils/profiling.
profile_trace``): ``tools/parse_trace.py``'s counterpart.

Device operations are the complete events (``"ph": "X"``) of the CUDA
categories: kernels, memory copies and memory sets.  Run as ``python3 -m
srt_tpu_torch.tools.parse_trace TRACE [--top K]`` (``.json`` or
``.json.gz``); prints the total, then the top K names by summed time.
"""

from __future__ import annotations

import argparse
import gzip
import json
import sys
from collections import Counter

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def summarize(trace, top: int = 40) -> dict:
    """``trace``: a path or the loaded JSON.  Returns ``total_ms``,
    ``events`` (their count) and ``top``: [{name, ms, count}] by summed
    ms, longest first."""
    data = load(trace) if isinstance(trace, str) else trace
    ms, count = Counter(), Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = e.get("name", "?")
        ms[name] += e.get("dur", 0) / 1e3
        count[name] += 1
    return dict(total_ms=sum(ms.values()), events=sum(count.values()),
                top=[dict(name=k, ms=v, count=count[k])
                     for k, v in ms.most_common(top)])


def print_summary(summary: dict) -> None:
    total = summary["total_ms"]
    total = "not measured" if total is None else f"{total:.3f} ms"
    print(f"device total: {total} across {summary['events']} events",
          flush=True)
    for row in summary["top"]:
        print(f"{row['ms']:9.3f} ms  x{row['count']:4d}  {row['name'][:110]}",
              flush=True)


def run(path: str, top: int = 40, verbose: bool = True) -> dict:
    summary = summarize(path, top)
    if verbose:
        print_summary(summary)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    run(args.trace, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
