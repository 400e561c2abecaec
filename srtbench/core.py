"""Finding a cell's pieces by name, and assembling the result line.

``BENCHMARK.json`` names each cell's configuration (its file) and traffic
mix (``traffic/<mix>.json``); a traffic file names its entry
(``entries/<entry>.py``); each end-to-end metric is read by
``e2e/<name>.py`` and each per-layer metric by ``metrics/<name>.py``.  A
later cell, mix, entry or metric is a new file and a new entry in
``BENCHMARK.json``: nothing here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Optional

from srtbench.lib import config as config_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "srt_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration with the mix's overrides
    traffic: dict
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(wl)})")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = config_mod.load(root / conf["file"])
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]),
                config=config_mod.merged(config, traffic), traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def entry(name: str):
    return importlib.import_module(f"srtbench.entries.{name}")


def _file_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"srtbench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def e2e_reader(name: str):
    return _file_module("e2e", name)


def metric_reader(name: str):
    return _file_module("metrics", name)


def forbidden_loaded() -> list:
    """Top-level module names of JAX, flax or the JAX package that this
    process has loaded, compared whole (``srt_tpu_torch`` is not
    ``srt_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    """What the host clock saw: the measured window, set-up, frames or
    steps, and the window's peak memory."""
    seconds: float
    setup_s: float
    peak_bytes: int
    frame_s: Optional[list] = None
    paths_per_frame: Optional[int] = None
    step_s: Optional[list] = None


@dataclasses.dataclass
class Outcome:
    """What an entry hands back: the window (trace 0) or the trace
    readings (trace 1), the compared numbers and the device."""
    attempted: int
    failed: int
    checks: dict                  # name -> (value, limit)
    device: dict
    window: Optional[Window] = None
    reading: Optional[object] = None
    breakdown: Optional[dict] = None


def result_line(c: Cell, out: Outcome, trace: bool) -> dict:
    metrics = {}
    if trace:
        for m in c.per_layer:
            value = metric_reader(m["name"]).read(out.reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in c.end_to_end:
            value = e2e_reader(m["name"]).read(out.window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = out.failed == 0 and all(v <= lim for v, lim in
                                      out.checks.values())
    line = {"correct": bool(correct), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": out.device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line
