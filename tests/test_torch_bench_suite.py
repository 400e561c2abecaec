"""The port's benchmark suite (``srt_tpu_torch/bench_suite.py``) on the CPU,
configs 1-6 (configs 7-11 and the loop's rules:
``tests/test_torch_bench_suite_more.py``).

Each config runs through ``bench_suite.main`` under ``SRT_SUITE_SMALL=1``
and ``--device cpu`` and must print the lines JAX's ``bench_suite.py``
prints for it there: the same count (one card-less device, so config5 and
config7 give their one-shard row; config8 its stream-forced smoke line),
each metric matching the text of JAX's ``emit`` call (read from its
source, so the tests follow it), where the traversal JAX names from
``method`` reads ``walk`` and the backend ``cpu``, the same unit, a
``vs_baseline`` of None exactly where JAX's is, and a finite value.
Correctness flags: config6's finite and nonzero gradients, config8's
agreement > 0.995, config10's losses not rising.  config1 reads the same
max |err| against the oracle as JAX's own config1 at that size (64x64):
there one pixel's bounce ray grazes a sphere, float32 and the float64
oracle disagree on the hit in both packages, and the error is 5.9e-3, so
both flags read 0.0; the card's 256x256 run (``chip_smoke.py`` phase 15)
holds the 2e-3 flag.
"""

import ast
import contextlib
import io
import json
import math
import os
import re

import pytest
import torch

from srt_tpu_torch import bench_suite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Lines a config prints on the CPU (JAX's suite on one device).
LINES = {"1": 1, "2": 2, "3": 2, "4": 1, "5": 1, "6": 2, "7": 1, "8": 1,
         "9": 1, "10": 2, "11": 2}
# What JAX's formatted fields read in the port's lines on the CPU.
FIELDS = {"method": "walk", "jax.default_backend()": "cpu",
          "finite": "True"}
FLAGGED = ("6", "8", "10")


def jax_emits():
    """{config number: [(metric regex, [field source], unit, vs_baseline
    is None)]} of each ``emit`` call in JAX's ``bench_suite.py``, in
    source order."""
    with open(os.path.join(ROOT, "bench_suite.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in tree.body:
        m = re.fullmatch(r"config(\d+)_\w+", getattr(fn, "name", ""))
        if not m:
            continue
        emits = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call)
                        and getattr(n.func, "id", None) == "emit"),
                       key=lambda n: n.lineno)
        calls = []
        for node in emits:
            kw = {k.arg: k.value for k in node.keywords}
            metric = kw["metric"]
            parts, fields = [], []
            for v in (metric.values if isinstance(metric, ast.JoinedStr)
                      else [metric]):
                if isinstance(v, ast.Constant):
                    parts.append(re.escape(v.value))
                else:
                    parts.append("(.+?)")
                    fields.append(ast.unparse(v.value))
            calls.append(("".join(parts), fields, kw["unit"].value,
                          isinstance(kw["vs_baseline"], ast.Constant)
                          and kw["vs_baseline"].value is None))
        out[m.group(1)] = calls
    return out


def run_main(argv, monkeypatch):
    """``bench_suite.main(argv)`` under ``SRT_SUITE_SMALL=1``: (exit code,
    the JSON lines it printed)."""
    monkeypatch.setenv("SRT_SUITE_SMALL", "1")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_suite.main(argv)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]


def check_config(p, monkeypatch):
    """Run config ``p`` on the CPU and hold its lines to JAX's; returns
    them."""
    rc, lines = run_main([p, "--device", "cpu"], monkeypatch)
    assert rc == 0, lines
    assert len(lines) == LINES[p], lines
    templates = jax_emits()[p]
    for line, (pattern, fields, unit, no_flag) in zip(lines, templates):
        assert set(line) == {"metric", "value", "unit", "vs_baseline"}
        m = re.fullmatch(pattern, line["metric"])
        assert m is not None, (line["metric"], pattern)
        for src, got in zip(fields, m.groups()):
            if src in FIELDS:
                assert got == FIELDS[src], (src, line["metric"])
        assert "pallas" not in line["metric"]
        assert line["unit"] == unit
        assert (line["vs_baseline"] is None) == no_flag
        assert math.isfinite(line["value"])
    if p in FLAGGED:
        assert all(line["vs_baseline"] == 1.0 for line in lines), lines
    return lines


def test_config1_matches_jax_oracle_parity(monkeypatch):
    import bench_suite as jax_suite
    lines = check_config("1", monkeypatch)
    monkeypatch.setattr(jax_suite, "SMALL", True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_suite.config1_oracle_parity()
    want = json.loads(buf.getvalue().splitlines()[-1])
    assert lines[0]["metric"] == want["metric"]
    assert lines[0]["value"] == pytest.approx(want["value"], rel=1e-3)
    assert lines[0]["vs_baseline"] == want["vs_baseline"]


@pytest.mark.parametrize("p", ["2", "3", "4", "5", "6"])
def test_config_lines(p, monkeypatch):
    check_config(p, monkeypatch)


def test_scaling_leaves_the_process_group_as_found():
    """The in-process world of 1 that a one-shard row starts is destroyed
    again, so the next config or caller finds what it left."""
    import torch.distributed as dist
    before = dist.is_initialized()
    rates = bench_suite._scaling(torch.device("cpu"),
                                 bench_suite.config5_case, 16)
    assert list(rates) == [1] and rates[1] > 0
    assert dist.is_initialized() == before


def test_scaling_rank_renders_over_its_world(tmp_path):
    """The multi-shard rows' rank function in a gloo world of 2 CPU
    ranks (on the card: one NCCL rank a card): each rank times the whole
    sharded render."""
    from srt_tpu_torch.parallel.launch import spawn_world
    rates = spawn_world(bench_suite._shard_rank, 2,
                        (bench_suite.config5_case, 16, "cpu"),
                        workdir=str(tmp_path), backend="gloo",
                        device="cpu", timeout=240.0, threads=1)
    assert len(rates) == 2 and all(r > 0 for r in rates)
