"""On the card: one short run of each one-card cell as its command starts
it, ending in one JSON result line with its keys in order.  Run there with
``python3 -m pytest srtbench/tests -m card``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["headline.render", "headline.inverse"])
def test_a_short_run_prints_one_result(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "srtbench.run", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] and line["device"]["platform"] == "gpu"
