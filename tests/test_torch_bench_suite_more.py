"""The port's benchmark suite on the CPU, configs 7-11, and the loop's
rules: a config that raises prints ``configN FAILED`` and the others
still run, with exit code 1; without a card and ``--device cpu`` the
suite runs nothing and exits nonzero.  What each config's lines are held
to: ``tests/test_torch_bench_suite.py``.
"""

import pytest
import torch

from srt_tpu_torch import bench_suite
from tests.test_torch_bench_suite import check_config, run_main


@pytest.mark.parametrize("p", ["7", "8", "9", "10", "11"])
def test_config_lines(p, monkeypatch):
    check_config(p, monkeypatch)


def test_failed_config_keeps_the_suite_going(monkeypatch):
    def boom(dev):
        raise ValueError("boom on " + dev.type)

    monkeypatch.setitem(bench_suite.ALL, "3", boom)
    rc, lines = run_main(["3", "1", "--device", "cpu"], monkeypatch)
    assert rc == 1
    assert lines[0] == {"metric": "config3 FAILED", "value": 0.0,
                        "unit": "boom on cpu", "vs_baseline": 0.0}
    assert len(lines) == 2 and lines[1]["metric"].startswith("config1 ")


def test_no_card_without_device_cpu_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines = run_main(["1"], monkeypatch)
    assert rc != 0 and lines == []
