"""What decides ``correct``, at sizes a test run holds: a sound run of
each entry passes, and the control (the reference in bfloat16 put in the
program's place) and every fault the cell can have fail it.  The entries
run on the CPU here, with the port's plain kernel versions."""

import time

import pytest
import torch

from srtbench import core
from srtbench.entries import inverse, render_plan, render_sharded

SEED = 2 ** 31 + 12345


def tiny(name, rows, cols, size, bench=None, **traffic):
    c = core.cell(bench or core.load_benchmark(), name)
    c.config["mesh"].update(rows=rows, cols=cols)
    c.config["camera"].update(width=size, height=size)
    c.traffic.update(traffic)
    return c


def passes(c, out) -> bool:
    return core.result_line(c, out, False)["correct"]


@pytest.fixture(scope="module")
def render_cell():
    c = tiny("headline.render", 60, 160, 32)
    c.traffic["check"]["pixels"] = 512
    return c


def test_render_sound_run_is_correct(render_cell):
    out = render_plan.run(render_cell, SEED, 0.2, False, time.perf_counter(),
                          cpu=True)
    assert passes(render_cell, out)
    assert out.window.frame_s and out.window.paths_per_frame == 32 * 32 * 4


@pytest.mark.parametrize("fault", render_plan.FAULTS)
def test_render_faults_are_not_correct(render_cell, fault):
    out = render_plan.run(render_cell, SEED, 0.2, False, time.perf_counter(),
                          cpu=True, fault=fault)
    assert not passes(render_cell, out)


def test_render_control_is_not_correct(render_cell):
    limit = render_cell.traffic["check"]["limits"]["px_off_pct"]
    (_, prog, ctrl), = render_plan.readings(render_cell, [SEED], cpu=True,
                                            control=torch.bfloat16, last=3)
    assert prog["px_off_pct"] <= limit < ctrl["px_off_pct"]


@pytest.fixture(scope="module")
def inverse_cell():
    return tiny("headline.inverse", 40, 60, 32)


def test_inverse_sound_run_is_correct(inverse_cell):
    out = inverse.run(inverse_cell, SEED, 0.3, False, time.perf_counter(),
                      cpu=True)
    assert passes(inverse_cell, out)
    assert out.window.step_s


@pytest.mark.parametrize("fault", inverse.FAULTS)
def test_inverse_faults_are_not_correct(inverse_cell, fault):
    out = inverse.run(inverse_cell, SEED, 0.3, False, time.perf_counter(),
                      cpu=True, fault=fault)
    assert not passes(inverse_cell, out)


def test_inverse_control_is_not_correct(inverse_cell):
    lim = inverse_cell.traffic["check"]["limits"]
    (_, prog, ctrl), = inverse.readings(inverse_cell, [SEED], cpu=True,
                                        control=torch.bfloat16)
    assert all(prog[k] <= lim[k] for k in lim)
    assert any(ctrl[k] > lim[k] for k in lim)


@pytest.fixture
def sharded_cell(bench_x4):
    c = tiny("headline_x4.render", 16, 24, 16, bench_x4)
    c.chips = 2
    c.traffic["check"]["pixels"] = 128
    return c


@pytest.mark.parametrize("fault", (None,) + render_sharded.FAULTS)
def test_sharded_run_and_its_fault(sharded_cell, fault):
    out = render_sharded.run(sharded_cell, SEED, 0.1, False,
                             time.perf_counter(), cpu=True, fault=fault)
    assert out.device["forbidden"] == []
    out.device.pop("forbidden")
    assert passes(sharded_cell, out) == (fault is None)
