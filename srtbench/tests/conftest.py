"""Tests of the benchmark.  ``card`` marks a test that needs a CUDA card;
it skips here from inside its fixture, never while a module is
imported."""

import copy

import pytest

# The four-card cell that BENCHMARK.json leaves out for now: its files are
# all here, so the benchmark takes it back with these entries alone.
X4_CONFIG = {"name": "headline_x4", "source": "a test",
             "file": "srtbench/configs/headline_x4.json",
             "reduced": ["mesh", "camera", "render"], "why": "a test"}
X4_CELL = {"name": "headline_x4.render", "config": "headline_x4",
           "traffic": "render_sharded", "chips": 4, "why": "a test"}
X4_METRICS = [
    {"name": "dispatch_ms.x4", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "sharded integrator "
     "(parallel/render_sharded, models/pathtracer.trace_wavefront)",
     "moves": "mpaths_s", "workloads": ["headline_x4.render"]},
    {"name": "allgather_ms.x4", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "collective "
     "(parallel/render_sharded._GatherRays, NCCL all-gather)",
     "moves": "mpaths_s", "workloads": ["headline_x4.render"]}]
X4_ALSO = ("mpaths_s", "frame_ms_p95", "idle_pct.frame")


def with_x4(bench: dict) -> dict:
    """``bench`` with the four-card cell, its configuration and its
    metrics added."""
    bench = copy.deepcopy(bench)
    bench["configs"].append(dict(X4_CONFIG))
    bench["workloads"].append(dict(X4_CELL))
    bench["per_layer"] += copy.deepcopy(X4_METRICS)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in X4_ALSO:
            m["workloads"].append(X4_CELL["name"])
    return bench

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def bench_x4():
    """BENCHMARK.json with the four-card cell added."""
    from srtbench import core

    return with_x4(core.load_benchmark())
