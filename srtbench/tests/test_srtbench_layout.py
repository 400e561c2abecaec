"""BENCHMARK.json against the files of the benchmark, and a cell, a mix
and a metric added as files alone."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from srtbench import core
from srtbench.tests.conftest import with_x4

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module", params=["as_committed", "with_x4"])
def bench(request):
    bench = core.load_benchmark(ROOT)
    return with_x4(bench) if request.param == "with_x4" else bench


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["srtbench"]


def test_every_file_is_found_by_name(bench):
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("srtbench/")
    for w in bench["workloads"]:
        cell = core.cell(bench, w["name"], ROOT)
        core.entry(cell.traffic["entry"])
        assert cell.chips in (1, 4)
    for m in bench["end_to_end"]:
        assert callable(core.e2e_reader(m["name"]).read)
    for m in bench["per_layer"]:
        assert callable(core.metric_reader(m["name"]).read)


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    for c in bench["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)
        assert 1 <= len(c["source"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_moves_reported_by_every_cell(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        target = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert "workloads" not in target or c in target["workloads"], \
                (m["name"], c)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = core.cell(bench, w["name"], ROOT)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_metric_files_agree(bench):
    for m in bench["per_layer"]:
        mod = core.metric_reader(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                   m["moves"])


def test_added_files_are_picked_up(tmp_path):
    """A configuration, a traffic mix and a metric dropped into a copy
    are found without editing any file that was there."""
    shutil.copytree(ROOT / "srtbench", tmp_path / "srtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "srtbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "srtbench/configs/headline.json").read_text())
    conf["name"] = "small"
    conf["mesh"].update(rows=40, cols=60)
    (tmp_path / "srtbench/configs/small.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "srtbench/traffic/render.json").read_text())
    mix["overrides"]["render"]["spp"] = 2
    (tmp_path / "srtbench/traffic/render2.json").write_text(json.dumps(mix))
    (tmp_path / "srtbench/metrics/frames_traced.py").write_text(
        'UNIT = "frames"\nLAYER = "device"\nMOVES = "mpaths_s"\n\n\n'
        "def read(r):\n    return float(r.steps)\n")
    bench["configs"].append({"name": "small", "source": "a test",
                             "file": "srtbench/configs/small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "small.render2", "config": "small",
                               "traffic": "render2", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "mpaths_s",
                               "workloads": ["small.render2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from srtbench import core; import types\n"
            "b = core.load_benchmark()\n"
            "c = core.cell(b, 'small.render2')\n"
            "r = types.SimpleNamespace(steps=3)\n"
            "print(c.config['mesh']['rows'], c.config['render']['spp'],"
            " [m['name'] for m in c.per_layer],"
            " core.metric_reader('frames_traced').read(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["40", "2", "['scene_build_s',",
                                  "'frames_traced']", "3.0"]
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_configuration_on_a_base(bench_x4):
    """``headline_x4`` names ``headline`` as its base and holds only what
    differs: the scene is written once."""
    raw = json.loads((ROOT / "srtbench/configs/headline_x4.json").read_text())
    assert raw["base"] == "headline" and "mesh" not in raw
    one = core.cell(bench_x4, "headline.render", ROOT).config
    four = core.cell(bench_x4, "headline_x4.render", ROOT).config
    for group in ("mesh", "material", "lights", "pad_to", "precision"):
        assert four[group] == one[group]
    assert (four["chips"], four["camera"]["width"]) == (4, 4096)
    assert {k: v for k, v in four["camera"].items() if k not in
            ("width", "height")} == {k: v for k, v in one["camera"].items()
                                     if k not in ("width", "height")}
    assert four["assumed"]["mesh"] == one["assumed"]["mesh"]
