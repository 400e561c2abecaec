"""The port's ``bench`` and tools (``srt_tpu_torch/bench.py``,
``srt_tpu_torch/tools/render_demo.py``, ``interactive_session.py``) on the
CPU at tiny sizes: ``bench`` prints one line with JAX's four keys, and
its rate divides by the rays of the plan's ``stats`` for the last key
(the same plan built by hand gives the same count); ``render_demo``
writes both images, not flat; ``interactive_session`` prints a JSON line
a case with finite frame rates, and writes them only where asked.
Without a card and ``--device cpu`` every entry point exits nonzero and
prints nothing.
"""

import contextlib
import io
import json
import math
import os

import numpy as np
import pytest
import torch

from srt_tpu_torch import bench, bench_suite
from srt_tpu_torch.config import CameraConfig, RenderConfig
from srt_tpu_torch.models import mesh
from srt_tpu_torch.models.fastpath import make_render_plan
from srt_tpu_torch.ops import rng
from srt_tpu_torch.scene import model_scene_lights
from srt_tpu_torch.tools import interactive_session, render_demo
from srt_tpu_torch.utils.flatten import flatten_models
from srt_tpu_torch.utils.image import read_ppm
from srt_tpu_torch.utils.procgen import uv_sphere

SMALL_BENCH = {"SRT_BENCH_ROWS": "20", "SRT_BENCH_COLS": "30",
               "SRT_BENCH_SIZE": "64", "SRT_BENCH_REPS": "2"}


def stdout_of(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue().splitlines()


@pytest.fixture
def small_bench(monkeypatch):
    for k, v in SMALL_BENCH.items():
        monkeypatch.setenv(k, v)


def test_bench_prints_one_line(small_bench):
    rc, lines = stdout_of(bench.main, ["--device", "cpu"])
    assert rc == 0 and len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == ("fwd Mrays/s/chip, 4-bounce path tracing, "
                             "1140-tri BVH scene (64x64, spp=1, library "
                             "fastpath)")
    assert rec["unit"] == "Mrays/s"
    assert math.isfinite(rec["value"]) and rec["value"] >= 0.0


def test_bench_counts_the_plans_rays(small_bench):
    _, _, rays = bench.run("cpu")
    scene = mesh.upload(flatten_models([uv_sphere(20, 30, radius=2.0)],
                                       pad_to=128), "cpu")
    cam = CameraConfig(width=64, height=64, origin=(0.0, 1.0, 5.0),
                       look_at=(0.0, 0.0, 0.0))
    plan = make_render_plan(scene, model_scene_lights("cpu"), cam,
                            RenderConfig(max_depth=4, rr_bounces=0, spp=1))
    _, stats, overflow = plan.render(rng.key(2, "cpu"))  # the last rep's
    assert int(overflow) == 0
    assert rays == int(stats.sum()) > 64 * 64


def read_image(path):
    if path.endswith(".ppm"):
        return read_ppm(path)
    from PIL import Image
    return np.asarray(Image.open(path), np.float32) / 255.0


def test_render_demo_writes_both_images(tmp_path):
    rc, lines = stdout_of(render_demo.main, [
        "--device", "cpu", "--size", "16", "--spp", "1",
        "--out", str(tmp_path)])
    assert rc == 0 and len(lines) == 2
    names = sorted(os.listdir(tmp_path))
    assert [n.split(".")[0] for n in names] == ["highpoly", "rubik"]
    for name in names:
        img = read_image(str(tmp_path / name))
        assert img.shape == (16, 16, 3)
        assert np.isfinite(img).all() and img.std() > 0.0


def test_interactive_session_prints_fps(tmp_path):
    out = tmp_path / "session.jsonl"
    rc, lines = stdout_of(interactive_session.main, [
        "--device", "cpu", "--sizes", "16", "--frames", "2",
        "--out", str(out)])
    assert rc == 0
    recs = [json.loads(ln) for ln in lines]
    assert [r["case"] for r in recs] == ["headline-102k-16", "rubik-16x12"]
    for r in recs:
        assert r["frames_accumulated"] == 3
        assert all(math.isfinite(r[k]) and r[k] > 0.0
                   for k in ("fps", "fps_after_move",
                             "frame_plus_host_fetch_ms"))
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == recs


@pytest.mark.parametrize("main", [bench.main, bench_suite.main,
                                  render_demo.main, interactive_session.main])
def test_entry_points_need_a_card_or_device_cpu(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines = stdout_of(main, [])
    assert rc != 0 and lines == []
