"""``srt_tpu_torch/tools/multihost_2proc.py`` (the port of
``tools/multihost_2proc.py``) on the CPU: a gloo world of 2 spawned
ranks, each rendering its tile of ``uv_sphere(12, 18)`` at 64 x 32 and
all-gathering the image, against the same render in one process.

Both ranks must assemble the same image (equal sha), bit for bit equal to
the one-process image (``dense``, and ``walk`` through the kernels' plain
versions); the report and each rank's entry carry JAX's keys, read from
its source with ``ast`` (the port adds ``device`` and ``launches``).  The
one-process image is held against JAX's ``render_multihost`` of its
``_scene_setup`` (8 virtual CPU devices, ``jax.disable_jit()``) by the
image criterion of ``tests/test_torch_spheres.py``.
"""

import ast
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from srt_tpu.models import mesh as jax_mesh
from srt_tpu.parallel import device_mesh as jax_device_mesh
from srt_tpu.parallel.multihost import render_multihost as jax_multihost
from srt_tpu_torch.tools import multihost_2proc
from tests.test_torch_spheres import assert_images_match

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "multihost_2proc.py")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """The report of a dense and of a walk world of 2, each written to
    ``--out``; the listing of ``tools/`` before and after."""
    tmp = tmp_path_factory.mktemp("mh")
    before = sorted(os.listdir(os.path.join(ROOT, "tools")))
    out = {}
    for method in multihost_2proc.METHODS:
        path = str(tmp / f"{method}.json")
        rep = multihost_2proc.run("cpu", method, out=path,
                                  workdir=str(tmp / method), threads=1,
                                  verbose=False)
        assert len(rep) == 1
        out[method] = (rep[0], path)
    return out, before, sorted(os.listdir(os.path.join(ROOT, "tools")))


def jax_dict_keys(func, name):
    """The keys of the dict literal assigned to ``name`` in JAX's
    ``func``."""
    tree = ast.parse(open(JAX_TOOL).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == name)
    return {k.value for k in node.value.keys}


@pytest.mark.parametrize("method", multihost_2proc.METHODS)
def test_two_ranks_assemble_one_image(reports, method):
    rep = reports[0][method][0]
    ranks = rep["per_process"]
    assert [r["proc"] for r in ranks] == [0, 1]
    assert all(r["process_count"] == 2 and r["local_devices"] == 1
               and r["method"] == method for r in ranks)
    assert len({r["image_sha"] for r in ranks}) == 1
    assert ranks[0]["image_sum"] == ranks[1]["image_sum"] > 0.0
    assert rep["assembled_identically_on_all_processes"]


@pytest.mark.parametrize("method", multihost_2proc.METHODS)
def test_world_of_two_is_bit_equal_to_one_process(reports, method):
    rep = reports[0][method][0]
    assert rep["bit_equal_to_single_process"]
    assert rep["max_abs_diff"] == 0.0
    t1, t2 = rep["single_process_frame_s"], rep["multi_process_tile_s"]
    assert t1 > 0 and t2 > 0
    assert rep["scaling_efficiency"] == pytest.approx(t1 / (2 * t2))
    assert math.isfinite(rep["scaling_efficiency"])
    assert rep["device"] == "cpu"


def test_report_has_jax_keys(reports):
    rep = reports[0]["dense"][0]
    assert set(rep) - {"device"} == jax_dict_keys("parent", "report")
    for r in rep["per_process"]:
        assert set(r) - {"launches"} == jax_dict_keys("child", "out")
    assert rep["image"] == "64x32" and rep["processes"] == 2


def test_report_is_written_to_out_only(reports):
    """The JSON goes to ``--out``; nothing is written into ``tools/``."""
    out, before, after = reports
    for rep, path in out.values():
        with open(path) as f:
            assert json.load(f) == json.loads(json.dumps(rep))
    assert before == after


def test_one_process_image_matches_jax():
    img = multihost_2proc.single_process(torch.device("cpu"), "dense")[0]
    tree = ast.parse(open(JAX_TOOL).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_scene_setup")
    consts = {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign)
              and getattr(n.targets[0], "id", None) in ("SIZE", "SEED")}
    assert consts == dict(SIZE=multihost_2proc.SIZE,
                          SEED=multihost_2proc.SEED)
    env = dict(METHOD="dense", **consts)
    exec(compile(ast.fix_missing_locations(
        ast.Module(body=[fn], type_ignores=[])), JAX_TOOL, "exec"), env)
    scene, lights, cam, cfg = env["_scene_setup"]()
    with jax.disable_jit():
        want = jax_multihost(
            lambda s: jax_mesh.mesh_hit_fn(s, method="dense",
                                           kernel_tile=128),
            scene, lights, cam, cfg, jax.random.key(multihost_2proc.SEED),
            jax_device_mesh())
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert_images_match(torch.as_tensor(img), want)


def test_unknown_method_is_refused():
    with pytest.raises(ValueError):
        multihost_2proc.run("cpu", "pallas", verbose=False)
