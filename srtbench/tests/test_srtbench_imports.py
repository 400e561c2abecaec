"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package,
compared by whole top-level names; the references load nothing of the
port either."""

import os
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "srt_tpu"}


def _top_level(code: str) -> set:
    probe = code + ("\nimport sys\n"
                    "print(' '.join(sorted({m.split('.')[0] "
                    "for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_and_port_load_no_jax():
    names = _top_level(
        "import srtbench.run, srtbench.core, srtbench.control\n"
        "import srtbench.entries.render_plan, srtbench.entries.inverse\n"
        "import srtbench.entries.render_sharded, srtbench.entries.common\n"
        "import srt_tpu_torch.models.fastpath, srt_tpu_torch.optim\n"
        "import srt_tpu_torch.parallel.render_sharded\n"
        "from srtbench import core\n"
        "b = core.load_benchmark()\n"
        "[core.metric_reader(m['name']) for m in b['per_layer']]\n"
        "[core.e2e_reader(m['name']) for m in b['end_to_end']]\n")
    assert "srt_tpu_torch" in names and "srtbench" in names
    assert not names & FORBIDDEN


def test_references_load_nothing_of_the_port():
    names = _top_level(
        "import srtbench.reference.pathtrace, srtbench.reference.judge\n"
        "import srtbench.lib.threefry, srtbench.lib.walkwork\n"
        "import srtbench.lib.uvsphere, srtbench.lib.trace\n")
    assert not names & (FORBIDDEN | {"srt_tpu_torch"})


def test_the_check_compares_whole_names(monkeypatch):
    from srtbench import core

    base = set(core.forbidden_loaded())
    for name in ("jaxtools", "srt_tpu_torch_extra", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(core.forbidden_loaded()) == base
    monkeypatch.setitem(sys.modules, "srt_tpu.models",
                        types.ModuleType("srt_tpu.models"))
    assert "srt_tpu" in core.forbidden_loaded()
