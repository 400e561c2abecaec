"""``srt_tpu_torch.ops.cuda_lib.launch`` on the CPU: a stub library in
place of the built one, the stream and device getters replaced, so that
the binding's contract (pointers, ints, None, the stream last, the count,
the raise, the device switch) is checked without a card."""

import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from srt_tpu_torch.ops import cuda_lib


@pytest.fixture
def stub(monkeypatch):
    """A stub library whose ``add_one`` records its arguments and returns
    ``ns.ret``; the current device is ``ns.current`` (a CPU tensor's
    ``get_device()`` is -1), the stream of device i is 0x5000 + i."""
    ns = types.SimpleNamespace(calls=[], ret=0, current=-1, switched=[])

    def add_one(*args):
        ns.calls.append((args, list(ns.switched)))
        return ns.ret

    lib = cuda_lib.Library(
        lib=types.SimpleNamespace(srt_error_string=lambda code: b"stub"),
        path=Path("stub.so"), build_seconds=0.0, log="",
        functions={"add_one": add_one})
    monkeypatch.setattr(cuda_lib, "load", lambda: lib)
    monkeypatch.setattr(cuda_lib, "_raw_stream", lambda index: 0x5000 + index)
    monkeypatch.setattr(cuda_lib, "_current_device", lambda: ns.current)
    return ns


def test_launch_passes_pointers_ints_none_and_the_stream_last(stub):
    x, o = torch.zeros(8), torch.zeros(8)
    before = cuda_lib.launch_counts["add_one"]
    cuda_lib.launch("add_one", x, None, o, 8, 1)
    assert stub.calls == [((x.data_ptr(), None, o.data_ptr(), 8, 1,
                            0x5000 - 1), [])]
    assert cuda_lib.launch_counts["add_one"] == before + 1


def test_launch_raises_on_a_failed_launch_and_does_not_count(stub):
    stub.ret = 700
    before = cuda_lib.launch_counts["add_one"]
    with pytest.raises(RuntimeError, match=r"add_one failed .*stub \(700\)"):
        cuda_lib.launch("add_one", torch.zeros(4), torch.zeros(4), 4, 1)
    assert cuda_lib.launch_counts["add_one"] == before


def test_launch_switches_device_only_when_not_current(stub, monkeypatch):
    """The tensors' device is entered for the call when another device is
    current, and not otherwise; the stream is the tensors' device's."""

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            stub.switched.append(self.index)

        def __exit__(self, *exc):
            stub.switched.pop()

    monkeypatch.setattr(torch.cuda, "device", Device)
    x = torch.zeros(4)
    cuda_lib.launch("add_one", x, x, 4, 1)
    stub.current = 3
    cuda_lib.launch("add_one", x, x, 4, 1)
    assert [c[1] for c in stub.calls] == [[], [-1]]
    assert {c[0][-1] for c in stub.calls} == {0x5000 - 1}
    assert stub.switched == []


def test_load_resolves_every_entry_point_once(tmp_path, monkeypatch):
    """``load`` (on a library already built, here a stub CDLL) resolves
    each ``srt_<name>`` once into ``functions[name]``, its argument types
    set; every kernel of ``launch_counts`` has one."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    digest = cuda_lib._digest(sorted(cuda_lib.CSRC.glob("*.cu*")))
    (tmp_path / f"libsrt_tpu_torch_{digest}.so").write_bytes(b"")

    class CDLL:
        def __init__(self, path):
            for name in [*cuda_lib.SIGNATURES, "srt_error_string"]:
                setattr(self, name, types.SimpleNamespace(name=name))

    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", CDLL)
    lib = cuda_lib.load.__wrapped__()
    assert lib.build_seconds == 0.0
    for name, argtypes in cuda_lib.SIGNATURES.items():
        fn = lib.functions[name[4:]]
        assert fn is getattr(lib.lib, name) and fn.argtypes == argtypes
    kernels = set(cuda_lib.launch_counts) - set(cuda_lib.BRANCH_COUNTERS)
    assert set(lib.functions) == kernels


def _ctype(decl):
    if "*" in decl:
        return ctypes.c_void_p
    if "long long" in decl:
        return ctypes.c_longlong
    if "unsigned" in decl:
        return ctypes.c_uint
    return ctypes.c_int if re.search(r"\bint\b", decl) else decl


def test_signatures_match_the_c_entry_points():
    """Each ``extern "C" int srt_<name>(...)`` of ``csrc`` has a
    ``SIGNATURES`` entry with its arguments' ctypes, in order, and no entry
    lacks its source: an argument added or dropped on one side alone would
    shift every later argument of the call."""
    src = "".join(p.read_text() for p in sorted(cuda_lib.CSRC.glob("*.cu*")))
    found = {m.group(1): [_ctype(a) for a in m.group(2).split(",")]
             for m in re.finditer(r'extern "C" int (srt_\w+)\(([^)]*)\)',
                                  src)}
    assert found == cuda_lib.SIGNATURES
