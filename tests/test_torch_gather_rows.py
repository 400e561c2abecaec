"""``srt_tpu_torch.ops.gather.gather_rows`` on the CPU: its plain backward
against the gradient of ``table[idx]``, gradcheck, the no-grad call, and
the dispatch that keeps any non-CPU tensor off the plain path (the kernel,
``csrc/gather_bwd.cu``, runs only on the card; ``chip_smoke.py`` compares
it with the plain version there)."""

import re

import pytest
import torch

from srt_tpu_torch.ops import cuda_lib, gather
from srt_tpu_torch.ops.gather import gather_rows


@pytest.fixture
def deterministic():
    """CPU ``index_put_`` with ``accumulate`` adds duplicates from several
    threads in no fixed order; deterministic mode fixes it, for both."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _indices(kind, k, n, gen):
    if kind == "row 0":
        return torch.zeros(n, dtype=torch.int32)
    if kind == "permutation":
        return torch.randperm(k, generator=gen).to(torch.int32)
    return torch.randint(0, k, (n,), generator=gen, dtype=torch.int32)


@pytest.mark.parametrize("kind", ["row 0", "permutation", "repeats"])
@pytest.mark.parametrize("cols,cf", [(36, True), (3, False)])
def test_plain_backward_equals_the_gradient_of_indexing(kind, cols, cf,
                                                       deterministic):
    """Bit for bit: the Function's plain backward against autograd's own
    backward of ``table[idx]`` (``.T`` for the component-first result),
    on the same upstream gradient."""
    gen = torch.Generator().manual_seed(7)
    k = 50
    n = k if kind == "permutation" else 4099
    idx = _indices(kind, k, n, gen)
    table = torch.randn((k, cols), generator=gen)
    up = torch.randn((cols, n) if cf else (n, cols), generator=gen)

    a = table.clone().requires_grad_(True)
    out = gather_rows(a, idx, cf=cf)
    out.backward(up)
    b = table.clone().requires_grad_(True)
    ref = b[idx.long()]
    (ref.T if cf else ref).backward(up)

    assert out.grad_fn.name().startswith("GatherRows")
    assert torch.equal(out, ref.T if cf else ref)
    assert torch.equal(a.grad, b.grad)


def test_gradcheck_in_float64():
    gen = torch.Generator().manual_seed(3)
    table = torch.randn((6, 4), dtype=torch.float64, generator=gen,
                        requires_grad=True)
    idx = torch.tensor([0, 0, 5, 2, 0, 5, -1, 3])
    for cf in (False, True):
        assert torch.autograd.gradcheck(
            lambda t: gather_rows(t, idx, cf=cf), (table,))


def test_without_grad_it_is_plain_indexing():
    """No GatherRows node where the table needs no grad or grad mode is
    off: the call is ``table[idx]``."""
    table = torch.randn((5, 3))
    idx = torch.tensor([4, 0, 0, 2], dtype=torch.int32)
    out = gather_rows(table, idx, cf=True)
    assert out.grad_fn is None
    assert torch.equal(out, table[idx.long()].T)
    leaf = table.clone().requires_grad_(True)
    with torch.no_grad():
        assert gather_rows(leaf, idx).grad_fn is None
    assert gather_rows(leaf, idx).grad_fn.name().startswith("GatherRows")


def test_a_device_tensor_never_takes_the_plain_path(monkeypatch):
    """Off the CPU the backward launches the kernel or raises: with the
    library missing it raises, and the plain version is never called."""
    def missing():
        raise RuntimeError("kernel library missing")

    def plain(*args):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(cuda_lib, "load", missing)
    monkeypatch.setattr(gather, "gather_rows_backward_plain", plain)
    grad = torch.empty((36, 4096), device="meta")
    idx = torch.empty((4096,), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="kernel library missing"):
        gather.gather_rows_backward(grad, idx, 100)


def test_chunk_matches_the_kernel():
    """``gather.CHUNK`` sizes the scratch the kernel writes (two rows a
    chunk): it is the kernel's threads a block times entries a thread."""
    src = (cuda_lib.CSRC / "gather_bwd.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (CHUNK_THREADS|PER) = (\d+);", src)}
    assert const["CHUNK_THREADS"] * const["PER"] == gather.CHUNK


def test_the_kernel_takes_float32_gradients_only():
    """Every gradient that reaches the kernel is float32; another dtype
    off the CPU raises before any launch."""
    grad = torch.empty((36, 4096), dtype=torch.float64, device="meta")
    idx = torch.empty((4096,), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="float32"):
        gather.gather_rows_backward(grad, idx, 100)
