"""Checkpoint / resume for scene parameters and optimizer state
(counterpart of ``srt_tpu/utils/checkpoint.py``).

A tree (the trainer's parameter trees: the port's dataclasses, tuples,
lists and dicts of tensors) is saved as npz: its tensor leaves, in
``optim._leaves_with_paths`` order, and a JSON ``__meta__`` entry.
Restoring takes the structure from a template tree, as the JAX package's
does.  Only process 0 writes when ``torch.distributed`` is initialised.
``save_async`` overlaps the disk write with training: the device->host
copy is taken at once, the npz write runs on a background thread.

A torch optimizer holds no per-parameter state before its first step, so
no template can carry that state's structure: ``save_train_state``
writes its layout into the meta, and ``restore_train_state`` rebuilds it
from there, exactly (every tensor of ``optimizer.state_dict()["state"]``
bit for bit), so that a resumed run equals an uninterrupted one.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from srt_tpu_torch.optim import _leaves_with_paths, _rebuild

_async_executor = None


def _leaves(tree):
    return [x for _, x in _leaves_with_paths(tree)]


def _writes() -> bool:
    """False on every process but rank 0 of an initialised process
    group."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def save(path: str, tree: Any, extra: Optional[dict] = None) -> None:
    """Save the tensor leaves of ``tree`` (and JSON-able extras) to
    ``path`` (npz), written to a temporary file and moved into place."""
    if not _writes():
        return
    leaves = _leaves(tree)
    payload = {f"leaf_{i}": x.detach().cpu().numpy()
               for i, x in enumerate(leaves)}
    payload["__meta__"] = np.frombuffer(
        json.dumps({"n": len(leaves), "extra": extra or {}}).encode(),
        np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def save_async(path: str, tree: Any, extra: Optional[dict] = None):
    """Non-blocking ``save``: copies the tree's tensors to host memory now
    and writes on a background thread.  Returns a future (``.result()``
    joins, and raises what the write raised); writes to one path
    serialise on the single worker thread."""
    global _async_executor
    host_tree = _rebuild(tree, iter([x.detach().to("cpu", copy=True)
                                     for x in _leaves(tree)]))
    if _async_executor is None:
        _async_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="srt-ckpt")
    return _async_executor.submit(save, path, host_tree, extra)


def load(path: str):
    """(leaves as numpy arrays, extra), or None if ``path`` is missing."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["n"])]
    return leaves, meta.get("extra", {})


def restore_into(template: Any, leaves) -> Any:
    """``template`` with its tensor leaves replaced by the saved
    ``leaves``, each on its template leaf's device."""
    slots = _leaves(template)
    if len(slots) != len(leaves):
        raise ValueError(f"checkpoint holds {len(leaves)} tensors, the "
                         f"template {len(slots)}")
    return _rebuild(template, iter([
        torch.as_tensor(np.asarray(x), device=t.device)
        for x, t in zip(leaves, slots)]))


def _state_layout(state: dict) -> list:
    """The JSON layout of ``optimizer.state_dict()["state"]``: per
    parameter index, the names of its tensors and its other values."""
    return [[i, {k: None if isinstance(v, torch.Tensor) else {"value": v}
                 for k, v in entry.items()}]
            for i, entry in state.items()]


def _state_template(layout: list) -> dict:
    return {int(i): {k: torch.empty(0) if v is None else v["value"]
                     for k, v in entry.items()}
            for i, entry in layout}


def save_train_state(path: str, params, opt_state: dict, step: int) -> None:
    """Save the trained leaves ``params`` and ``opt_state``
    (``optimizer.state_dict()``) at ``step``."""
    state = opt_state["state"]
    save(path, (params, state),
         extra={"step": int(step), "opt_state": _state_layout(state)})


def restore_train_state(restored, params_template, opt_state_template):
    """-> (params, opt_state, step).  ``params`` take the template's
    structure; ``opt_state`` is ``opt_state_template`` (the state dict of
    the resuming optimizer, whose ``param_groups`` hold the
    hyperparameters) with the saved per-parameter ``state``, for
    ``optimizer.load_state_dict``."""
    leaves, extra = restored
    state = _state_template(extra["opt_state"])
    params, state = restore_into((params_template, state), leaves)
    return (params, {**opt_state_template, "state": state},
            int(extra.get("step", 0)))
