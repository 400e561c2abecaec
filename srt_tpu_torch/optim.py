"""Inverse-rendering optimizer loop (counterpart of ``srt_tpu/optim.py``).

Recover scene parameters (sphere geometry, materials, lights, mesh
vertices, camera pose) from target images by gradient descent through the
renderer, with ``torch.autograd`` and a ``torch.optim`` optimizer (Adam by
default, with optax's defaults).

Parameters are a tree of the port's frozen dataclasses (``Spheres``,
``Materials``, ``Lights``, ``MeshScene``), tuples, lists and dicts, whose
leaves are tensors; other values (ints, tuples of ints, None) are static.
``float_partition`` splits out the floating-point leaves, so bool and
int tensors are never trained.  Leaf paths are spelled as JAX's
``keystr`` spells them: ``".materials.albedo"``, ``"[1]"``, ``"['a']"``.
``run_inverse_rendering(checkpoint_path=...)`` saves and resumes the
trained leaves and the optimizer state (``utils/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from srt_tpu_torch.ops import rng
from srt_tpu_torch.utils.profiling import span


def _leaves_with_paths(tree, path: str = ""):
    """(path, tensor) for every tensor leaf, in the order ``_rebuild``
    takes them back: dataclass fields in definition order, dict keys
    sorted, sequences in order."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pl for f in dataclasses.fields(tree)
                for pl in _leaves_with_paths(getattr(tree, f.name),
                                             f"{path}.{f.name}")]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _leaves_with_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [pl for i, x in enumerate(tree)
                for pl in _leaves_with_paths(x, f"{path}[{i}]")]
    return []


def _rebuild(tree, leaves):
    """``tree`` with its tensor leaves replaced, in order, from the
    iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return tree


def float_partition(params: Any, trainable: Optional[Callable] = None
                    ) -> Tuple[List[torch.Tensor], Callable]:
    """Split a parameter tree into its trainable float leaves and a merge
    function.

    Returns (float_leaves, merge), where ``merge(new_float_leaves)``
    rebuilds the whole tree with the other leaves unchanged.
    ``trainable(path_str, leaf) -> bool`` restricts which float leaves are
    optimized (for example ``lambda p, _: "albedo" in p``); None trains
    every float leaf."""
    with_path = _leaves_with_paths(params)
    leaves = [leaf for _, leaf in with_path]
    float_idx = [
        i for i, (path, leaf) in enumerate(with_path)
        if leaf.is_floating_point()
        and (trainable is None or trainable(path, leaf))
    ]

    def merge(new_float_leaves):
        out = list(leaves)
        for i, v in zip(float_idx, new_float_leaves):
            out[i] = v
        return _rebuild(params, iter(out))

    return [leaves[i] for i in float_idx], merge


@dataclasses.dataclass
class InverseRenderResult:
    params: Any
    losses: list
    steps: int


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    merge: Callable, project_fn: Optional[Callable] = None,
                    trainable: Optional[Callable] = None):
    """One update of the float leaves that ``optimizer`` holds.

    ``loss_fn(full_params, target, key) -> scalar``;
    ``step(float_leaves, target, key) -> (float_leaves, loss)`` updates
    the leaves in place and returns them with the detached loss (taken
    before the update).  ``project_fn(full_params) -> full_params`` runs
    after the update and its float leaves are copied back, keeping
    parameters in their physical domain (for example roughness > 0)."""

    def step(float_leaves, target, key):
        with span("srt.forward"):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(merge(float_leaves), target, key)
        with span("srt.backward"):
            loss.backward()
        with span("srt.update"):
            optimizer.step()
            if project_fn is not None:
                with torch.no_grad():
                    projected, _ = float_partition(
                        project_fn(merge(float_leaves)), trainable)
                    for leaf, new in zip(float_leaves, projected):
                        leaf.copy_(new)
        return float_leaves, loss.detach()

    return step


def clamp_sphere_scene(scene):
    """Default projection for ``Spheres`` scenes: colors to [0, 1],
    roughness to [1e-3, 1], metalness to [0, 1], radii at least 1e-3."""
    m = scene.materials
    return dataclasses.replace(
        scene,
        radius=torch.clamp_min(scene.radius, 1e-3),
        materials=dataclasses.replace(
            m,
            albedo=torch.clamp(m.albedo, 0.0, 1.0),
            specular=torch.clamp(m.specular, 0.0, 1.0),
            roughness=torch.clamp(m.roughness, 1e-3, 1.0),
            metalness=torch.clamp(m.metalness, 0.0, 1.0),
        ),
    )


def _adam(learning_rate: float):
    """``optax.adam(learning_rate)``'s defaults as a torch optimizer
    factory."""
    return lambda leaves: torch.optim.Adam(
        leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def run_inverse_rendering(
    render_fn: Callable,
    init_params: Any,
    target,
    key,
    steps: int = 200,
    learning_rate: float = 5e-2,
    optimizer: Optional[Callable] = None,
    loss_fn: Optional[Callable] = None,
    project_fn: Optional[Callable] = None,
    trainable: Optional[Callable] = None,
    fixed_noise: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 50,
    log_every: int = 25,
    callback: Optional[Callable] = None,
) -> InverseRenderResult:
    """The optimization loop, with optional checkpoint/resume.

    ``render_fn(params, key) -> image``; the loss defaults to the image
    MSE against ``target``.  ``optimizer(float_leaves) ->
    torch.optim.Optimizer`` builds the optimizer over the trained leaves
    (default: Adam at ``learning_rate``, betas (0.9, 0.999), eps 1e-8,
    as ``optax.adam``).  ``init_params`` is not changed: the trained
    leaves are copies.

    ``fixed_noise=True`` renders every step with ``key`` (the render is
    then a deterministic function of the parameters, as it must be at low
    spp when the target was rendered with the same key); False uses
    ``rng.fold_in(key, i)`` at step i.  ``callback(i, params, loss)`` runs
    after each step; ``log_every`` prints the loss every that many
    steps (0: never).

    ``checkpoint_path``: a checkpoint there is resumed from its step (the
    trained leaves and the optimizer state restored exactly, so the run
    goes on as an uninterrupted one would); the state is saved there
    every ``checkpoint_every`` steps and at the end.  ``losses`` holds
    the steps this call ran."""
    # Imported here: utils/checkpoint imports this module's tree walk.
    from srt_tpu_torch.utils import checkpoint as ckpt

    make_optimizer = optimizer or _adam(learning_rate)
    if loss_fn is None:
        def loss_fn(params, target, key):  # noqa: F811
            img = render_fn(params, key)
            return torch.mean((img - target) ** 2)

    float_leaves, merge = float_partition(init_params, trainable)
    float_leaves = [x.detach().clone().requires_grad_(True)
                    for x in float_leaves]
    optimizer = make_optimizer(float_leaves)
    start_step = 0
    if checkpoint_path is not None:
        restored = ckpt.load(checkpoint_path)
        if restored is not None:
            saved, opt_state, start_step = ckpt.restore_train_state(
                restored, float_leaves, optimizer.state_dict())
            with torch.no_grad():
                for leaf, x in zip(float_leaves, saved):
                    leaf.copy_(x)
            optimizer.load_state_dict(opt_state)
    step_fn = make_train_step(loss_fn, optimizer, merge, project_fn,
                              trainable)

    losses = []
    for i in range(start_step, steps):
        step_key = key if fixed_noise else rng.fold_in(key, i)
        float_leaves, loss = step_fn(float_leaves, target, step_key)
        losses.append(float(loss))
        if log_every and i % log_every == 0:
            print(f"[inverse-render] step {i}: loss {losses[-1]:.4e}")
        if callback is not None:
            callback(i, merge(float_leaves), losses[-1])
        if checkpoint_path is not None and (i + 1) % checkpoint_every == 0:
            ckpt.save_train_state(checkpoint_path, float_leaves,
                                  optimizer.state_dict(), i + 1)

    if checkpoint_path is not None:
        ckpt.save_train_state(checkpoint_path, float_leaves,
                              optimizer.state_dict(), steps)
    return InverseRenderResult(
        params=merge([x.detach() for x in float_leaves]), losses=losses,
        steps=steps)
