"""Train-step builders: forward, loss, backward and one optimizer update,
for one step or through an autoregressive rollout.

Counterpart of ``make_train_step`` and ``make_rollout_train_step`` in
``anemoi_models_tpu/training/step.py``.
The model owns its parameters and the optimizer (:func:`make_optimizer`) its
moments and update count, so the step is a closure over both instead of a
pure function of a ``TrainState``. On the card the edge attention runs its
hand-written kernels forward and backward; the processor's chunks are
recomputed in the backward as the model's ``remat_policy`` says.

Under a (data, model) mesh (``parallel.use_mesh``) the step is the sharded
one: each rank's batch is its slice of the data axis and its grid its rows
of the model axis, its loss a partial (``training.loss``), and before the
update every replicated parameter's gradient is summed over ``model`` and
averaged over ``data`` (:func:`~anemoi_models_tpu_torch.parallel.primitives.all_reduce_gradients`),
the one reduction GSPMD makes for the JAX package that the port makes by
hand. The loss returned is the whole grid's, averaged over ``data``. Given a
ZeRO-1 / FSDP ``plan`` (``parallel.fsdp.shard_train_state``) the step runs
the reduction, then the sharded update (the optimizer updates this rank's
slices), then the gather of the updated slices (``plan.sync_params``); with
no plan it is the replicated step, bit for bit.

A model built with ``deterministic=False`` (:func:`dropout_twin`) trains with
attention-weight dropout: the step's key is :func:`dropout_key_at` of the
seed and the optimizer's update count, as the JAX package folds the step
into its key (``_dropout_rng_for``), so a resumed run draws the masks the
uninterrupted one would.

:func:`resolve_remat_policy` resolves ``remat_policy="auto"``: it keeps
``"none"`` when a step's estimated memory fits the device, else ``"full"``.
"""

from __future__ import annotations

from typing import Callable, Optional

import copy
import itertools

import numpy as np
import torch
from torch import nn

from anemoi_models_tpu_torch.layers.remat import count_saved_bytes
from anemoi_models_tpu_torch.ops.flash_attention import fold_key
from anemoi_models_tpu_torch.parallel.api import get_mesh
from anemoi_models_tpu_torch.parallel.primitives import all_reduce_gradients, reduce_tensor
from anemoi_models_tpu_torch.training.loss import weighted_mse
from anemoi_models_tpu_torch.training.rollout import make_rollout_fn

__all__ = ["dropout_key_at", "dropout_twin", "estimate_step_bytes", "make_rollout_train_step", "make_train_step",
           "mesh_loss", "resolve_remat_policy"]


def dropout_key_at(dropout_seed: int, step: int) -> int:
    """The attention-dropout key of update ``step`` (the optimizer's count
    before the update) of a run seeded with ``dropout_seed``."""
    return fold_key(dropout_seed, step)


def dropout_twin(model: nn.Module) -> nn.Module:
    """The ``deterministic=False`` twin of ``model``: a copy whose
    parameters and buffers are ``model``'s own tensors (an update of either
    is an update of both, as ``model.clone(deterministic=False)`` shares the
    flax tree), with attention dropout on wherever a layer has a
    ``dropout_p``."""
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    twin = copy.deepcopy(model, memo=shared)
    for module in twin.modules():
        if hasattr(module, "deterministic"):
            module.deterministic = False
    return twin


def mesh_loss(loss: torch.Tensor) -> torch.Tensor:
    """The loss of the whole batch from a rank's partial, detached: summed
    over the ``model`` axis, averaged over ``data``; ``loss`` itself with no
    mesh."""
    loss = reduce_tensor(reduce_tensor(loss.detach(), "model"), "data")
    mesh = get_mesh()
    return loss if mesh is None else loss / mesh.shape["data"]


def _update(model: nn.Module, optimizer: torch.optim.Optimizer, plan) -> None:
    """The gradient reduction, the (sharded) update, the gather of the
    updated slices."""
    all_reduce_gradients(model.parameters(), plan)
    optimizer.step()
    if plan is not None:
        plan.sync_params(model.parameters())


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Optional[Callable] = None,
    dropout_seed: int = 0,
    plan=None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Return ``train_step(x, y) -> loss``: forward, loss, backward, clip and
    update (both in ``optimizer.step``), step counter (``optimizer.count``).

    x: (batch, time, ensemble, grid, vars_in), y: (batch, ensemble, grid,
    vars_out) at the internal model widths. The loss is returned detached,
    on the model's device. A ``deterministic=False`` model runs under
    ``dropout_key_at(dropout_seed, optimizer.count)``. ``plan``: a ZeRO-1 /
    FSDP shard plan, or None.
    """
    loss_fn = loss_fn or weighted_mse
    drops = not getattr(model, "deterministic", True)

    def train_step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        pred = model(x, dropout_key=dropout_key_at(dropout_seed, optimizer.count)) if drops else model(x)
        loss = loss_fn(pred, y)
        loss.backward()
        _update(model, optimizer, plan)
        return mesh_loss(loss)

    return train_step


def make_rollout_train_step(
    model: nn.Module,
    data_indices,
    optimizer: torch.optim.Optimizer,
    n_steps: int,
    loss_fn: Optional[Callable] = None,
    dropout_seed: int = 0,
    plan=None,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Train through an ``n_steps`` autoregressive rollout (the rollout
    fine-tuning stage). Returns ``train_step(x0, truth_inputs, targets) ->
    loss``:

    - ``x0``: (batch, multi_step, ensemble, grid, n_in) initial window;
    - ``truth_inputs``: (n_steps, batch, ensemble, grid, n_in) future truth at
      input width, from which each lead time's forcings are read;
    - ``targets``: (n_steps, batch, ensemble, grid, n_out); the loss averages
      over lead times, so every rollout step trains equally.

    The loss is returned detached, on the model's device. A
    ``deterministic=False`` model rolls out under ``dropout_key_at(dropout_seed,
    optimizer.count)``, lead time t folding in t. ``plan``: a ZeRO-1 / FSDP
    shard plan, or None.
    """
    loss_fn = loss_fn or weighted_mse
    drops = not getattr(model, "deterministic", True)
    rollout = make_rollout_fn(model, data_indices, n_steps)
    forcing_in = np.asarray(data_indices.internal_model.input.forcing)

    def train_step(x0: torch.Tensor, truth_inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        forcings = (truth_inputs[..., torch.as_tensor(forcing_in, device=truth_inputs.device)]
                    if forcing_in.size else None)
        key = dropout_key_at(dropout_seed, optimizer.count) if drops else None
        _, preds = rollout(x0, forcings, key)
        loss = loss_fn(preds, targets)
        loss.backward()
        _update(model, optimizer, plan)
        return mesh_loss(loss)

    return train_step


def estimate_step_bytes(
    model: nn.Module,
    optimizer: Optional[torch.optim.Optimizer],
    x_shape: tuple,
    y_shape: tuple,
    *,
    indices=None,
    rollout: int = 1,
    ensemble: int = 1,
    loss_fn: Optional[Callable] = None,
    ema: bool = False,
) -> int:
    """The bytes one train step of ``model`` holds at once without
    rematerialisation, counted on the model's device without holding them.

    - The activations: the step's forward runs once with gradients on, from
      zeros of ``x_shape`` (``rollout`` > 1: the ``make_rollout_train_step``
      rollout, which needs ``indices``; ``ensemble`` multiplies the member
      axis of ``x_shape`` and ``y_shape``), through ``loss_fn`` (the run's
      loss; MSE by default), under
      :func:`~anemoi_models_tpu_torch.layers.remat.count_saved_bytes`: each
      storage an operation saves for the backward is counted once and none
      is kept, and every remat unit runs unchecked, mapper blocks included
      (a step holds a mapper's activations only while it recomputes that
      mapper, so they count once too often).
    - The state: the parameters and buffers, a gradient a parameter, the
      optimizer's two moments a parameter it updates (AdamW's ``mu`` and
      ``nu``, in the parameter's dtype) and, with ``ema``, a copy of the
      parameters.

    Transient buffers of the backward (the cotangents of one layer at a
    time, the kernels' scratch) are not counted."""
    dev = next(model.parameters()).device
    x_shape, y_shape = list(x_shape), list(y_shape)
    if ensemble > 1:
        x_shape[2] *= ensemble
        y_shape[1] *= ensemble
    loss_fn = loss_fn or weighted_mse
    key = dropout_key_at(0, 0) if not getattr(model, "deterministic", True) else None
    x = torch.zeros(x_shape, device=dev)
    training = model.training
    model.train()
    try:
        with count_saved_bytes(model) as saved:
            if rollout > 1:
                if indices is None:
                    raise ValueError("the rollout step's estimate needs the IndexCollection (indices=)")
                forcing_in = torch.as_tensor(np.asarray(indices.internal_model.input.forcing), device=dev)
                forcings = torch.zeros([rollout, x_shape[0], *x_shape[2:4], forcing_in.numel()], device=dev)
                _, preds = make_rollout_fn(model, indices, rollout)(x, forcings if forcing_in.numel() else None, key)
                loss_fn(preds, torch.zeros([rollout, *y_shape], device=dev))
            else:
                pred = model(x) if key is None else model(x, dropout_key=key)
                loss_fn(pred, torch.zeros(y_shape, device=dev))
    finally:
        model.train(training)
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    buffer_bytes = sum(b.numel() * b.element_size() for b in model.buffers())
    updated = [p for group in optimizer.param_groups for p in group["params"]] if optimizer else model.parameters()
    moment_bytes = 2 * sum(p.numel() * p.element_size() for p in updated)
    return saved["bytes"] + buffer_bytes + param_bytes * (2 + int(ema)) + moment_bytes


def resolve_remat_policy(
    model: nn.Module,
    optimizer: Optional[torch.optim.Optimizer],
    x_shape: tuple,
    y_shape: tuple,
    *,
    indices=None,
    rollout: int = 1,
    ensemble: int = 1,
    loss_fn: Optional[Callable] = None,
    ema: bool = False,
    limit_bytes: Optional[int] = None,
    headroom: float = 0.85,
    log: Optional[Callable[[str], None]] = None,
) -> str:
    """Pick ``"none"`` or ``"full"`` for ``remat_policy="auto"``.

    ``model`` must be built with ``remat_policy="none"``. Keeps ``"none"``
    if :func:`estimate_step_bytes` of the step variant the run executes
    (the arguments after ``y_shape`` are its, as in the JAX package's
    resolver: the longest rollout, the ensemble axis, the run's loss, the
    EMA) stays under ``headroom`` x the budget; else ``"full"``, the
    reference's policy. The estimate never holds ``"none"``'s activations,
    so a step that would not fit cannot run the card out of memory here.

    The budget is ``limit_bytes``, else the card's total memory
    (``torch.cuda.mem_get_info``); on the CPU, with no ``limit_bytes``,
    there is no budget and the answer is ``"full"``, as the JAX package's
    on a backend that reports none. ``log`` gets lines that start with
    ``"remat auto:"``."""
    say = log or (lambda s: None)
    dev = next(model.parameters()).device
    if limit_bytes is None and dev.type == "cuda":
        limit_bytes = torch.cuda.mem_get_info(dev)[1]
    if not limit_bytes:
        say("remat auto: unknown device memory budget; using 'full'")
        return "full"
    try:
        peak = estimate_step_bytes(model, optimizer, x_shape, y_shape, indices=indices, rollout=rollout,
                                   ensemble=ensemble, loss_fn=loss_fn, ema=ema)
    except torch.cuda.OutOfMemoryError:
        say("remat auto: the counting forward ran out of memory; using 'full'")
        return "full"
    ok = peak < headroom * limit_bytes
    say(f"remat auto: peak {peak / 2**30:.2f} GiB vs budget {limit_bytes / 2**30:.1f} GiB -> "
        f"{'none' if ok else 'full'}")
    return "none" if ok else "full"
