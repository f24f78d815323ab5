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
"""

from __future__ import annotations

from typing import Callable, Optional

import copy
import itertools

import numpy as np
import torch
from torch import nn

from anemoi_models_tpu_torch.ops.flash_attention import fold_key
from anemoi_models_tpu_torch.parallel.api import get_mesh
from anemoi_models_tpu_torch.parallel.primitives import all_reduce_gradients, reduce_tensor
from anemoi_models_tpu_torch.training.loss import weighted_mse
from anemoi_models_tpu_torch.training.rollout import make_rollout_fn

__all__ = ["dropout_key_at", "dropout_twin", "make_rollout_train_step", "make_train_step", "mesh_loss"]


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
