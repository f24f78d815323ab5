"""Train-step builders: forward, loss, backward and one optimizer update,
for one step or through an autoregressive rollout.

Counterpart of ``make_train_step`` and ``make_rollout_train_step`` in
``anemoi_models_tpu/training/step.py``.
The model owns its parameters and the optimizer (:func:`make_optimizer`) its
moments and update count, so the step is a closure over both instead of a
pure function of a ``TrainState``. On the card the edge attention runs its
hand-written kernels forward and backward; the processor's chunks are
recomputed in the backward as the model's ``remat_policy`` says.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from anemoi_models_tpu_torch.training.loss import weighted_mse
from anemoi_models_tpu_torch.training.rollout import make_rollout_fn

__all__ = ["make_rollout_train_step", "make_train_step"]


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Optional[Callable] = None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Return ``train_step(x, y) -> loss``: forward, loss, backward, clip and
    update (both in ``optimizer.step``), step counter (``optimizer.count``).

    x: (batch, time, ensemble, grid, vars_in), y: (batch, ensemble, grid,
    vars_out) at the internal model widths. The loss is returned detached,
    on the model's device.
    """
    if not getattr(model, "deterministic", True):
        raise NotImplementedError("attention dropout (deterministic=False) is not ported; train a deterministic model")
    loss_fn = loss_fn or weighted_mse

    def train_step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_rollout_train_step(
    model: nn.Module,
    data_indices,
    optimizer: torch.optim.Optimizer,
    n_steps: int,
    loss_fn: Optional[Callable] = None,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Train through an ``n_steps`` autoregressive rollout (the rollout
    fine-tuning stage). Returns ``train_step(x0, truth_inputs, targets) ->
    loss``:

    - ``x0``: (batch, multi_step, ensemble, grid, n_in) initial window;
    - ``truth_inputs``: (n_steps, batch, ensemble, grid, n_in) future truth at
      input width, from which each lead time's forcings are read;
    - ``targets``: (n_steps, batch, ensemble, grid, n_out); the loss averages
      over lead times, so every rollout step trains equally.

    The loss is returned detached, on the model's device.
    """
    if not getattr(model, "deterministic", True):
        raise NotImplementedError("attention dropout (deterministic=False) is not ported; train a deterministic model")
    loss_fn = loss_fn or weighted_mse
    rollout = make_rollout_fn(model, data_indices, n_steps)
    forcing_in = np.asarray(data_indices.internal_model.input.forcing)

    def train_step(x0: torch.Tensor, truth_inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        forcings = (truth_inputs[..., torch.as_tensor(forcing_in, device=truth_inputs.device)]
                    if forcing_in.size else None)
        _, preds = rollout(x0, forcings)
        loss = loss_fn(preds, targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
