"""Train-step builder: forward, loss, backward and one optimizer update.

Counterpart of ``make_train_step`` in ``anemoi_models_tpu/training/step.py``.
The model owns its parameters and the optimizer (:func:`make_optimizer`) its
moments and update count, so the step is a closure over both instead of a
pure function of a ``TrainState``. On the card the edge attention runs its
hand-written kernels forward and backward; the processor's chunks are
recomputed in the backward as the model's ``remat_policy`` says.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from anemoi_models_tpu_torch.training.loss import weighted_mse

__all__ = ["make_train_step"]


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
