"""Training losses.

Counterpart of ``anemoi_models_tpu/training/loss.py``: an area-weighted MSE
over grid points and the fair ensemble CRPS (the AIFS-CRPS objective), both
with optional per-variable weights and the imputer's loss mask, computed in
fp32 whatever the prediction's dtype; and :func:`loss_mask`, the counterpart
of ``anemoi_models_tpu/training/run.py:_loss_mask``, which finds that mask in
a processor pipeline.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["WeightedCRPSLoss", "WeightedMSELoss", "crps_ensemble", "loss_mask", "weighted_mse"]


def loss_mask(pipeline) -> Optional[torch.Tensor]:
    """The (grid, vars_out) training mask of the first processor in
    ``pipeline`` (a ``Processors``) that fit one (an imputer), or None: pass
    it to :class:`WeightedMSELoss` to train without the imputed points."""
    for processor in getattr(pipeline, "processors", {}).values():
        mask = getattr(processor, "loss_mask_training", None)
        if mask is not None:
            return mask
    return None


def weighted_mse(
    pred: torch.Tensor,
    target: torch.Tensor,
    node_weights: Optional[torch.Tensor] = None,
    variable_weights: Optional[torch.Tensor] = None,
    loss_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Area/variable-weighted masked MSE.

    pred/target: (..., grid, vars); node_weights: (grid,);
    variable_weights: (vars,); loss_mask: (grid, vars) from the imputer.
    """
    err = (pred.float() - target.float()) ** 2
    if loss_mask is not None:
        err = err * loss_mask
    if variable_weights is not None:
        err = err * variable_weights
    if node_weights is not None:
        w = node_weights[..., None]
        return (err * w).sum() / (w.expand(err.shape).sum() + 1e-12)
    return err.mean()


class WeightedMSELoss:
    """Callable bundling static weights/mask with :func:`weighted_mse`."""

    def __init__(
        self,
        node_weights: Optional[torch.Tensor] = None,
        variable_weights: Optional[torch.Tensor] = None,
        loss_mask: Optional[torch.Tensor] = None,
    ) -> None:
        self.node_weights = node_weights
        self.variable_weights = variable_weights
        self.loss_mask = loss_mask

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return weighted_mse(pred, target, self.node_weights, self.variable_weights, self.loss_mask)


def crps_ensemble(
    pred: torch.Tensor,
    target: torch.Tensor,
    node_weights: Optional[torch.Tensor] = None,
    variable_weights: Optional[torch.Tensor] = None,
    loss_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Area/variable-weighted masked fair ensemble CRPS.

    ``pred``: (..., M, grid, vars) with M members on axis -3; ``target``: the
    same with size 1 there, or no ensemble axis. ``CRPS = (1/M) sum_i |x_i -
    y| - (1 / (2 M (M - 1))) sum_{i != j} |x_i - x_j|``, the second term from
    the sorted members as ``sum_k (2k - M + 1) s_k``. M = 1 is the MAE.
    """
    pred = pred.float()
    target = target.float()
    if target.dim() < pred.dim():
        target = target.unsqueeze(-3)
    m = pred.shape[-3]
    skill = (pred - target).abs().mean(dim=-3)
    if m > 1:
        s = torch.sort(pred, dim=-3).values
        coef = (2.0 * torch.arange(m, dtype=torch.float32, device=pred.device) - (m - 1)).view(m, 1, 1)
        crps = skill - (s * coef).sum(dim=-3) / (m * (m - 1))
    else:
        crps = skill
    if loss_mask is not None:  # imputed points carry no skill signal
        crps = crps * loss_mask
    if variable_weights is not None:
        crps = crps * variable_weights
    if node_weights is not None:
        w = node_weights[..., None]
        return (crps * w).sum() / (w.expand(crps.shape).sum() + 1e-12)
    return crps.mean()


class WeightedCRPSLoss:
    """Callable bundling static weights/mask with :func:`crps_ensemble`."""

    def __init__(
        self,
        node_weights: Optional[torch.Tensor] = None,
        variable_weights: Optional[torch.Tensor] = None,
        loss_mask: Optional[torch.Tensor] = None,
    ) -> None:
        self.node_weights = node_weights
        self.variable_weights = variable_weights
        self.loss_mask = loss_mask

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return crps_ensemble(pred, target, self.node_weights, self.variable_weights, self.loss_mask)
