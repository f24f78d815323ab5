"""Training losses.

Counterpart of ``anemoi_models_tpu/training/loss.py``: an area-weighted MSE
over grid points and the fair ensemble CRPS (the AIFS-CRPS objective), both
with optional per-variable weights and the imputer's loss mask, computed in
fp32 whatever the prediction's dtype; and :func:`loss_mask`, the counterpart
of ``anemoi_models_tpu/training/run.py:_loss_mask``, which finds that mask in
a processor pipeline.

Under a mesh whose ``model`` axis is larger than 1, the prediction and the
target are a rank's rows of the grid: whole-grid node weights and masks are
cut to the rank's rows, and the normaliser (the weights' or the elements'
count) is summed over the ``model`` axis, so the ranks' losses are partials
whose sum is the loss of the whole grid (``training.step`` sums them for
its report).
"""

from __future__ import annotations

from typing import Optional

import torch

from anemoi_models_tpu_torch.parallel.api import model_sharded
from anemoi_models_tpu_torch.parallel.primitives import reduce_tensor

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


def _rank_rows(t: Optional[torch.Tensor], grid: int) -> Optional[torch.Tensor]:
    """``t`` (grid, ...) as the prediction's rows: itself, or under a
    model-sharded mesh this rank's rows of a whole-grid ``t``."""
    mesh = model_sharded()
    if t is None or mesh is None or t.shape[0] == grid:
        return t
    lo, hi = mesh.rows(t.shape[0])
    if hi - lo != grid:
        raise ValueError(f"a grid of {t.shape[0]} rows gives this rank {hi - lo}, the prediction has {grid}")
    return t[lo:hi]


def _normalised(num: torch.Tensor, den: torch.Tensor, eps: float) -> torch.Tensor:
    """``num / (den + eps)``, the denominator summed over a model-sharded
    mesh's ranks first (it is weights and counts, with no gradient)."""
    if model_sharded() is not None:
        den = reduce_tensor(den.detach(), "model")
    return num / (den + eps)


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
    grid = err.shape[-2]
    if loss_mask is not None:
        err = err * _rank_rows(loss_mask, grid)
    if variable_weights is not None:
        err = err * variable_weights
    if node_weights is not None:
        w = _rank_rows(node_weights, grid)[..., None]
        return _normalised((err * w).sum(), w.expand(err.shape).sum(), 1e-12)
    return err.mean() if model_sharded() is None else _normalised(err.sum(), err.new_tensor(err.numel()), 0.0)


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
    grid = crps.shape[-2]
    if loss_mask is not None:  # imputed points carry no skill signal
        crps = crps * _rank_rows(loss_mask, grid)
    if variable_weights is not None:
        crps = crps * variable_weights
    if node_weights is not None:
        w = _rank_rows(node_weights, grid)[..., None]
        return _normalised((crps * w).sum(), w.expand(crps.shape).sum(), 1e-12)
    return crps.mean() if model_sharded() is None else _normalised(crps.sum(), crps.new_tensor(crps.numel()), 0.0)


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
