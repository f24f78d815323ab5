"""Training losses.

Counterpart of ``weighted_mse`` and ``WeightedMSELoss`` in
``anemoi_models_tpu/training/loss.py``: an area-weighted MSE over grid points
with optional per-variable weights and the imputer's loss mask, computed in
fp32 whatever the prediction's dtype; and :func:`loss_mask`, the counterpart
of ``anemoi_models_tpu/training/run.py:_loss_mask``, which finds that mask in
a processor pipeline.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["loss_mask", "weighted_mse", "WeightedMSELoss"]


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
