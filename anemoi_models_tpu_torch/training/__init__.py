"""Training: the loss, the optimizer and the train step.

The port's counterpart of ``anemoi_models_tpu.training``'s loss, optimizer,
train steps (one step, and through a rollout) and rollout driver. CRPS and
the data loaders are not ported yet.
"""

from anemoi_models_tpu_torch.training.loss import WeightedMSELoss, loss_mask, weighted_mse
from anemoi_models_tpu_torch.training.optim import AdamW, ema_update, make_optimizer, warmup_cosine_decay_schedule
from anemoi_models_tpu_torch.training.rollout import make_rollout_fn
from anemoi_models_tpu_torch.training.step import make_rollout_train_step, make_train_step

__all__ = [
    "AdamW",
    "WeightedMSELoss",
    "ema_update",
    "loss_mask",
    "make_optimizer",
    "make_rollout_fn",
    "make_rollout_train_step",
    "make_train_step",
    "warmup_cosine_decay_schedule",
    "weighted_mse",
]
