"""Training: losses, the optimizer, the train steps, the data layer, the
evaluation and the training driver.

The port's counterpart of ``anemoi_models_tpu.training``: ``weighted_mse``
and the fair ensemble CRPS, AdamW and the EMA, the train steps (one step,
through a rollout, with attention dropout), the rollout driver, the data
sources (synthetic, memmap, HDF5, zarr), the sampler and loader,
``evaluate_interface`` and ``train_run``.
"""

from anemoi_models_tpu_torch.training.data import SyntheticWeather
from anemoi_models_tpu_torch.training.dataset import (
    H5Dataset,
    MemmapDataset,
    SyntheticSource,
    ZarrDataset,
    check_source_layout,
    open_dataset,
    save_memmap_dataset,
    save_zarr_dataset,
)
from anemoi_models_tpu_torch.training.evaluate import evaluate_interface, evaluate_rollout, rollout_scores
from anemoi_models_tpu_torch.training.loader import BatchLoader, WindowSampler, device_prefetch
from anemoi_models_tpu_torch.training.loss import (
    WeightedCRPSLoss,
    WeightedMSELoss,
    crps_ensemble,
    loss_mask,
    weighted_mse,
)
from anemoi_models_tpu_torch.training.optim import AdamW, ema_update, make_optimizer, warmup_cosine_decay_schedule
from anemoi_models_tpu_torch.training.rollout import make_rollout_fn
from anemoi_models_tpu_torch.training.run import train_run
from anemoi_models_tpu_torch.training.step import (
    dropout_key_at,
    dropout_twin,
    estimate_step_bytes,
    make_rollout_train_step,
    make_train_step,
    resolve_remat_policy,
)

__all__ = [
    "AdamW",
    "BatchLoader",
    "H5Dataset",
    "MemmapDataset",
    "SyntheticSource",
    "SyntheticWeather",
    "WeightedCRPSLoss",
    "WeightedMSELoss",
    "WindowSampler",
    "ZarrDataset",
    "check_source_layout",
    "crps_ensemble",
    "device_prefetch",
    "dropout_key_at",
    "dropout_twin",
    "ema_update",
    "estimate_step_bytes",
    "evaluate_interface",
    "evaluate_rollout",
    "loss_mask",
    "make_optimizer",
    "make_rollout_fn",
    "make_rollout_train_step",
    "make_train_step",
    "open_dataset",
    "resolve_remat_policy",
    "rollout_scores",
    "save_memmap_dataset",
    "save_zarr_dataset",
    "train_run",
    "warmup_cosine_decay_schedule",
    "weighted_mse",
]
