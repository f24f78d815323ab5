"""NaN imputation with static (first-batch) or dynamic (per-batch) masks.

Counterpart of ``anemoi_models_tpu/preprocessing/imputer.py``: replace NaNs
with a statistic or a constant per variable, expose ``loss_mask_training``
(zero at the imputed output locations) for the training loss, and re-insert
the NaNs on inverse. The first batch's NaN mask is state set by ``fit`` (or
on the first call), saved by ``state_dict`` and restored by
``load_state_dict``, which also takes the JAX package's state (numpy
arrays). Both directions build a new tensor: one gather, a ``where`` and an
``index_copy`` over the mapped columns.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import numpy as np
import torch

from anemoi_models_tpu_torch.preprocessing import BasePreprocessor

__all__ = ["BaseImputer", "InputImputer", "ConstantImputer", "DynamicInputImputer", "DynamicConstantImputer"]


class BaseImputer(BasePreprocessor):
    """Base class for imputers."""

    def __init__(self, config: Any = None, data_indices: Optional[Any] = None,
                 statistics: Optional[dict] = None) -> None:
        super().__init__(config, data_indices, statistics)
        self.nan_locations: Optional[torch.Tensor] = None  # (grid, training input vars) bool
        self.loss_mask_training: Optional[torch.Tensor] = None  # (grid, model output vars) fp32
        self.device = torch.device("cpu")

    def _validate_indices(self) -> None:
        counts = {
            "train-in": len(self.index_training_input),
            "infer-in": len(self.index_inference_input),
            "train-out": len(self.index_training_output),
            "infer-out": len(self.index_inference_output),
            "values": len(self.replacement),
        }
        ok = (
            counts["train-in"] == counts["infer-in"] <= counts["values"]
            and counts["train-out"] == counts["infer-out"] <= counts["values"]
        )
        if not ok:
            raise RuntimeError(f"Imputer column bookkeeping is inconsistent: {counts}")

    def _create_imputation_indices(self, statistics: Optional[dict] = None) -> None:
        """Collect (source, per-width destination, replacement) per variable."""
        di = self.data_indices
        train_in, infer_in = di.data.input.name_to_index, di.model.input.name_to_index
        train_out, infer_out = di.data.output.name_to_index, di.model.output.name_to_index
        self.num_training_input_vars = len(train_in)
        self.num_inference_input_vars = len(infer_in)
        self.num_training_output_vars = len(train_out)
        self.num_inference_output_vars = len(infer_out)
        self.index_training_input, self.index_inference_input = [], []
        self.index_training_output, self.index_inference_output = [], []
        self.replacement = []
        for name in train_in:
            method = self.methods.get(name, self.default)
            if method == "none":
                continue
            self.index_training_input.append(train_in[name])
            self.index_training_output.append(train_out.get(name))
            self.index_inference_input.append(infer_in.get(name))
            self.index_inference_output.append(infer_out.get(name))
            if statistics is None:  # ConstantImputer: the config key is the value
                self.replacement.append(float(method))
            elif isinstance(statistics, dict):
                if method not in statistics:
                    raise KeyError(
                        f"Imputer: statistic '{method}' (for variable '{name}') is not present "
                        f"in the dataset statistics (have: {sorted(statistics)})"
                    )
                self.replacement.append(float(statistics[method][train_in[name]]))
            else:
                raise TypeError(f"Imputer statistics must be a dict or None, got {type(statistics)}")
        # per-width gather / scatter plans: (dst columns, src columns, values)
        self._plan_input = {
            self.num_training_input_vars: self._make_plan(self.index_training_input),
            self.num_inference_input_vars: self._make_plan(self.index_inference_input),
        }
        self._plan_output = {
            self.num_training_output_vars: self._make_plan(self.index_training_output),
            self.num_inference_output_vars: self._make_plan(self.index_inference_output),
        }

    def _make_plan(self, dst_indices: list) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(dst_cols, src_cols, values) over the pairs whose dst exists at this width."""
        pairs = [(d, s, v) for s, d, v in zip(self.index_training_input, dst_indices, self.replacement)
                 if d is not None]
        dst, src, val = zip(*pairs) if pairs else ((), (), ())
        return (torch.as_tensor(dst, dtype=torch.long), torch.as_tensor(src, dtype=torch.long),
                torch.as_tensor(np.asarray(val, dtype=np.float32)))

    def to(self, device) -> "BaseImputer":
        self.device = torch.device(device)
        for plans in (self._plan_input, self._plan_output):
            for width, plan in plans.items():
                plans[width] = tuple(t.to(self.device) for t in plan)
        for name in ("nan_locations", "loss_mask_training"):
            if getattr(self, name) is not None:
                setattr(self, name, getattr(self, name).to(self.device))
        return self

    # -- state -----------------------------------------------------------
    def get_nans(self, x: torch.Tensor) -> torch.Tensor:
        """NaN mask over the trailing (grid, variable) dims of the first
        leading element."""
        return torch.isnan(x[(0,) * (x.dim() - 2)])

    def fit(self, x: torch.Tensor) -> None:
        """Record the NaN locations and build the training loss mask (as
        ordinary tensors, also when called under ``torch.inference_mode``:
        the loss mask goes into training losses)."""
        with torch.inference_mode(False):
            self.nan_locations = self.get_nans(x).to(self.device).clone()
            n_out = len(self.data_indices.model.output.name_to_index)
            loss_mask = torch.ones((x.shape[-2], n_out), dtype=torch.float32, device=self.device)
            for idx_src, idx_dst in zip(self.index_training_input, self.index_inference_output):
                if idx_dst is not None:
                    loss_mask[:, idx_dst] = (~self.nan_locations[:, idx_src]).float()
        self.loss_mask_training = loss_mask

    def _select_plan(self, plans: dict, width: int, kind: str):
        if width not in plans:
            raise ValueError(
                f"Imputer got a {width}-wide {kind} tensor; known widths are ({sorted(plans.keys())})"
            )
        return plans[width]

    # -- transforms ------------------------------------------------------
    def transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        if self.nan_locations is None:
            self.fit(x)
        dst, src, val = self._select_plan(self._plan_input, x.shape[-1], "input")
        if dst.numel() == 0:
            return x
        mask = self.nan_locations[:, src]  # (grid, n_mapped), broadcast over the leading dims
        return x.index_copy(-1, dst, torch.where(mask, val.to(x.dtype), x.index_select(-1, dst)))

    def inverse_transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        dst, src, _ = self._select_plan(self._plan_output, x.shape[-1], "output")
        if dst.numel() == 0 or self.nan_locations is None:
            return x
        mask = self.nan_locations[:, src]
        return x.index_copy(-1, dst, x.index_select(-1, dst).masked_fill(mask, float("nan")))

    def state_dict(self) -> dict:
        if self.nan_locations is None:
            return {}
        return {"nan_locations": self.nan_locations.cpu(), "loss_mask_training": self.loss_mask_training.cpu()}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s masks: torch tensors, or the JAX
        package's numpy arrays."""
        unknown = sorted(set(state) - {"nan_locations", "loss_mask_training"})
        if unknown:
            raise ValueError(f"{type(self).__name__} holds no state {unknown}")
        if "nan_locations" in state:
            self.nan_locations = torch.as_tensor(np.array(state["nan_locations"], dtype=bool), device=self.device)
        if "loss_mask_training" in state:
            self.loss_mask_training = torch.as_tensor(
                np.array(state["loss_mask_training"], dtype=np.float32), device=self.device)


class InputImputer(BaseImputer):
    """Imputes missing values with the supplied statistics; config keys are
    statistic names with variable lists, e.g. ``{"default": "none", "mean":
    ["y"], "maximum": ["x"]}``."""

    def __init__(self, config=None, data_indices=None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        self._create_imputation_indices(statistics)
        self._validate_indices()


class ConstantImputer(BaseImputer):
    """Imputes missing values with constants taken from the config keys,
    e.g. ``{"default": "none", 0: ["x"], 3.14: ["q"]}``."""

    def __init__(self, config=None, data_indices=None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        self._create_imputation_indices()
        self._validate_indices()


class DynamicMixin:
    """Recompute the NaN mask from every batch instead of keeping it: the
    loss mask is all ones, and the inverse is the identity (NaNs are never
    re-inserted)."""

    def transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        dst, _, val = self._select_plan(self._plan_input, x.shape[-1], "input")
        n_out = len(self.data_indices.model.output.name_to_index)
        self.loss_mask_training = torch.ones((x.shape[-2], n_out), dtype=torch.float32, device=x.device)
        if dst.numel() == 0:
            return x
        sub = x.index_select(-1, dst)
        return x.index_copy(-1, dst, torch.where(torch.isnan(sub), val.to(x.dtype), sub))

    def inverse_transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        return x

    def fit(self, x: torch.Tensor) -> None:  # nothing to fit
        return None


class DynamicInputImputer(DynamicMixin, InputImputer):
    """Statistics-based imputation with a per-batch NaN map."""

    def __init__(self, config=None, data_indices=None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        warnings.warn(
            "Dynamic imputation recomputes the NaN map every batch and never restores "
            "NaNs on inverse — the model learns to emit the fill values at missing points."
        )


class DynamicConstantImputer(DynamicMixin, ConstantImputer):
    """Constant imputation with a per-batch NaN map."""

    def __init__(self, config=None, data_indices=None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        warnings.warn(
            "Dynamic imputation recomputes the NaN map every batch and never restores "
            "NaNs on inverse — the model learns to emit the fill values at missing points."
        )
