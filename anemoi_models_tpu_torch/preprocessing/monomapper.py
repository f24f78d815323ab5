"""1 -> 1 variable remapping (log1p / sqrt / boxcox), width-preserving.

Counterpart of ``anemoi_models_tpu/preprocessing/monomapper.py``. Both
directions build a new tensor (the converted columns stacked back with the
others), so nothing is written into the caller's tensor.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from anemoi_models_tpu_torch.preprocessing import BasePreprocessor
from anemoi_models_tpu_torch.preprocessing.mappings import (
    boxcox_converter,
    expm1_converter,
    inverse_boxcox_converter,
    log1p_converter,
    noop,
    sqrt_converter,
    square_converter,
)

__all__ = ["Monomapper"]


def _convert_columns(x: torch.Tensor, columns: list, converters: list) -> torch.Tensor:
    """``x`` with column ``i`` replaced by ``f(x[..., i])`` for each pair
    whose column exists at this width, out of place."""
    cols = list(x.unbind(-1))
    for i, f in zip(columns, converters):
        if i is not None:
            cols[i] = f(cols[i])
    return torch.stack(cols, dim=-1)


class Monomapper(BasePreprocessor):
    """Remap and convert single variables in place (width unchanged)."""

    supported_methods = {
        method: [f, inv]
        for method, f, inv in zip(
            ["log1p", "sqrt", "boxcox", "none"],
            [log1p_converter, sqrt_converter, boxcox_converter, noop],
            [expm1_converter, square_converter, inverse_boxcox_converter, noop],
        )
    }

    def __init__(self, config: Any = None, data_indices: Optional[Any] = None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        self._create_remapping_indices(statistics)
        self._validate_indices()

    def _validate_indices(self) -> None:
        lengths = {
            "train-in": len(self.index_training_input),
            "infer-in": len(self.index_inference_input),
            "infer-out": len(self.index_inference_output),
            "train-out": len(self.index_training_out),
            "mappers": len(self.remappers),
        }
        if len(set(lengths.values())) != 1:
            raise RuntimeError(f"Monomapper column bookkeeping is inconsistent: {lengths}")

    def _create_remapping_indices(self, statistics=None) -> None:
        di = self.data_indices
        train_in, infer_in = di.data.input.name_to_index, di.model.input.name_to_index
        train_out, infer_out = di.data.output.name_to_index, di.model.output.name_to_index
        self.num_training_input_vars = len(train_in)
        self.num_inference_input_vars = len(infer_in)
        self.num_training_output_vars = len(train_out)
        self.num_inference_output_vars = len(infer_out)
        self.remappers, self.backmappers = [], []
        self.index_training_input, self.index_training_out = [], []
        self.index_inference_input, self.index_inference_output = [], []
        for name in train_in:
            method = self.methods.get(name, self.default)
            if method not in self.supported_methods:
                raise KeyError(f"Monomapper: no such transform '{method}' (variable '{name}')")
            if method == "none":
                continue
            self.remappers.append(self.supported_methods[method][0])
            self.backmappers.append(self.supported_methods[method][1])
            self.index_training_input.append(train_in[name])
            self.index_training_out.append(train_out.get(name))
            self.index_inference_input.append(infer_in.get(name))
            self.index_inference_output.append(infer_out.get(name))

    def transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        if x.shape[-1] == self.num_training_input_vars:
            idx = self.index_training_input
        elif x.shape[-1] == self.num_inference_input_vars:
            idx = self.index_inference_input
        else:
            raise ValueError(
                f"Remapper got a {x.shape[-1]}-wide tensor; expected the training width "
                f"{self.num_training_input_vars} or the inference width {self.num_inference_input_vars}"
            )
        return _convert_columns(x, idx, self.remappers)

    def inverse_transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        if x.shape[-1] == self.num_training_output_vars:
            idx = self.index_training_out
        elif x.shape[-1] == self.num_inference_output_vars:
            idx = self.index_inference_output
        else:
            raise ValueError(
                f"Remapper got a {x.shape[-1]}-wide tensor; expected the training width "
                f"{self.num_training_output_vars} or the inference width {self.num_inference_output_vars}"
            )
        return _convert_columns(x, idx, self.backmappers)
