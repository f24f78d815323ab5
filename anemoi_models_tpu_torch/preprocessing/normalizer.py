"""Input normalisation as one affine transform per variable.

Counterpart of ``anemoi_models_tpu/preprocessing/normalizer.py``: methods
``mean-std`` / ``std`` / ``min-max`` / ``max`` / ``none`` per variable, with
optional statistics remapping, reduced on the host with numpy (float64) to
``x * mul + add`` tables held as fp32 tensors.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import numpy as np
import torch

from anemoi_models_tpu_torch.preprocessing import BasePreprocessor

__all__ = ["InputNormalizer"]

_METHOD_CODES = {"none": 0, "mean-std": 1, "std": 2, "min-max": 3, "max": 4}


class InputNormalizer(BasePreprocessor):
    """Normalises input data with a configurable per-variable method."""

    def __init__(self, config: Any = None, data_indices: Optional[Any] = None,
                 statistics: Optional[dict] = None) -> None:
        super().__init__(config, data_indices, statistics)
        name_to_index = data_indices.data.input.name_to_index

        minimum, maximum, mean, stdev = (
            np.asarray(statistics[k], dtype=np.float64).copy()
            for k in ("minimum", "maximum", "mean", "stdev")
        )
        remapped = {
            name_to_index[remap]: tuple(s[name_to_index[source]] for s in (minimum, maximum, mean, stdev))
            for remap, source in self.remap.items()
        }
        for idx, (mn, mx, mu, sd) in remapped.items():
            minimum[idx], maximum[idx], mean[idx], stdev[idx] = mn, mx, mu, sd

        n_config = sum(len(v) for v in self.method_config.values())
        if len(self.methods) != n_config:
            raise ValueError(
                f"InputNormalizer config is inconsistent: {len(self.methods)} resolved "
                f"per-variable methods vs {n_config} variables listed under method keys "
                "(a variable may appear under two methods)."
            )
        n = minimum.size
        for label, arr in (("maximum", maximum), ("mean", mean), ("stdev", stdev)):
            if arr.size != n:
                raise ValueError(f"statistics['{label}'] has {arr.size} entries, expected {n}")
        for name in self.methods:
            if name not in name_to_index:
                raise KeyError(f"InputNormalizer: '{name}' is not in the dataset's variable table")

        method_id = np.zeros((n,), dtype=np.int64)
        for name, i in name_to_index.items():
            method = self.methods.get(name, self.default)
            if method not in _METHOD_CODES:
                raise ValueError(f"InputNormalizer: unsupported method '{method}' for variable '{name}'")
            method_id[i] = _METHOD_CODES[method]

        with np.errstate(divide="ignore", invalid="ignore"):
            span = maximum - minimum
            mul = np.stack([np.ones((n,)), 1.0 / stdev, 1.0 / stdev, 1.0 / span, 1.0 / maximum])
            add = np.stack([np.zeros((n,)), -mean / stdev, np.zeros((n,)), -minimum / span, np.zeros((n,))])
        norm_mul = np.take_along_axis(mul, method_id[None, :], axis=0)[0]
        norm_add = np.take_along_axis(add, method_id[None, :], axis=0)[0]

        degenerate = ((method_id == 1) | (method_id == 2)) & (stdev < mean * 1e-6)
        degenerate |= (method_id == 3) & (span < 1e-9)
        if degenerate.any():
            index_to_name = {i: k for k, i in name_to_index.items()}
            bad = ", ".join(index_to_name.get(int(i), str(int(i))) for i in np.nonzero(degenerate)[0])
            warnings.warn(
                f"InputNormalizer: near-zero spread detected for [{bad}]; "
                "their normalization is numerically degenerate (constant field?)."
            )

        self._norm_mul = torch.as_tensor(norm_mul, dtype=torch.float32)
        self._norm_add = torch.as_tensor(norm_add, dtype=torch.float32)
        self._input_idx = torch.as_tensor(np.asarray(data_indices.data.input.full), dtype=torch.long)
        self._output_idx = torch.as_tensor(np.asarray(data_indices.data.output.full), dtype=torch.long)

    def to(self, device) -> "InputNormalizer":
        for name in ("_norm_mul", "_norm_add", "_input_idx", "_output_idx"):
            setattr(self, name, getattr(self, name).to(device))
        return self

    def transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        """Normalise (..., nvars); the width selects the input view."""
        mul, add = self._norm_mul, self._norm_add
        if x.shape[-1] == len(self._input_idx):
            mul, add = mul[self._input_idx], add[self._input_idx]
        return x * mul + add

    def inverse_transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        """Denormalise (..., nvars | nvars_pred)."""
        mul, add = self._norm_mul, self._norm_add
        if x.shape[-1] == len(self._output_idx):
            mul, add = mul[self._output_idx], add[self._output_idx]
        return (x - add) / mul
