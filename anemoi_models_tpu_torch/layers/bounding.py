"""Output bounding strategies applied to named variables in config order.

Counterpart of ``anemoi_models_tpu/layers/bounding.py``: each bounding is a
callable ``x -> x`` over the internal-model-output tensor (variables last).
Each builds a new tensor (an ``index_copy`` of the bounded columns into
``x``), so no bounding writes into a tensor that autograd saved.
"""

from __future__ import annotations

import numpy as np
import torch

from anemoi_models_tpu_torch.data_indices.tensor import lookup_indices

__all__ = ["BaseBounding", "ReluBounding", "LeakyReluBounding", "HardtanhBounding", "FractionBounding"]


class BaseBounding:
    """Bounding over the variables named in ``variables``."""

    def __init__(self, *, variables: list[str], name_to_index: dict[str, int]) -> None:
        self.name_to_index = name_to_index
        self.variables = variables
        self.data_index = self._create_index(variables=self.variables)

    def _create_index(self, variables: list[str]) -> np.ndarray:
        return lookup_indices(self.name_to_index, variables)

    def _index(self, x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(idx, dtype=torch.long, device=x.device)

    def _set(self, x: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """``x`` with its bounded columns replaced by ``values``, out of place."""
        return x.index_copy(-1, self._index(x, self.data_index), values)

    def _columns(self, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(-1, self._index(x, self.data_index))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class ReluBounding(BaseBounding):
    """Clamp the named variables to >= 0."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._set(x, torch.clamp_min(self._columns(x), 0.0))


class LeakyReluBounding(BaseBounding):
    """Leaky version of the zero clamp (negative slope 0.01)."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        sub = self._columns(x)
        return self._set(x, torch.where(sub >= 0, sub, 0.01 * sub))


class HardtanhBounding(BaseBounding):
    """Clamp the named variables to [min_val, max_val]."""

    def __init__(self, *, variables: list[str], name_to_index: dict[str, int], min_val: float,
                 max_val: float) -> None:
        super().__init__(variables=variables, name_to_index=name_to_index)
        self.min_val = min_val
        self.max_val = max_val

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._set(x, torch.clamp(self._columns(x), self.min_val, self.max_val))


class FractionBounding(HardtanhBounding):
    """Bound variables to a [min, max] fraction of ``total_var``, e.g.
    convective precipitation as a fraction of total precipitation."""

    def __init__(self, *, variables: list[str], name_to_index: dict[str, int], min_val: float, max_val: float,
                 total_var: str) -> None:
        super().__init__(variables=variables, name_to_index=name_to_index, min_val=min_val, max_val=max_val)
        self.total_variable = self._create_index(variables=[total_var])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = super().__call__(x)
        total = x.index_select(-1, self._index(x, self.total_variable))
        return self._set(x, self._columns(x) * total)
