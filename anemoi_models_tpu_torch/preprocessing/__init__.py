"""Pre/post-processing pipeline.

Counterpart of ``anemoi_models_tpu/preprocessing/__init__.py``: processors are
plain objects holding tensors; ``transform`` / ``inverse_transform`` are
functions of the input, and ``in_place`` is accepted for API parity (the port
never writes into the caller's tensor). ``to(device)`` moves a processor's
tensors.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import torch

LOGGER = logging.getLogger(__name__)

__all__ = ["BasePreprocessor", "Processors"]


class BasePreprocessor:
    """Base class for data pre- and post-processors.

    ``default`` and ``remap`` are special config keys; every other key is a
    method name mapping to a list of variables (inverted into ``self.methods``).
    """

    def __init__(self, config: Any = None, data_indices: Optional[Any] = None,
                 statistics: Optional[dict] = None) -> None:
        self.default, self.remap, self.method_config = self._process_config(config or {})
        self.methods = {
            variable: method
            for method, variables in self.method_config.items()
            if not isinstance(variables, str)
            for variable in variables
        }
        self.data_indices = data_indices

    @classmethod
    def _process_config(cls, config: Any):
        special = ("default", "remap", "_target_")
        default = config.get("default", "none")
        remap = config.get("remap", {})
        method_config = {
            k: v for k, v in config.items() if k not in special and v is not None and v != "none"
        }
        if not method_config:
            LOGGER.warning(
                "%s: using default method %s for all variables not specified in the config.",
                cls.__name__, default,
            )
        for m, variables in method_config.items():
            if isinstance(variables, str):
                method_config[m] = {variables: f"{m}_{variables}"}
            elif isinstance(variables, list):
                method_config[m] = {v: f"{m}_{v}" for v in variables}
        return default, remap, method_config

    def __call__(self, x: torch.Tensor, in_place: bool = False, inverse: bool = False) -> torch.Tensor:
        if inverse:
            return self.inverse_transform(x, in_place=in_place)
        return self.transform(x, in_place=in_place)

    def transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        return x

    def inverse_transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        return x

    def to(self, device) -> "BasePreprocessor":
        return self


class Processors:
    """An ordered pipeline of processors: config order as pre-processor,
    reversed with inverse transforms as post-processor. The first forward run
    is checked for NaNs."""

    def __init__(self, processors: list, inverse: bool = False) -> None:
        self.inverse = inverse
        self.first_run = True
        self.processors = dict(processors[::-1] if inverse else processors)

    def __call__(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        for processor in self.processors.values():
            x = processor(x, in_place=in_place, inverse=self.inverse)
        if self.first_run:
            self.first_run = False
            if not self.inverse:
                num_nan = int(torch.isnan(x).sum())
                if num_nan:
                    raise ValueError(f"{type(self).__name__} left {num_nan} NaNs in its output on the first batch.")
        return x

    def to(self, device) -> "Processors":
        for processor in self.processors.values():
            processor.to(device)
        return self
