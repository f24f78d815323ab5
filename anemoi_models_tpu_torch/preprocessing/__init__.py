"""Pre/post-processing pipeline (normalize, impute, remap).

Counterpart of ``anemoi_models_tpu/preprocessing/__init__.py``: processors are
plain objects holding tensors; ``transform`` / ``inverse_transform`` are
functions of the input, and ``in_place`` is accepted for API parity (the port
never writes into the caller's tensor). ``to(device)`` moves a processor's
tensors. ``fit``, ``state_dict`` and ``load_state_dict`` carry a stateful
processor's data-dependent buffers (an imputer's first-batch NaN mask and
loss mask) through a checkpoint, as the JAX package's do; a stateless
processor's state is ``{}``.
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

    def fit(self, x: torch.Tensor) -> None:
        """Compute any data-dependent state from a sample batch."""

    def state_dict(self) -> dict:
        """Buffers to persist in checkpoints (none for a stateless processor)."""
        return {}

    def load_state_dict(self, state: dict) -> None:
        """Restore what :meth:`state_dict` gave; a stateless processor takes
        only ``{}``."""
        if state:
            raise ValueError(f"{type(self).__name__} holds no state; cannot load {sorted(state)}")


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

    def fit(self, x: torch.Tensor) -> None:
        """Fit every processor in pipeline order, threading the transforms."""
        for processor in self.processors.values():
            processor.fit(x)
            x = processor(x, inverse=self.inverse)

    def state_dict(self) -> dict:
        """``{name: state}`` of the processors that hold any."""
        return {name: p.state_dict() for name, p in self.processors.items() if p.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` (the port's, or the JAX package's);
        state for a processor this pipeline does not have raises."""
        missing = sorted(set(state) - set(self.processors))
        if missing:
            raise ValueError(f"processor state for {missing}, which this pipeline does not have "
                             f"(it has {sorted(self.processors)})")
        for name, sub in state.items():
            self.processors[name].load_state_dict(sub)
