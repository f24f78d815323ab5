"""Layer utilities: activation registry, compute-dtype Dense, autocast LayerNorm.

Counterpart of ``anemoi_models_tpu/layers/utils.py``. Two defaults differ
between the frameworks and follow the JAX reference here:

- "gelu" is the tanh approximation (``jax.nn.gelu``'s default; torch's
  default is the exact erf form);
- the LayerNorm epsilon is 1e-6 (flax's default; torch's is 1e-5).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["get_activation", "Dense", "AutocastLayerNorm"]

_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "leakyrelu": F.leaky_relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "softplus": F.softplus,
    "mish": F.mish,
    "identity": lambda x: x,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation function from its (torch-style) config name."""
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError as exc:
        raise RuntimeError(f"Activation function {name} not supported") from exc


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype``, as a
    flax ``nn.Dense(dtype=...)``: input, weight and bias are cast to the
    compute dtype; the matrix product accumulates in fp32."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class AutocastLayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics, IO in the input dtype, eps 1e-6."""

    def __init__(self, normalized_shape: int, *, device=None) -> None:
        super().__init__(normalized_shape, eps=1e-6, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)
