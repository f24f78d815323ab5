"""Elementwise variable conversion functions.

Counterpart of ``anemoi_models_tpu/preprocessing/mappings.py``: the same
function set, on torch tensors, with the same operation order.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "noop",
    "cos_converter",
    "sin_converter",
    "atan2_converter",
    "log1p_converter",
    "boxcox_converter",
    "sqrt_converter",
    "expm1_converter",
    "square_converter",
    "inverse_boxcox_converter",
]


def noop(x: torch.Tensor) -> torch.Tensor:
    """No operation."""
    return x


def cos_converter(x: torch.Tensor) -> torch.Tensor:
    """Convert angle in degrees to cos."""
    return torch.cos(x / 180 * math.pi)


def sin_converter(x: torch.Tensor) -> torch.Tensor:
    """Convert angle in degrees to sin."""
    return torch.sin(x / 180 * math.pi)


def atan2_converter(x: torch.Tensor) -> torch.Tensor:
    """Convert (cos, sin) pairs back to an angle in degrees in [0, 360);
    x[..., 0] is the cos, x[..., 1] the sin."""
    return torch.remainder(torch.atan2(x[..., 1], x[..., 0]) * 180 / math.pi, 360)


def log1p_converter(x: torch.Tensor) -> torch.Tensor:
    """Convert positive var to log(1+var)."""
    return torch.log1p(x)


def boxcox_converter(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    """Convert positive var to boxcox(var)."""
    if lambd == 0:
        return torch.log(x)
    return (torch.pow(x, lambd) - 1) / lambd


def sqrt_converter(x: torch.Tensor) -> torch.Tensor:
    """Convert positive var to sqrt(var)."""
    return torch.sqrt(x)


def expm1_converter(x: torch.Tensor) -> torch.Tensor:
    """Convert log(1+var) back to var."""
    return torch.expm1(x)


def square_converter(x: torch.Tensor) -> torch.Tensor:
    """Convert sqrt(var) back to var."""
    return x**2


def inverse_boxcox_converter(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    """Convert boxcox(var) back to var."""
    if lambd == 0:
        return torch.exp(x)
    return torch.pow(x * lambd + 1, 1 / lambd)
