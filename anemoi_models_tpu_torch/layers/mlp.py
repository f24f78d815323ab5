"""Multi-layer perceptron.

Counterpart of ``anemoi_models_tpu/layers/mlp.py:MLP``: Dense -> act, then
``n_extra_layers + 1`` hidden Dense -> act pairs, a final Dense, an optional
final activation and an optional LayerNorm (fp32 statistics, eps 1e-6).
The layers keep flax's names (``Dense_0`` .. ``Dense_{n+2}``,
``AutocastLayerNorm_0``), so a JAX parameter tree loads by name.
"""

from __future__ import annotations

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.utils import AutocastLayerNorm, Dense, get_activation

__all__ = ["MLP"]


class MLP(nn.Module):
    """MLP with the reference's layer layout (``n_extra_layers + 3`` Dense)."""

    def __init__(self, in_features: int, hidden_dim: int, out_features: int, *, n_extra_layers: int = 0,
                 activation: str = "SiLU", final_activation: bool = False, layer_norm: bool = True,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.activation = activation
        self.final_activation = final_activation
        self.act = get_activation(activation)
        widths = [in_features] + [hidden_dim] * (n_extra_layers + 2) + [out_features]
        self.num_dense = len(widths) - 1
        for i in range(self.num_dense):
            setattr(self, f"Dense_{i}", Dense(widths[i], widths[i + 1], dtype=dtype, device=device))
        self.AutocastLayerNorm_0 = AutocastLayerNorm(out_features, device=device) if layer_norm else None

    def dense(self) -> list[Dense]:
        return [getattr(self, f"Dense_{i}") for i in range(self.num_dense)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self.dense()
        for layer in layers[:-1]:
            x = self.act(layer(x))
        x = layers[-1](x)
        if self.final_activation:
            x = self.act(x)
        if self.AutocastLayerNorm_0 is not None:
            x = self.AutocastLayerNorm_0(x)
        return x
