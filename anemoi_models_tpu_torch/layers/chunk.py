"""Processor chunks: groups of blocks.

Counterpart of ``GraphTransformerProcessorChunk`` in
``anemoi_models_tpu/layers/chunk.py``. In the JAX package a chunk is the
rematerialisation unit; serving needs no remat, so here a chunk only keeps the
parameter layout (``proc.<c>.blocks.<i>``) of the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.block import GraphTransformerProcessorBlock

__all__ = ["GraphTransformerProcessorChunk"]


class GraphTransformerProcessorChunk(nn.Module):
    """``num_layers`` per-edge-attention blocks."""

    def __init__(self, num_channels: int, num_layers: int, edge_dim: int, *, num_heads: int = 16,
                 mlp_hidden_ratio: int = 4, activation: str = "GELU",
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            GraphTransformerProcessorBlock(
                num_channels, mlp_hidden_ratio * num_channels, num_channels, edge_dim,
                num_heads=num_heads, activation=activation, dtype=dtype, device=device,
            )
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, edge_attr: torch.Tensor, rowptr: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, edge_attr, rowptr, src)
        return x
