"""Processor chunks: groups of blocks, the rematerialisation unit.

Counterpart of ``GraphTransformerProcessorChunk`` in
``anemoi_models_tpu/layers/chunk.py``. As the JAX package wraps each chunk in
``nn.remat`` (``layers/processor.py:_remat``), ``remat_policy="full"`` runs a
chunk under ``torch.utils.checkpoint`` while gradients are recorded: its
activations are dropped after the forward and recomputed in the backward.
``"none"`` keeps them. The JAX package's other policies (``"auto"``,
``"save_dots"``) are XLA-specific and not ported.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from anemoi_models_tpu_torch.layers.block import GraphTransformerProcessorBlock
from anemoi_models_tpu_torch.ops.edge_attention import CSRTranspose

__all__ = ["GraphTransformerProcessorChunk"]

REMAT_POLICIES = ("full", "none")


class GraphTransformerProcessorChunk(nn.Module):
    """``num_layers`` per-edge-attention blocks."""

    def __init__(self, num_channels: int, num_layers: int, edge_dim: int, *, num_heads: int = 16,
                 mlp_hidden_ratio: int = 4, activation: str = "GELU", remat_policy: str = "full",
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy {remat_policy!r} is not ported; the port takes {REMAT_POLICIES}"
            )
        self.remat_policy = remat_policy
        self.blocks = nn.ModuleList(
            GraphTransformerProcessorBlock(
                num_channels, mlp_hidden_ratio * num_channels, num_channels, edge_dim,
                num_heads=num_heads, activation=activation, dtype=dtype, device=device,
            )
            for _ in range(num_layers)
        )

    def _run(self, x: torch.Tensor, edge_attr: torch.Tensor, rowptr: torch.Tensor,
             src: torch.Tensor, csr_t: CSRTranspose) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, edge_attr, rowptr, src, csr_t)
        return x

    def forward(self, x: torch.Tensor, edge_attr: torch.Tensor, rowptr: torch.Tensor,
                src: torch.Tensor, csr_t: CSRTranspose) -> torch.Tensor:
        if self.remat_policy == "full" and torch.is_grad_enabled():
            return checkpoint(self._run, x, edge_attr, rowptr, src, csr_t, use_reentrant=False)
        return self._run(x, edge_attr, rowptr, src, csr_t)
