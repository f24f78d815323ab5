"""Processor chunks: groups of blocks, the rematerialisation unit.

Counterparts of ``TransformerProcessorChunk``, ``GNNProcessorChunk`` and
``GraphTransformerProcessorChunk`` in ``anemoi_models_tpu/layers/chunk.py``.
As the JAX package wraps each chunk in ``nn.remat``
(``layers/processor.py:_remat``), ``remat_policy="full"`` runs a chunk under
``torch.utils.checkpoint`` while gradients are recorded: its activations are
dropped after the forward and recomputed in the backward. ``"none"`` keeps
them. The JAX package's other policies (``"auto"``, ``"save_dots"``) are
XLA-specific and not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from anemoi_models_tpu_torch.layers.block import (
    GraphConvProcessorBlock,
    GraphTransformerProcessorBlock,
    TransformerProcessorBlock,
)
from anemoi_models_tpu_torch.layers.mlp import MLP
from anemoi_models_tpu_torch.ops.edge_attention import CSRTranspose

__all__ = ["TransformerProcessorChunk", "GNNProcessorChunk", "GraphTransformerProcessorChunk"]

REMAT_POLICIES = ("full", "none")


class _Chunk(nn.Module):
    """Runs ``_run`` under ``torch.utils.checkpoint`` with ``"full"``."""

    def __init__(self, remat_policy: str) -> None:
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy {remat_policy!r} is not ported; the port takes {REMAT_POLICIES}"
            )
        self.remat_policy = remat_policy

    def forward(self, *args):
        if self.remat_policy == "full" and torch.is_grad_enabled():
            return checkpoint(self._run, *args, use_reentrant=False)
        return self._run(*args)


class TransformerProcessorChunk(_Chunk):
    """``num_layers`` sliding-window transformer blocks; block ``l`` is the
    processor's layer ``first_layer + l``, the index its dropout key folds in.
    A chunk recomputed in the backward gets the same key as its forward, so it
    redraws the same masks."""

    def __init__(self, num_channels: int, num_layers: int, window_size: Optional[int], *, num_heads: int = 16,
                 mlp_hidden_ratio: int = 4, activation: str = "GELU", dropout_p: float = 0.0,
                 attention_impl: str = "auto", deterministic: bool = True, remat_policy: str = "full",
                 first_layer: int = 0, seq_len: int = 0, dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(remat_policy)
        self.deterministic = deterministic
        self.blocks = nn.ModuleList(
            TransformerProcessorBlock(
                num_channels, mlp_hidden_ratio * num_channels, num_heads, activation=activation,
                window_size=window_size, dropout_p=dropout_p, attention_impl=attention_impl,
                layer_index=first_layer + i, seq_len=seq_len, dtype=dtype, device=device,
            )
            for i in range(num_layers)
        )

    def _run(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, self.deterministic, dropout_key)
        return x


class GNNProcessorChunk(_Chunk):
    """``num_layers`` message-passing blocks; a chunk given ``edge_dim``
    (the first) embeds the edge attributes (``emb_edges``)."""

    def __init__(self, num_channels: int, num_layers: int, *, mlp_extra_layers: int = 0, activation: str = "SiLU",
                 edge_dim: Optional[int] = None, remat_policy: str = "full", dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__(remat_policy)
        self.emb_edges = MLP(
            edge_dim, num_channels, num_channels, n_extra_layers=mlp_extra_layers, activation=activation,
            dtype=dtype, device=device,
        ) if edge_dim else None
        self.blocks = nn.ModuleList(
            GraphConvProcessorBlock(
                num_channels, num_channels, mlp_extra_layers=mlp_extra_layers, activation=activation,
                dtype=dtype, device=device,
            )
            for _ in range(num_layers)
        )

    def _run(self, x: torch.Tensor, edge_attr: torch.Tensor, rowptr: torch.Tensor,
             src: torch.Tensor, halo=None) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, N, C); edge_attr (E, edge_dim) raw for the embedding chunk,
        else (B, E, C) -> (x, edge_attr (B, E, C)). ``halo``: (mesh, the
        rank's HaloShard) under a model-sharded mesh, else None."""
        if self.emb_edges is not None:
            edge_attr = self.emb_edges(edge_attr).unsqueeze(0).expand(x.shape[0], -1, -1)
        for block in self.blocks:
            x, edge_attr = block(x, edge_attr, rowptr, src, halo)
        return x, edge_attr


class GraphTransformerProcessorChunk(_Chunk):
    """``num_layers`` per-edge-attention blocks."""

    def __init__(self, num_channels: int, num_layers: int, edge_dim: int, *, num_heads: int = 16,
                 mlp_hidden_ratio: int = 4, activation: str = "GELU", remat_policy: str = "full",
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(remat_policy)
        self.blocks = nn.ModuleList(
            GraphTransformerProcessorBlock(
                num_channels, mlp_hidden_ratio * num_channels, num_channels, edge_dim,
                num_heads=num_heads, activation=activation, dtype=dtype, device=device,
            )
            for _ in range(num_layers)
        )

    def _run(self, x: torch.Tensor, edge_attr: torch.Tensor, rowptr: torch.Tensor,
             src: torch.Tensor, csr_t: CSRTranspose, halo=None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, edge_attr, rowptr, src, csr_t, halo)
        return x
