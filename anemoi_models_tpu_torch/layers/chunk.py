"""Processor chunks: groups of blocks, the rematerialisation unit.

Counterparts of ``TransformerProcessorChunk``, ``GNNProcessorChunk`` and
``GraphTransformerProcessorChunk`` in ``anemoi_models_tpu/layers/chunk.py``.
A chunk is the processors' rematerialisation unit, as the JAX package
wraps each chunk in ``nn.remat`` (``layers/processor.py:_remat``): it runs
through :func:`~anemoi_models_tpu_torch.layers.remat.run_unit` under its
``remat_policy`` (``"full"``, ``"save_dots"``, ``"none"``; ``"auto"`` is
``"full"`` here) or, with ``cpu_offload``, with its saved activations in
host memory (``layers/remat.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.block import (
    GraphConvProcessorBlock,
    GraphTransformerProcessorBlock,
    TransformerProcessorBlock,
)
from anemoi_models_tpu_torch.layers.mlp import MLP
from anemoi_models_tpu_torch.layers.remat import check_policy, run_unit
from anemoi_models_tpu_torch.ops.edge_attention import CSRTranspose

__all__ = ["TransformerProcessorChunk", "GNNProcessorChunk", "GraphTransformerProcessorChunk"]


class _Chunk(nn.Module):
    """Runs ``_run`` as a remat unit under ``remat_policy`` or
    ``cpu_offload``."""

    def __init__(self, remat_policy: str, cpu_offload: bool) -> None:
        super().__init__()
        self.remat_policy = check_policy(remat_policy)
        self.cpu_offload = cpu_offload

    def forward(self, *args):
        return run_unit(self._run, *args, remat_policy=self.remat_policy, cpu_offload=self.cpu_offload, owner=self)


class TransformerProcessorChunk(_Chunk):
    """``num_layers`` sliding-window transformer blocks; block ``l`` is the
    processor's layer ``first_layer + l``, the index its dropout key folds in.
    A chunk recomputed in the backward gets the same key as its forward, so it
    redraws the same masks."""

    def __init__(self, num_channels: int, num_layers: int, window_size: Optional[int], *, num_heads: int = 16,
                 mlp_hidden_ratio: int = 4, activation: str = "GELU", dropout_p: float = 0.0,
                 attention_impl: str = "auto", deterministic: bool = True, remat_policy: str = "full",
                 cpu_offload: bool = False, first_layer: int = 0, seq_len: int = 0,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(remat_policy, cpu_offload)
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
                 edge_dim: Optional[int] = None, remat_policy: str = "full", cpu_offload: bool = False,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(remat_policy, cpu_offload)
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
             src: torch.Tensor, csr_t: CSRTranspose, halo=None) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, N, C); edge_attr (E, edge_dim) raw for the embedding chunk,
        else (B, E, C) -> (x, edge_attr (B, E, C)). ``csr_t``: the edge list
        by source; ``halo``: (mesh, the rank's HaloShard) under a
        model-sharded mesh, else None."""
        if self.emb_edges is not None:
            edge_attr = self.emb_edges(edge_attr).unsqueeze(0).expand(x.shape[0], -1, -1)
        for block in self.blocks:
            x, edge_attr = block(x, edge_attr, rowptr, src, csr_t, halo)
        return x, edge_attr


class GraphTransformerProcessorChunk(_Chunk):
    """``num_layers`` per-edge-attention blocks."""

    def __init__(self, num_channels: int, num_layers: int, edge_dim: int, *, num_heads: int = 16,
                 mlp_hidden_ratio: int = 4, activation: str = "GELU", remat_policy: str = "full",
                 cpu_offload: bool = False, dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(remat_policy, cpu_offload)
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
