"""Processors on the hidden mesh: chunked stacks of blocks.

Counterparts of ``TransformerProcessor``, ``GNNProcessor``,
``GraphTransformerProcessor`` and ``register_edges`` in
``anemoi_models_tpu/layers/processor.py``. A graph processor's edge set is
registered once at construction as a CSR list (``rowptr``, ``src``), its
transpose for the attention backward (``perm_t``, ``colptr_t``, ``dst_t``, ``pos_t``)
and its static attributes. The Transformer processor attends over mesh
positions and takes no graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from anemoi_models_tpu_torch.layers.chunk import (
    GNNProcessorChunk,
    GraphTransformerProcessorChunk,
    TransformerProcessorChunk,
)
from anemoi_models_tpu_torch.layers.graph import TrainableTensor
from anemoi_models_tpu_torch.ops.edge_attention import CSRTranspose, csr_from_edge_index, csr_transpose

__all__ = [
    "TransformerProcessor",
    "GNNProcessor",
    "GraphTransformerProcessor",
    "register_edges",
    "register_edge_buffers",
    "edge_csr_t",
]

# Layouts of the JAX package's convs; the port has one CSR path for each.
GRAPH_IMPLS = ("dense", "pallas")
GNN_GRAPH_IMPLS = ("dense", "pallas", "segment")


def register_edges(
    sub_graph, edge_attributes: Optional[list[str]], trainable_size: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """(edge_attr (E, A), edge_index (2, E), edge_dim = A + trainable_size)."""
    if sub_graph is None:
        raise ValueError("A valid sub_graph is required to register edges.")
    if edge_attributes is None:
        raise ValueError("the edge attributes to register must be named (got None)")
    edge_attr = sub_graph.attr_tensor(list(edge_attributes))
    edge_index = np.asarray(sub_graph.edge_index, dtype=np.int32)
    return edge_attr, edge_index, edge_attr.shape[1] + trainable_size


def register_edge_buffers(
    module: nn.Module, sub_graph, edge_attributes, trainable_size: int,
    num_src: int, num_dst: int, graph_impl: str, device, graph_impls: tuple = GRAPH_IMPLS,
) -> int:
    """Give ``module`` the edge set: buffers ``edge_attr``, ``rowptr``, ``src``
    and the transposed CSR ``perm_t``, ``colptr_t``, ``dst_t``, ``pos_t`` (graph-derived,
    not saved in the state dict) and the parameter ``trainable.trainable``.
    Returns the edge feature width."""
    if graph_impl not in graph_impls:
        raise ValueError(f"graph_impl must be one of {graph_impls}, got {graph_impl!r}")
    edge_attr, edge_index, edge_dim = register_edges(sub_graph, edge_attributes, trainable_size)
    rowptr, src = csr_from_edge_index(edge_index, num_src, num_dst)
    perm_t, colptr_t, dst_t, pos_t = csr_transpose(rowptr, src, num_src)
    buffers = dict(edge_attr=edge_attr, rowptr=rowptr, src=src, perm_t=perm_t, colptr_t=colptr_t, dst_t=dst_t,
                   pos_t=pos_t)
    for name, value in buffers.items():
        module.register_buffer(name, torch.as_tensor(value, device=device), persistent=False)
    module.trainable = TrainableTensor(edge_attr.shape[0], trainable_size, device=device)
    return edge_dim


def edge_csr_t(module: nn.Module) -> CSRTranspose:
    """The transposed CSR that :func:`register_edge_buffers` gave ``module``."""
    return CSRTranspose(module.perm_t, module.colptr_t, module.dst_t, module.pos_t)


def _chunk_size(num_layers: int, num_chunks: int) -> int:
    if num_layers % num_chunks:
        raise ValueError(f"num_layers ({num_layers}) must split evenly into {num_chunks} chunks")
    return num_layers // num_chunks


class TransformerProcessor(nn.Module):
    """Sliding-window transformer over the hidden mesh positions:
    ``num_layers`` blocks in ``num_chunks`` chunks. With ``deterministic=False``
    the attention drops weights at ``dropout_p`` under the ``dropout_key``
    the forward is given (each layer folds in its index)."""

    def __init__(
        self,
        num_layers: int,
        *,
        window_size: Optional[int] = None,
        num_channels: int = 128,
        num_chunks: int = 2,
        activation: str = "GELU",
        num_heads: int = 16,
        mlp_hidden_ratio: int = 4,
        dropout_p: float = 0.1,
        attention_impl: str = "auto",
        remat_policy: str = "full",
        deterministic: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        chunk_size = _chunk_size(num_layers, num_chunks)
        self.proc = nn.ModuleList(
            TransformerProcessorChunk(
                num_channels, chunk_size, window_size, num_heads=num_heads,
                mlp_hidden_ratio=mlp_hidden_ratio, activation=activation, dropout_p=dropout_p,
                attention_impl=attention_impl, deterministic=deterministic, remat_policy=remat_policy,
                first_layer=c * chunk_size, dtype=dtype, device=device,
            )
            for c in range(num_chunks)
        )

    def forward(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C)."""
        for chunk in self.proc:
            x = chunk(x, dropout_key)
        return x


class GNNProcessor(nn.Module):
    """Edge-MLP message-passing processor: ``num_layers`` blocks in
    ``num_chunks`` chunks over the hidden-to-hidden edge set; the first chunk
    embeds the edge attributes and the updated edges thread through the
    layers and chunks."""

    def __init__(
        self,
        num_layers: int,
        *,
        trainable_size: int = 8,
        num_channels: int = 128,
        num_chunks: int = 2,
        mlp_extra_layers: int = 0,
        activation: str = "SiLU",
        sub_graph=None,
        sub_graph_edge_attributes: Optional[list[str]] = ("edge_length", "edge_dirs"),
        src_grid_size: int = 0,
        dst_grid_size: int = 0,
        graph_impl: str = "dense",
        remat_policy: str = "full",
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        chunk_size = _chunk_size(num_layers, num_chunks)
        self.dtype = dtype
        edge_dim = register_edge_buffers(
            self, sub_graph, sub_graph_edge_attributes, trainable_size,
            src_grid_size, dst_grid_size, graph_impl, device, GNN_GRAPH_IMPLS,
        )
        self.proc = nn.ModuleList(
            GNNProcessorChunk(
                num_channels, chunk_size, mlp_extra_layers=mlp_extra_layers, activation=activation,
                edge_dim=edge_dim if c == 0 else None, remat_policy=remat_policy, dtype=dtype, device=device,
            )
            for c in range(num_chunks)
        )

    def forward(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C); no layer drops, so ``dropout_key`` is unused."""
        edge_attr = self.trainable(self.edge_attr.to(self.dtype))
        for chunk in self.proc:
            x, edge_attr = chunk(x, edge_attr, self.rowptr, self.src)
        return x


class GraphTransformerProcessor(nn.Module):
    """Per-edge attention processor: ``num_layers`` blocks in ``num_chunks``
    chunks over the hidden-to-hidden edge set."""

    def __init__(
        self,
        num_layers: int,
        *,
        num_channels: int = 128,
        num_chunks: int = 2,
        num_heads: int = 16,
        mlp_hidden_ratio: int = 4,
        activation: str = "GELU",
        trainable_size: int = 8,
        sub_graph=None,
        sub_graph_edge_attributes: Optional[list[str]] = ("edge_length", "edge_dirs"),
        src_grid_size: int = 0,
        dst_grid_size: int = 0,
        graph_impl: str = "dense",
        remat_policy: str = "full",
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        chunk_size = _chunk_size(num_layers, num_chunks)
        self.dtype = dtype
        edge_dim = register_edge_buffers(
            self, sub_graph, sub_graph_edge_attributes, trainable_size,
            src_grid_size, dst_grid_size, graph_impl, device,
        )
        self.proc = nn.ModuleList(
            GraphTransformerProcessorChunk(
                num_channels, chunk_size, edge_dim, num_heads=num_heads,
                mlp_hidden_ratio=mlp_hidden_ratio, activation=activation, remat_policy=remat_policy,
                dtype=dtype, device=device,
            )
            for _ in range(num_chunks)
        )

    def forward(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C); no layer drops, so ``dropout_key`` is unused."""
        edge_attr = self.trainable(self.edge_attr.to(self.dtype))
        csr_t = edge_csr_t(self)
        for chunk in self.proc:
            x = chunk(x, edge_attr, self.rowptr, self.src, csr_t)
        return x
