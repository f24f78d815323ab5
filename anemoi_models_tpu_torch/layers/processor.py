"""GraphTransformer processor on the hidden mesh.

Counterpart of ``GraphTransformerProcessor`` and ``register_edges`` in
``anemoi_models_tpu/layers/processor.py``. The edge set is registered once at
construction as a CSR list (``rowptr``, ``src``) plus its static attributes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from anemoi_models_tpu_torch.layers.chunk import GraphTransformerProcessorChunk
from anemoi_models_tpu_torch.layers.graph import TrainableTensor
from anemoi_models_tpu_torch.ops.edge_attention import csr_from_edge_index

__all__ = ["GraphTransformerProcessor", "register_edges"]

# Layouts of the JAX package's conv; the port has one CSR path for both.
GRAPH_IMPLS = ("dense", "pallas")


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
    num_src: int, num_dst: int, graph_impl: str, device,
) -> int:
    """Give ``module`` the edge set: buffers ``edge_attr``, ``rowptr``, ``src``
    (graph-derived, not saved in the state dict) and the parameter
    ``trainable.trainable``. Returns the edge feature width."""
    if graph_impl not in GRAPH_IMPLS:
        raise ValueError(f"graph_impl must be one of {GRAPH_IMPLS}, got {graph_impl!r}")
    edge_attr, edge_index, edge_dim = register_edges(sub_graph, edge_attributes, trainable_size)
    rowptr, src = csr_from_edge_index(edge_index, num_src, num_dst)
    module.register_buffer("edge_attr", torch.as_tensor(edge_attr, device=device), persistent=False)
    module.register_buffer("rowptr", torch.as_tensor(rowptr, device=device), persistent=False)
    module.register_buffer("src", torch.as_tensor(src, device=device), persistent=False)
    module.trainable = TrainableTensor(edge_attr.shape[0], trainable_size, device=device)
    return edge_dim


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
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        if num_layers % num_chunks:
            raise ValueError(f"num_layers ({num_layers}) must split evenly into {num_chunks} chunks")
        self.dtype = dtype
        edge_dim = register_edge_buffers(
            self, sub_graph, sub_graph_edge_attributes, trainable_size,
            src_grid_size, dst_grid_size, graph_impl, device,
        )
        self.proc = nn.ModuleList(
            GraphTransformerProcessorChunk(
                num_channels, num_layers // num_chunks, edge_dim, num_heads=num_heads,
                mlp_hidden_ratio=mlp_hidden_ratio, activation=activation, dtype=dtype, device=device,
            )
            for _ in range(num_chunks)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C)."""
        edge_attr = self.trainable(self.edge_attr.to(self.dtype))
        for chunk in self.proc:
            x = chunk(x, edge_attr, self.rowptr, self.src)
        return x
