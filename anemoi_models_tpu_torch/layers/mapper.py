"""Mappers: grid <-> mesh encoders and decoders over bipartite graphs.

Counterparts of the mappers in ``anemoi_models_tpu/layers/mapper.py``:

- ``GraphTransformerForwardMapper`` (data -> hidden encoder) and
  ``GraphTransformerBackwardMapper`` (hidden -> data decoder), cross
  attention in the wide form: the forward mapper embeds its source rows
  (``emb_nodes_src``) before the block. Under the JAX commuted dataflow the
  same parameter sits at ``encoder/proc/emb_nodes_src``; ``weights.py``
  accepts both places.
- ``GNNForwardMapper`` and ``GNNBackwardMapper``, edge-MLP message passing.
  The forward mapper embeds both node sets with MLPs and returns the
  updated source at hidden width; the backward mapper ends in the
  ``node_data_extractor`` MLP (no LayerNorm, no final activation).

Each mapper's block (``proc``) is a remat unit of ``layers/remat.py``,
recomputed in the backward under every ``remat_policy`` as the JAX mappers
wrap it in ``nn.remat`` (``mapper.py:140-148``, ``:272-277``), or, with
``cpu_offload``, with its saved activations in host memory. The mappers take
every field of their JAX classes; ``num_chunks`` splits the JAX block's
edges into chunks that sum to the same aggregate, and the port's kernels
never hold per-edge activations, so it has no code path here.

Under a mesh whose ``model`` axis is larger than 1, each rank holds its rows
of both node sets and the mappers take the destination-sharded path
(``parallel/mapper_conv.py``) on the rank's part of the edge set
(:func:`~anemoi_models_tpu_torch.layers.processor.mapper_shard_of`), as the
JAX mappers route to it (``mapper.py:115-130``): one all-gather of the
narrow source rows (the forward mapper embeds its sources after it), then
the rank's destinations.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.block import GraphConvMapperBlock, GraphTransformerMapperBlock
from anemoi_models_tpu_torch.layers.mlp import MLP
from anemoi_models_tpu_torch.layers.processor import (
    check_tpu_only,
    edge_csr_t,
    mapper_shard_of,
    register_edge_buffers,
)
from anemoi_models_tpu_torch.layers.remat import run_unit
from anemoi_models_tpu_torch.parallel.api import model_sharded
from anemoi_models_tpu_torch.layers.utils import AutocastLayerNorm, Dense

__all__ = [
    "GraphTransformerForwardMapper",
    "GraphTransformerBackwardMapper",
    "GNNForwardMapper",
    "GNNBackwardMapper",
]

# graph_impl values the JAX GNN mappers take (the slot kernel needs a self-graph)
GNN_MAPPER_GRAPH_IMPLS = ("dense", "segment")


class _GraphTransformerBaseMapper(nn.Module):
    def __init__(
        self,
        *,
        in_channels_src: int = 0,
        in_channels_dst: int = 0,
        hidden_dim: int = 128,
        trainable_size: int = 8,
        out_channels_dst: Optional[int] = None,
        num_chunks: int = 1,
        cpu_offload: bool = False,
        activation: str = "GELU",
        num_heads: int = 16,
        mlp_hidden_ratio: int = 4,
        sub_graph=None,
        sub_graph_edge_attributes: Optional[list[str]] = ("edge_length", "edge_dirs"),
        src_grid_size: int = 0,
        dst_grid_size: int = 0,
        graph_impl: str = "dense",
        plan_block_nodes: int = 0,
        plan_slab_width: int = 0,
        kv_src_gather: str = "auto",
        deterministic: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        check_tpu_only(type(self).__name__, plan_block_nodes=plan_block_nodes, plan_slab_width=plan_slab_width,
                       kv_src_gather=kv_src_gather)
        # the backward mapper takes out_channels_dst; edge chunks sum alike; the JAX block picks its
        # inference edge chunking by deterministic, and nothing here drops
        del out_channels_dst, num_chunks, deterministic
        self.cpu_offload = cpu_offload
        self.dtype = dtype
        edge_dim = register_edge_buffers(
            self, sub_graph, sub_graph_edge_attributes, trainable_size,
            src_grid_size, dst_grid_size, graph_impl, device,
        )
        self.emb_nodes_dst = Dense(in_channels_dst, hidden_dim, dtype=dtype, device=device)
        self.proc = GraphTransformerMapperBlock(
            hidden_dim, mlp_hidden_ratio * hidden_dim, hidden_dim, edge_dim,
            num_heads=num_heads, activation=activation, dtype=dtype, device=device,
        )

    def _run(self, x_src: torch.Tensor, x_dst: torch.Tensor, src_transform=None) -> torch.Tensor:
        edge_attr = self.trainable(self.edge_attr.to(self.dtype))
        rowptr, src, csr_t, shard = self.rowptr, self.src, edge_csr_t(self), None
        mesh = model_sharded()
        if mesh is not None:
            part = mapper_shard_of(self, mesh)
            edge_attr = edge_attr[part.edge_lo:part.edge_hi]
            rowptr, src, csr_t, shard = part.rowptr, part.src, part.csr_t, (mesh, part)
        _, x_dst = run_unit(self.proc, (x_src, self.emb_nodes_dst(x_dst)), edge_attr, rowptr, src, csr_t, shard,
                            src_transform, remat_policy="full", cpu_offload=self.cpu_offload, owner=self)
        return x_dst


class GraphTransformerForwardMapper(_GraphTransformerBaseMapper):
    """data -> hidden. Returns ``(x_src_in, x_dst_hidden)``: the un-embedded
    source passes through for the decoder's skip path."""

    def __init__(self, *, in_channels_src: int, hidden_dim: int = 128, device=None, **kwargs) -> None:
        super().__init__(in_channels_src=in_channels_src, hidden_dim=hidden_dim, device=device, **kwargs)
        self.emb_nodes_src = Dense(in_channels_src, hidden_dim, dtype=self.dtype, device=device)

    def forward(self, x: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        x_src_in, x_dst_in = x
        return x_src_in, self._run(x_src_in, x_dst_in, self.emb_nodes_src)


class GraphTransformerBackwardMapper(_GraphTransformerBaseMapper):
    """hidden -> data, then ``node_data_extractor`` (LN + Dense) to
    ``out_channels_dst``."""

    def __init__(self, *, out_channels_dst: int, hidden_dim: int = 128, device=None, **kwargs) -> None:
        super().__init__(out_channels_dst=out_channels_dst, hidden_dim=hidden_dim, device=device, **kwargs)
        self.node_data_extractor_norm = AutocastLayerNorm(hidden_dim, device=device)
        self.node_data_extractor = Dense(hidden_dim, out_channels_dst, dtype=self.dtype, device=device)

    def forward(self, x: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        x_src, x_dst_in = x
        x_dst = self._run(x_src, x_dst_in)
        return self.node_data_extractor(self.node_data_extractor_norm(x_dst))


class _GNNBaseMapper(nn.Module):
    def __init__(
        self,
        *,
        in_channels_src: int = 0,
        in_channels_dst: int = 0,
        hidden_dim: int = 128,
        trainable_size: int = 8,
        out_channels_dst: Optional[int] = None,
        num_chunks: int = 1,
        cpu_offload: bool = False,
        activation: str = "SiLU",
        mlp_extra_layers: int = 0,
        sub_graph=None,
        sub_graph_edge_attributes: Optional[list[str]] = ("edge_length", "edge_dirs"),
        src_grid_size: int = 0,
        dst_grid_size: int = 0,
        graph_impl: str = "dense",
        update_src_nodes: bool,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        if graph_impl not in GNN_MAPPER_GRAPH_IMPLS:
            raise ValueError(
                f"GNN mappers support graph_impl {GNN_MAPPER_GRAPH_IMPLS} (the slot kernel needs a "
                f"self-graph; mapper convs are bipartite), got {graph_impl!r}"
            )
        self.cpu_offload = cpu_offload
        self.dtype = dtype
        self.mlp_kw = dict(n_extra_layers=mlp_extra_layers, activation=activation, dtype=dtype, device=device)
        edge_dim = register_edge_buffers(
            self, sub_graph, sub_graph_edge_attributes, trainable_size,
            src_grid_size, dst_grid_size, graph_impl, device, GNN_MAPPER_GRAPH_IMPLS,
        )
        self.emb_edges = MLP(edge_dim, hidden_dim, hidden_dim, **self.mlp_kw)
        self.proc = GraphConvMapperBlock(
            hidden_dim, hidden_dim, mlp_extra_layers=mlp_extra_layers, activation=activation,
            update_src_nodes=update_src_nodes, num_chunks=num_chunks, dtype=dtype, device=device,
        )

    def _run(self, x_src: torch.Tensor, x_dst: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        edge_attr = self.trainable(self.edge_attr.to(self.dtype))
        rowptr, src, csr_t, shard = self.rowptr, self.src, edge_csr_t(self), None
        mesh = model_sharded()
        if mesh is not None:  # the rank's edges, embedded after the slice (a per-row MLP)
            part = mapper_shard_of(self, mesh)
            edge_attr = edge_attr[part.edge_lo:part.edge_hi]
            rowptr, src, csr_t, shard = part.rowptr, part.src, part.csr_t, (mesh, part)
        edge_attr = self.emb_edges(edge_attr).unsqueeze(0).expand(x_src.shape[0], -1, -1)
        return run_unit(self.proc, (x_src, x_dst), edge_attr, rowptr, src, csr_t, shard, remat_policy="full",
                        cpu_offload=self.cpu_offload, owner=self)[0]


class GNNForwardMapper(_GNNBaseMapper):
    """data -> hidden. Returns ``(x_src_hidden_updated, x_dst_hidden)``: the
    source side is embedded to hidden width and updated, and the decoder
    consumes it at hidden width."""

    def __init__(self, *, in_channels_src: int, in_channels_dst: int, hidden_dim: int = 128, **kwargs) -> None:
        super().__init__(in_channels_src=in_channels_src, in_channels_dst=in_channels_dst,
                         hidden_dim=hidden_dim, update_src_nodes=True, **kwargs)
        self.emb_nodes_src = MLP(in_channels_src, hidden_dim, hidden_dim, **self.mlp_kw)
        self.emb_nodes_dst = MLP(in_channels_dst, hidden_dim, hidden_dim, **self.mlp_kw)

    def forward(self, x: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        x_src_in, x_dst_in = x
        return self._run(self.emb_nodes_src(x_src_in), self.emb_nodes_dst(x_dst_in))


class GNNBackwardMapper(_GNNBaseMapper):
    """hidden -> data, then the ``node_data_extractor`` MLP to
    ``out_channels_dst``."""

    def __init__(self, *, out_channels_dst: int, hidden_dim: int = 128, **kwargs) -> None:
        super().__init__(out_channels_dst=out_channels_dst, hidden_dim=hidden_dim, update_src_nodes=False,
                         **kwargs)
        self.node_data_extractor = MLP(hidden_dim, hidden_dim, out_channels_dst, layer_norm=False, **self.mlp_kw)

    def forward(self, x: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        x_src, x_dst = x
        return self.node_data_extractor(self._run(x_src, x_dst)[1])
