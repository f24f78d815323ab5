"""Destination-sharded mapper convolutions over the ``model`` axis.

Counterpart of ``anemoi_models_tpu/parallel/mapper_conv.py``. The encoder
and decoder cross two differently ordered node sets (the data grid and the
hidden mesh), so their gathers cannot stay on a rank the way the
processor's halo exchange does. As in the JAX package, everything is
destination-sharded: a rank holds its rows of both node sets and the edges
into its destinations (:class:`~anemoi_models_tpu_torch.graphs.partition.MapperShard`),
and the one collective is one all-gather of the *narrow* source rows (the
raw inputs for the encoder, the C-wide hidden rows for the decoder), never
of the 2 C-wide k/v. The rank then keeps the source rows its edges read,
projects them and attends over its own CSR, so each destination's softmax
completes on its rank.

- :func:`sharded_mapper_edge_attention`: the GraphTransformer mappers'
  attention, :class:`~anemoi_models_tpu_torch.ops.edge_attention.KVProj` and
  :class:`~anemoi_models_tpu_torch.ops.edge_attention.EdgeAttnCSR` on the
  rank's part (the kernels ``kv_proj``, ``edge_attn_csr`` and
  ``edge_attn_csr_bwd`` on the card);
- :func:`sharded_mapper_gnn_conv`: the same design for the GNN mappers,
  whose sharding the JAX package leaves to GSPMD: the sources gathered, then
  :class:`~anemoi_models_tpu_torch.ops.gnn_conv.GNNConv` on the rank's
  destinations.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from anemoi_models_tpu_torch.graphs.partition import MapperShard
from anemoi_models_tpu_torch.layers.conv import graph_transformer_conv
from anemoi_models_tpu_torch.ops.gnn_conv import GNNConv
from anemoi_models_tpu_torch.parallel.api import Mesh
from anemoi_models_tpu_torch.parallel.primitives import sync_tensor

__all__ = ["gather_source_rows", "sharded_mapper_edge_attention", "sharded_mapper_gnn_conv"]


def gather_source_rows(mesh: Mesh, shard: MapperShard, x: torch.Tensor) -> torch.Tensor:
    """(B, ns_local, F) the rank's source rows -> (B, len(src_rows), F) the
    source rows the rank's edges read: one all-gather over ``model``, whose
    adjoint sums the ranks' gradients and returns each rank its rows."""
    if mesh.shape["model"] != shard.num_shards:
        raise ValueError(f"the shard is one of {shard.num_shards}, the mesh's model axis has {mesh.shape['model']}")
    return sync_tensor(x, dim=1, axis="model", size=shard.num_src).index_select(1, shard.src_rows)


def sharded_mapper_edge_attention(
    mesh: Mesh,
    shard: MapperShard,
    query: torch.Tensor,  # (B, nd_local, H, D) the rank's destination queries
    src: torch.Tensor,  # (B, ns_local, F) the rank's narrow source rows
    w_kv: torch.Tensor,  # (2C, F') [k | v] projection, torch Linear layout
    b_kv: torch.Tensor,  # (2C,)
    edge_attr: torch.Tensor,  # (E_local, A) the rank's edge attributes, in its CSR order
    w_edge: torch.Tensor,  # (C, A)
    b_edge: torch.Tensor,  # (C,)
    src_transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,  # (..., F) -> (..., F') per row
) -> torch.Tensor:
    """Per-edge bipartite attention on the rank's destinations, (B,
    nd_local, H, D) in the query's dtype. ``src_transform`` (an embedding, a
    LayerNorm) runs on the gathered source rows, per row."""
    feats = gather_source_rows(mesh, shard, src)
    if src_transform is not None:
        feats = src_transform(feats)
    return graph_transformer_conv(query, feats, w_kv, b_kv, edge_attr, w_edge, b_edge, shard.rowptr, shard.src,
                                  shard.csr_t)


def sharded_mapper_gnn_conv(
    mesh: Mesh,
    shard: MapperShard,
    params: Sequence[torch.Tensor],
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    edges: torch.Tensor,
    activation: str = "SiLU",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The GNN conv on the rank's destinations: ``x_src`` (B, ns_local, C)
    and ``x_dst`` (B, nd_local, C) the rank's rows, ``edges`` (B, E_local, C)
    its edges, ``params`` the edge MLP as :class:`GNNConv` takes it. Returns
    ``(agg (B, nd_local, C), edges_new (B, E_local, C))`` in the edges' dtype."""
    dt = edges.dtype
    rows = gather_source_rows(mesh, shard, x_src)
    agg, msg = GNNConv.apply(x_dst.to(dt).contiguous(), rows.to(dt).contiguous(), edges.contiguous(), shard.rowptr,
                             shard.src, shard.csr_t, activation, *params)
    return agg.to(dt), msg
