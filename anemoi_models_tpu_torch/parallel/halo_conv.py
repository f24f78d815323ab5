"""GNN and GraphTransformer layers on a self-graph under 1-hop halo exchange.

Counterpart of ``anemoi_models_tpu/parallel/halo_conv.py``. Each rank holds
its contiguous rows of the hidden mesh and the edges into them (the graph is
split by destination, so each destination's softmax or sum is complete on
its rank and needs no merge across ranks):

- :func:`halo_graph_conv`: the GNN conv (message ``MLP(cat[x_i, x_j, e]) +
  e``, summed per destination) through :class:`~anemoi_models_tpu_torch.ops.gnn_conv.GNNConv`,
  the hand-written kernel on the card, on the halo-extended rows and the
  rank's CSR. The updated edge features stay on their rank between layers,
  as the JAX package threads ``edges_new``.
- :func:`halo_graph_transformer_conv`: per-edge attention. ``[k|v]`` is
  projected on the rank's own rows (:class:`~anemoi_models_tpu_torch.ops.edge_attention.KVProj`),
  then one halo exchange of the per-node ``[k|v]`` (the JAX package makes
  two, one of k and one of v), then :class:`~anemoi_models_tpu_torch.ops.edge_attention.EdgeAttnCSR`
  on the rank's query rows: the function of the JAX package's Pallas kernel
  ``_kernel`` (per-edge attention from precomputed per-node k and v) and its
  backward ``_bwd_kernel``, reached through the caller the JAX package gives
  them. ``halo_planned_edge_attention`` computes the same function through
  the TPU's slot plans; this is its port too.

:func:`shard_edge_values` puts global per-edge values into the rank's order.
"""

from __future__ import annotations

from typing import Sequence

import torch

from anemoi_models_tpu_torch.graphs.partition import HaloShard
from anemoi_models_tpu_torch.layers.conv import attend_kv, project_kv
from anemoi_models_tpu_torch.ops.gnn_conv import GNNConv
from anemoi_models_tpu_torch.parallel.api import Mesh
from anemoi_models_tpu_torch.parallel.halo import halo_exchange

__all__ = ["halo_graph_conv", "halo_graph_transformer_conv", "shard_edge_values"]


def _check_mesh(mesh: Mesh, shard: HaloShard) -> None:
    if mesh.shape["model"] != shard.num_shards:
        raise ValueError(f"the shard is one of {shard.num_shards}, the mesh's model axis has {mesh.shape['model']}")


def shard_edge_values(values: torch.Tensor, shard: HaloShard) -> torch.Tensor:
    """(..., E, C) global per-edge values in CSR order -> (..., E_local, C),
    the rank's edges in its CSR's order (a slice; its adjoint puts the
    gradient back in place)."""
    return values[..., shard.edge_lo:shard.edge_hi, :]


def halo_graph_conv(
    mesh: Mesh,
    shard: HaloShard,
    params: Sequence[torch.Tensor],
    x: torch.Tensor,
    edges: torch.Tensor,
    activation: str = "SiLU",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One GNN conv aggregation under halo exchange.

    - ``params``: the edge MLP as :class:`GNNConv` takes it: each Dense's
      ``weight`` (out, in) and ``bias``, then the LayerNorm's ``weight`` and
      ``bias``;
    - ``x``: (B, num_local, C) the rank's rows;
    - ``edges``: (B, E_local, C) the rank's edge features (see
      :func:`shard_edge_values`).

    Returns ``(agg, edges_new)``: (B, num_local, C) the summed messages (fp32
    from the kernel, in the edges' dtype) and (B, E_local, C) the messages,
    the next layer's edge features."""
    _check_mesh(mesh, shard)
    dt = edges.dtype
    x_ext = halo_exchange(x, shard)
    agg, msg = GNNConv.apply(x.to(dt).contiguous(), x_ext.to(dt).contiguous(), edges.contiguous(), shard.rowptr,
                             shard.src, shard.csr_t, activation, *params)
    return agg.to(dt), msg


def halo_graph_transformer_conv(
    mesh: Mesh,
    shard: HaloShard,
    query: torch.Tensor,  # (B, num_local, H, D) the rank's destination queries
    feats: torch.Tensor,  # (B, num_local, F) the rank's source features (post-LN)
    w_kv: torch.Tensor,  # (2C, F) [k | v] projection, torch Linear layout
    b_kv: torch.Tensor,  # (2C,)
    edge_attr: torch.Tensor,  # (E_local, A) the rank's edge attributes (static + trainable)
    w_edge: torch.Tensor,  # (C, A)
    b_edge: torch.Tensor,  # (C,)
) -> torch.Tensor:
    """Per-edge attention on the rank's destinations, (B, num_local, H, D)
    in the query's dtype: ``[k|v]`` of the rank's own rows, one halo
    exchange of it, then the attention over the rank's CSR."""
    _check_mesh(mesh, shard)
    b, n = feats.shape[:2]
    kv_own = project_kv(feats, w_kv, b_kv, query.dtype).view(b, n, -1)
    kv_ext = halo_exchange(kv_own, shard)
    return attend_kv(query, kv_ext.reshape(-1, kv_ext.shape[-1]), edge_attr, w_edge, b_edge, shard.rowptr,
                     shard.src, shard.csr_t)
