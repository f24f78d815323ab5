"""Blocks of the three processor families and their mappers.

Counterparts of ``anemoi_models_tpu/layers/block.py``:

- :class:`TransformerProcessorBlock`: pre-LN sliding-window transformer
  block (``fc1`` / ``fc2`` are the flax ``Dense_0`` / ``Dense_1``).
- :class:`GraphConvProcessorBlock` and :class:`GraphConvMapperBlock`: the
  GNN flavor's message passing (edge-MLP conv, then ``node_mlp`` on
  ``cat[x, aggregated]`` with a residual). The JAX package's edge chunking
  (``num_chunks``) sums the same messages, so it has no code path here.
- :class:`GraphTransformerProcessorBlock` and
  :class:`GraphTransformerMapperBlock`, in the wide form: k/v are projected per source node, then attended
(:func:`~anemoi_models_tpu_torch.layers.conv.graph_transformer_conv`). The JAX
commuted form computes the same function; it drops the k-side bias, which is
softmax-invariant, and differs only in rounding.

The processor's fused ``lin_qkvs`` (columns ``[q | k | v | r]``) is held as
two layers here, ``lin_qr`` and ``lin_kv``, so that the ``[k|v]`` weight is
one contiguous block for the projection kernel (``weights.py`` splits it).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.attention import MultiHeadSelfAttention
from anemoi_models_tpu_torch.layers.conv import GraphConv, graph_transformer_conv
from anemoi_models_tpu_torch.layers.mlp import MLP
from anemoi_models_tpu_torch.layers.utils import AutocastLayerNorm, Dense, get_activation
from anemoi_models_tpu_torch.ops.edge_attention import CSRTranspose
from anemoi_models_tpu_torch.parallel.halo_conv import halo_graph_conv, halo_graph_transformer_conv
from anemoi_models_tpu_torch.parallel.mapper_conv import sharded_mapper_edge_attention, sharded_mapper_gnn_conv

__all__ = [
    "TransformerProcessorBlock",
    "GraphConvProcessorBlock",
    "GraphConvMapperBlock",
    "GraphTransformerProcessorBlock",
    "GraphTransformerMapperBlock",
]


class TransformerProcessorBlock(nn.Module):
    """Pre-LN transformer block: x + attn(LN(x)); x + fc2(act(fc1(LN(x))))."""

    def __init__(self, num_channels: int, hidden_dim: int, num_heads: int, *, activation: str = "GELU",
                 window_size: Optional[int] = None, dropout_p: float = 0.0, attention_impl: str = "auto",
                 layer_index: int = 0, seq_len: int = 0, dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.layer_norm1 = AutocastLayerNorm(num_channels, device=device)
        self.attention = MultiHeadSelfAttention(
            num_heads, num_channels, window_size=window_size, bias=False, is_causal=False,
            dropout_p=dropout_p, attention_impl=attention_impl, layer_index=layer_index, seq_len=seq_len,
            dtype=dtype, device=device,
        )
        self.layer_norm2 = AutocastLayerNorm(num_channels, device=device)
        self.fc1 = Dense(num_channels, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_dim, num_channels, dtype=dtype, device=device)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, deterministic: bool = True, dropout_key: Optional[int] = None) -> torch.Tensor:
        x = x + self.attention(self.layer_norm1(x), deterministic, dropout_key)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class _GraphConvBase(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, *, mlp_extra_layers: int = 0,
                 activation: str = "SiLU", num_chunks: int = 1, dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        del num_chunks  # edge chunks sum to the same aggregate
        self.conv = GraphConv(in_channels, out_channels, mlp_extra_layers=mlp_extra_layers,
                              activation=activation, dtype=dtype, device=device)
        self.node_mlp = MLP(2 * in_channels, out_channels, out_channels, n_extra_layers=mlp_extra_layers,
                            activation=activation, dtype=dtype, device=device)


class GraphConvProcessorBlock(_GraphConvBase):
    """Homogeneous-graph message-passing block. ``halo``: (mesh, the rank's
    HaloShard) under a model-sharded mesh (``x`` the rank's rows, the CSR
    and edges the rank's), and the conv runs under halo exchange."""

    def forward(self, x: torch.Tensor, edge_attr: torch.Tensor, rowptr: torch.Tensor,
                src: torch.Tensor, csr_t: CSRTranspose, halo=None) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, N, C), edge_attr (B, E, C) -> (new x, new edge_attr)."""
        if halo is None:
            out, edges_new = self.conv(x, edge_attr, rowptr, src, csr_t)
        else:
            out, edges_new = halo_graph_conv(*halo, self.conv.params(), x, edge_attr, self.conv.activation)
        return self.node_mlp(torch.cat([x, out], dim=-1)) + x, edges_new


class GraphConvMapperBlock(_GraphConvBase):
    """Bipartite-graph message-passing block. ``update_src_nodes`` (the
    forward mapper) runs the same ``node_mlp`` on ``cat[x_src, x_src]``.
    ``shard``: (mesh, the rank's MapperShard) under a model-sharded mesh:
    ``x_src`` and ``x_dst`` are the rank's rows, the edges the rank's, and
    the conv gathers the sources its edges read."""

    def __init__(self, in_channels: int, out_channels: int, *, update_src_nodes: bool = True, **kwargs) -> None:
        super().__init__(in_channels, out_channels, **kwargs)
        self.update_src_nodes = update_src_nodes

    def forward(self, x: tuple[torch.Tensor, torch.Tensor], edge_attr: torch.Tensor, rowptr: torch.Tensor,
                src: torch.Tensor, csr_t: CSRTranspose,
                shard=None) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """(x_src (B, Ns, C), x_dst (B, Nd, C)), edge_attr (B, E, C) ->
        ((new x_src, new x_dst), new edge_attr)."""
        x_src, x_dst = x
        if shard is None:
            out, edges_new = self.conv((x_src, x_dst), edge_attr, rowptr, src, csr_t)
        else:
            out, edges_new = sharded_mapper_gnn_conv(*shard, self.conv.params(), x_src, x_dst, edge_attr,
                                                     self.conv.activation)
        nodes_new_dst = self.node_mlp(torch.cat([x_dst, out], dim=-1)) + x_dst
        if self.update_src_nodes:
            x_src = self.node_mlp(torch.cat([x_src, x_src], dim=-1)) + x_src
        return (x_src, nodes_new_dst), edges_new


class DstMLP(nn.Module):
    """LN -> Dense -> activation -> Dense, the blocks' ``node_dst_mlp``."""

    def __init__(self, channels: int, hidden_dim: int, activation: str, *,
                 dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.norm = AutocastLayerNorm(channels, device=device)
        self.fc1 = Dense(channels, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_dim, channels, dtype=dtype, device=device)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(self.norm(x))))


class _GraphTransformerBase(nn.Module):
    def __init__(self, in_channels: int, hidden_dim: int, out_channels: int, edge_dim: int,
                 num_heads: int, activation: str, dtype: torch.dtype, device) -> None:
        super().__init__()
        if out_channels % num_heads:
            raise ValueError(f"out_channels ({out_channels}) must be divisible by num_heads ({num_heads})")
        self.num_heads = num_heads
        self.head_dim = out_channels // num_heads
        self.out_channels = out_channels
        self.lin_kv = Dense(in_channels, 2 * out_channels, dtype=dtype, device=device)
        self.lin_edge = Dense(edge_dim, out_channels, dtype=dtype, device=device)
        self.projection = Dense(out_channels, out_channels, dtype=dtype, device=device)
        self.node_dst_mlp = DstMLP(out_channels, hidden_dim, activation, dtype=dtype, device=device)

    def _conv_args(self, query: torch.Tensor) -> tuple:
        """The query as (B, N, H, D) and the projections the convs take."""
        b, n, _ = query.shape
        return (query.reshape(b, n, self.num_heads, self.head_dim), self.lin_kv.weight, self.lin_kv.bias,
                self.lin_edge.weight, self.lin_edge.bias)

    def _finish(self, out, x_r, x_skip):
        """projection(out + x_r) + x_skip -> dst MLP residual."""
        b, n = out.shape[:2]
        out = self.projection(out.reshape(b, n, self.out_channels) + x_r) + x_skip
        return self.node_dst_mlp(out) + out


class GraphTransformerProcessorBlock(_GraphTransformerBase):
    """Per-edge attention block on a homogeneous graph. ``halo``: (mesh, the
    rank's HaloShard) under a model-sharded mesh (``x`` the rank's rows, the
    CSR and edges the rank's), and the attention runs under halo exchange."""

    def __init__(self, in_channels: int, hidden_dim: int, out_channels: int, edge_dim: int, *,
                 num_heads: int = 16, activation: str = "GELU",
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(in_channels, hidden_dim, out_channels, edge_dim, num_heads, activation, dtype, device)
        self.layer_norm1 = AutocastLayerNorm(in_channels, device=device)
        self.lin_qr = Dense(in_channels, 2 * out_channels, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, edge_attr: torch.Tensor, rowptr: torch.Tensor,
                src: torch.Tensor, csr_t: CSRTranspose, halo=None) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C)."""
        xn = self.layer_norm1(x)
        query, x_r = self.lin_qr(xn).chunk(2, dim=-1)
        q, w_kv, b_kv, w_edge, b_edge = self._conv_args(query)
        if halo is None:
            out = graph_transformer_conv(q, xn, w_kv, b_kv, edge_attr, w_edge, b_edge, rowptr, src, csr_t)
        else:
            out = halo_graph_transformer_conv(*halo, q, xn, w_kv, b_kv, edge_attr, w_edge, b_edge)
        return self._finish(out, x_r, x)


class GraphTransformerMapperBlock(_GraphTransformerBase):
    """Per-edge attention block on a bipartite graph (source nodes are not
    updated, as in the GraphTransformer mappers). ``src_transform`` (the
    forward mapper's source embedding) runs on the source rows before the
    source LayerNorm. ``shard``: (mesh, the rank's MapperShard) under a
    model-sharded mesh: ``x_src`` and ``x_dst`` are the rank's rows, the
    edges the rank's, and the attention gathers the narrow source rows its
    edges read before ``src_transform``."""

    def __init__(self, in_channels: int, hidden_dim: int, out_channels: int, edge_dim: int, *,
                 num_heads: int = 16, activation: str = "GELU",
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(in_channels, hidden_dim, out_channels, edge_dim, num_heads, activation, dtype, device)
        self.layer_norm1 = AutocastLayerNorm(in_channels, device=device)  # source side
        self.layer_norm2 = AutocastLayerNorm(in_channels, device=device)  # destination side
        self.lin_qs = Dense(in_channels, 2 * out_channels, dtype=dtype, device=device)  # [q | r]

    def forward(self, x: tuple[torch.Tensor, torch.Tensor], edge_attr: torch.Tensor,
                rowptr: torch.Tensor, src: torch.Tensor, csr_t: CSRTranspose, shard=None,
                src_transform=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(x_src (B, Ns, F), x_dst (B, Nd, C)) -> (x_src, new x_dst)."""
        x_src, x_dst = x
        query, x_r = self.lin_qs(self.layer_norm2(x_dst)).chunk(2, dim=-1)

        def feats(rows: torch.Tensor) -> torch.Tensor:
            return self.layer_norm1(rows if src_transform is None else src_transform(rows))

        q, w_kv, b_kv, w_edge, b_edge = self._conv_args(query)
        if shard is None:
            out = graph_transformer_conv(q, feats(x_src), w_kv, b_kv, edge_attr, w_edge, b_edge, rowptr, src, csr_t)
        else:
            out = sharded_mapper_edge_attention(*shard, q, x_src, w_kv, b_kv, edge_attr, w_edge, b_edge,
                                                src_transform=feats)
        return x_src, self._finish(out, x_r, x_dst)
