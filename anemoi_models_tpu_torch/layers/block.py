"""GraphTransformer blocks for the processor and the mappers.

Counterparts of ``GraphTransformerProcessorBlock`` and
``GraphTransformerMapperBlock`` in ``anemoi_models_tpu/layers/block.py``, in
the wide form: k/v are projected per source node, then attended
(:func:`~anemoi_models_tpu_torch.layers.conv.graph_transformer_conv`). The JAX
commuted form computes the same function; it drops the k-side bias, which is
softmax-invariant, and differs only in rounding.

The processor's fused ``lin_qkvs`` (columns ``[q | k | v | r]``) is held as
two layers here, ``lin_qr`` and ``lin_kv``, so that the ``[k|v]`` weight is
one contiguous block for the projection kernel (``weights.py`` splits it).
"""

from __future__ import annotations

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.conv import graph_transformer_conv
from anemoi_models_tpu_torch.layers.utils import AutocastLayerNorm, Dense, get_activation

__all__ = ["GraphTransformerProcessorBlock", "GraphTransformerMapperBlock"]


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

    def _attend(self, query, x_r, feats, x_skip, edge_attr, rowptr, src):
        """conv -> projection(out + x_r) + x_skip -> dst MLP residual."""
        b, n, _ = query.shape
        out = graph_transformer_conv(
            query.reshape(b, n, self.num_heads, self.head_dim), feats,
            self.lin_kv.weight, self.lin_kv.bias, edge_attr,
            self.lin_edge.weight, self.lin_edge.bias, rowptr, src,
        )
        out = self.projection(out.reshape(b, n, self.out_channels) + x_r) + x_skip
        return self.node_dst_mlp(out) + out


class GraphTransformerProcessorBlock(_GraphTransformerBase):
    """Per-edge attention block on a homogeneous graph."""

    def __init__(self, in_channels: int, hidden_dim: int, out_channels: int, edge_dim: int, *,
                 num_heads: int = 16, activation: str = "GELU",
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(in_channels, hidden_dim, out_channels, edge_dim, num_heads, activation, dtype, device)
        self.layer_norm1 = AutocastLayerNorm(in_channels, device=device)
        self.lin_qr = Dense(in_channels, 2 * out_channels, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, edge_attr: torch.Tensor, rowptr: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C)."""
        xn = self.layer_norm1(x)
        query, x_r = self.lin_qr(xn).chunk(2, dim=-1)
        return self._attend(query, x_r, xn, x, edge_attr, rowptr, src)


class GraphTransformerMapperBlock(_GraphTransformerBase):
    """Per-edge attention block on a bipartite graph (source nodes are not
    updated, as in the GraphTransformer mappers)."""

    def __init__(self, in_channels: int, hidden_dim: int, out_channels: int, edge_dim: int, *,
                 num_heads: int = 16, activation: str = "GELU",
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(in_channels, hidden_dim, out_channels, edge_dim, num_heads, activation, dtype, device)
        self.layer_norm1 = AutocastLayerNorm(in_channels, device=device)  # source side
        self.layer_norm2 = AutocastLayerNorm(in_channels, device=device)  # destination side
        self.lin_qs = Dense(in_channels, 2 * out_channels, dtype=dtype, device=device)  # [q | r]

    def forward(self, x: tuple[torch.Tensor, torch.Tensor], edge_attr: torch.Tensor,
                rowptr: torch.Tensor, src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(x_src (B, Ns, C), x_dst (B, Nd, C)) -> (x_src, new x_dst)."""
        x_src, x_dst = x
        query, x_r = self.lin_qs(self.layer_norm2(x_dst)).chunk(2, dim=-1)
        out = self._attend(query, x_r, self.layer_norm1(x_src), x_dst, edge_attr, rowptr, src)
        return x_src, out
