"""GraphTransformer mappers: grid <-> mesh cross attention.

Counterparts of ``GraphTransformerForwardMapper`` (data -> hidden encoder) and
``GraphTransformerBackwardMapper`` (hidden -> data decoder) in
``anemoi_models_tpu/layers/mapper.py``, in the wide form: the forward mapper
embeds its source rows (``emb_nodes_src``) before the block. Under the JAX
commuted dataflow the same parameter sits at ``encoder/proc/emb_nodes_src``;
``weights.py`` accepts both places.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.block import GraphTransformerMapperBlock
from anemoi_models_tpu_torch.layers.processor import register_edge_buffers
from anemoi_models_tpu_torch.layers.utils import AutocastLayerNorm, Dense

__all__ = ["GraphTransformerForwardMapper", "GraphTransformerBackwardMapper"]


class _GraphTransformerBaseMapper(nn.Module):
    def __init__(
        self,
        *,
        in_channels_src: int = 0,
        in_channels_dst: int = 0,
        hidden_dim: int = 128,
        trainable_size: int = 8,
        num_heads: int = 16,
        mlp_hidden_ratio: int = 4,
        activation: str = "GELU",
        sub_graph=None,
        sub_graph_edge_attributes: Optional[list[str]] = ("edge_length", "edge_dirs"),
        src_grid_size: int = 0,
        dst_grid_size: int = 0,
        graph_impl: str = "dense",
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
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

    def _run(self, x_src: torch.Tensor, x_dst: torch.Tensor) -> torch.Tensor:
        edge_attr = self.trainable(self.edge_attr.to(self.dtype))
        _, x_dst = self.proc((x_src, self.emb_nodes_dst(x_dst)), edge_attr, self.rowptr, self.src)
        return x_dst


class GraphTransformerForwardMapper(_GraphTransformerBaseMapper):
    """data -> hidden. Returns ``(x_src_in, x_dst_hidden)``: the un-embedded
    source passes through for the decoder's skip path."""

    def __init__(self, *, in_channels_src: int, hidden_dim: int = 128, device=None, **kwargs) -> None:
        super().__init__(in_channels_src=in_channels_src, hidden_dim=hidden_dim, device=device, **kwargs)
        self.emb_nodes_src = Dense(in_channels_src, hidden_dim, dtype=self.dtype, device=device)

    def forward(self, x: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        x_src_in, x_dst_in = x
        return x_src_in, self._run(self.emb_nodes_src(x_src_in), x_dst_in)


class GraphTransformerBackwardMapper(_GraphTransformerBaseMapper):
    """hidden -> data, then ``node_data_extractor`` (LN + Dense) to
    ``out_channels_dst``."""

    def __init__(self, *, out_channels_dst: int, hidden_dim: int = 128, device=None, **kwargs) -> None:
        super().__init__(hidden_dim=hidden_dim, device=device, **kwargs)
        self.node_data_extractor_norm = AutocastLayerNorm(hidden_dim, device=device)
        self.node_data_extractor = Dense(hidden_dim, out_channels_dst, dtype=self.dtype, device=device)

    def forward(self, x: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        x_src, x_dst_in = x
        x_dst = self._run(x_src, x_dst_in)
        return self.node_data_extractor(self.node_data_extractor_norm(x_dst))
