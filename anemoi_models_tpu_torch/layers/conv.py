"""Graph convolutions over a CSR edge list.

Counterparts of ``anemoi_models_tpu/layers/conv.py``:

- :class:`GraphConv`: edge-MLP message ``MLP(cat[x_i, x_j, e]) + e`` and its
  sum over each destination's edges, for a self-graph and a bipartite
  ``(x_src, x_dst)`` pair alike, through :class:`GNNConv` (the hand-written
  kernel on CUDA tensors, the plain version on CPU tensors). The JAX package
  runs its bipartite mappers on the dense gather path only because its slot
  kernel needs a self-graph; the function is the same.
- :func:`graph_transformer_conv`:
  ``alpha = softmax_dst(q_i . (k_j + e) / sqrt(d))``, message
  ``(v_j + e) alpha``. One function carries the processor and both mappers.
  It projects k/v once per source node (:func:`project_kv`, :class:`KVProj`),
  then computes the partials over the CSR edge list and normalises them
  (:func:`attend_kv`, :class:`EdgeAttnCSR`); the halo processor exchanges
  the per-node ``[k|v]`` between the two. Both autograd Functions have hand-written kernels on CUDA tensors
  (forward and backward) and the plain versions on CPU tensors; autograd
  carries the edge gradient ``da`` on to the trainable edge attributes and
  ``dw_aug`` on to ``lin_edge``.

The JAX package's dense bucketed path, slot plan and outlier split are TPU
layouts of this same function and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.mlp import MLP
from anemoi_models_tpu_torch.ops.edge_attention import (
    AttentionPartials,
    CSRTranspose,
    EdgeAttnCSR,
    KVProj,
    finalize_partials,
)
from anemoi_models_tpu_torch.ops.gnn_conv import GNNConv

__all__ = ["GraphConv", "attend_kv", "graph_transformer_conv", "project_kv"]


class GraphConv(nn.Module):
    """Edge-MLP message passing with sum aggregation. The edge MLP
    (``mlp``: 3C -> C -> ... -> C, LayerNorm) is the flax ``MLP_0``."""

    def __init__(self, in_channels: int, out_channels: int, *, mlp_extra_layers: int = 0,
                 activation: str = "SiLU", dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.activation = activation
        self.mlp = MLP(3 * in_channels, out_channels, out_channels, n_extra_layers=mlp_extra_layers,
                       activation=activation, dtype=dtype, device=device)

    def forward(self, x: Union[torch.Tensor, tuple[torch.Tensor, torch.Tensor]], edge_attr: torch.Tensor,
                rowptr: torch.Tensor, src: torch.Tensor,
                csr_t: Optional[CSRTranspose] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, N, C) or (x_src (B, Ns, C), x_dst (B, Nd, C)); edge_attr
        (B, E, C) in CSR order -> (aggregated (B, Nd, C), edges_new (B, E, C)),
        both in edge_attr's dtype. ``csr_t``: the edge list by source, for
        the backward."""
        dt = edge_attr.dtype
        x_src, x_dst = (t.to(dt).contiguous() for t in (x if isinstance(x, tuple) else (x, x)))
        lead = (csr_t,) if csr_t is not None else ()
        agg, msg = GNNConv.apply(x_dst, x_src, edge_attr.contiguous(), rowptr, src, *lead, self.activation,
                                 *self.params())
        return agg.to(dt), msg

    def params(self) -> list[torch.Tensor]:
        """The edge MLP as :class:`GNNConv` takes it: each Dense's weight and
        bias, then the LayerNorm's weight and bias."""
        norm = self.mlp.AutocastLayerNorm_0
        return [t for layer in self.mlp.dense() for t in (layer.weight, layer.bias)] + [norm.weight, norm.bias]


def project_kv(feats: torch.Tensor, w_kv: torch.Tensor, b_kv: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(B, Ns, F) source features -> (B * Ns, 2C) per-node ``[k|v]`` in ``dt``
    through :class:`KVProj`."""
    return KVProj.apply(feats.reshape(-1, feats.shape[-1]).to(dt).contiguous(), w_kv.to(dt).contiguous(),
                        b_kv.float())


def attend_kv(
    query: torch.Tensor,  # (B, Nd, H, D)
    kv: torch.Tensor,  # (B * Ns, 2C) per-node [k | v]
    edge_attr: torch.Tensor,  # (E, A) edge attributes (static + trainable)
    w_edge: torch.Tensor,  # (C, A) edge projection, torch Linear layout
    b_edge: torch.Tensor,  # (C,)
    rowptr: torch.Tensor,  # (Nd + 1,) int32 CSR offsets by destination
    src: torch.Tensor,  # (E,) int32 source id per edge
    csr_t: CSRTranspose,  # the edge list by source, for the backward
) -> torch.Tensor:
    """Attention output (B, Nd, H, D) in the query's dtype from the
    per-node ``[k|v]`` through :class:`EdgeAttnCSR`."""
    b, nd, h, d = query.shape
    dt = query.dtype
    a = torch.cat([edge_attr.to(dt), edge_attr.new_ones(edge_attr.shape[0], 1, dtype=dt)], dim=-1)
    w_aug = torch.cat([w_edge.t(), b_edge[None]], dim=0).to(dt).contiguous()
    num, den, m = EdgeAttnCSR.apply(
        query.reshape(b * nd, h * d).contiguous(), kv.to(dt).contiguous(), a, w_aug, rowptr, src, h, csr_t
    )
    return finalize_partials(AttentionPartials(num, den, m), dt).view(b, nd, h, d)


def graph_transformer_conv(
    query: torch.Tensor,  # (B, Nd, H, D)
    feats: torch.Tensor,  # (B, Ns, F) source features (post-LN)
    w_kv: torch.Tensor,  # (2C, F) [k | v] projection, torch Linear layout
    b_kv: torch.Tensor,  # (2C,)
    edge_attr: torch.Tensor,
    w_edge: torch.Tensor,
    b_edge: torch.Tensor,
    rowptr: torch.Tensor,
    src: torch.Tensor,
    csr_t: CSRTranspose,
) -> torch.Tensor:
    """:func:`project_kv` of the source features, then :func:`attend_kv`:
    the attention output (B, Nd, H, D) in the query's dtype."""
    kv = project_kv(feats, w_kv, b_kv, query.dtype)
    return attend_kv(query, kv, edge_attr, w_edge, b_edge, rowptr, src, csr_t)
