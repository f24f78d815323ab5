"""GraphTransformer convolution: per-edge multi-head attention.

Counterpart of ``anemoi_models_tpu/layers/conv.py:graph_transformer_conv``:
``alpha = softmax_dst(q_i . (k_j + e) / sqrt(d))``, message ``(v_j + e) alpha``.
One function carries the processor and both mappers. It projects k/v once per
source node (:class:`KVProj`), computes the partials over the CSR edge list
(:class:`EdgeAttnCSR`) and normalises them. Both autograd Functions have
hand-written kernels on CUDA tensors (forward and backward) and the plain
versions on CPU tensors; autograd carries the edge gradient ``da`` on to the
trainable edge attributes and ``dw_aug`` on to ``lin_edge``.

The JAX package's dense bucketed path, slot plan and outlier split are TPU
layouts of this same function and have no counterpart here.
"""

from __future__ import annotations

import torch

from anemoi_models_tpu_torch.ops.edge_attention import (
    AttentionPartials,
    CSRTranspose,
    EdgeAttnCSR,
    KVProj,
    finalize_partials,
)

__all__ = ["graph_transformer_conv"]


def graph_transformer_conv(
    query: torch.Tensor,  # (B, Nd, H, D)
    feats: torch.Tensor,  # (B, Ns, F) source features (post-LN)
    w_kv: torch.Tensor,  # (2C, F) [k | v] projection, torch Linear layout
    b_kv: torch.Tensor,  # (2C,)
    edge_attr: torch.Tensor,  # (E, A) edge attributes (static + trainable)
    w_edge: torch.Tensor,  # (C, A) edge projection, torch Linear layout
    b_edge: torch.Tensor,  # (C,)
    rowptr: torch.Tensor,  # (Nd + 1,) int32 CSR offsets by destination
    src: torch.Tensor,  # (E,) int32 source id per edge
    csr_t: CSRTranspose,  # the edge list by source, for the backward
) -> torch.Tensor:
    """Attention output (B, Nd, H, D) in the query's dtype."""
    b, nd, h, d = query.shape
    dt = query.dtype
    kv = KVProj.apply(
        feats.reshape(-1, feats.shape[-1]).to(dt).contiguous(), w_kv.to(dt).contiguous(), b_kv.float()
    )
    a = torch.cat([edge_attr.to(dt), edge_attr.new_ones(edge_attr.shape[0], 1, dtype=dt)], dim=-1)
    w_aug = torch.cat([w_edge.t(), b_edge[None]], dim=0).to(dt).contiguous()
    num, den, m = EdgeAttnCSR.apply(
        query.reshape(b * nd, h * d).contiguous(), kv, a, w_aug, rowptr, src, h, csr_t
    )
    return finalize_partials(AttentionPartials(num, den, m), dt).view(b, nd, h, d)
