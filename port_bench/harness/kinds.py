"""Device kernels grouped by what they do, by a part of their name (the
first group that matches; anything else is "other elementwise"). A copy of
the table the port's bring-up smoke run sorts its profiles with."""

from __future__ import annotations

KINDS = [
    ("edge_attn_csr_bwd", ("bwd_dst_kernel", "bwd_src_kernel", "dw_parts_kernel", "dw_reduce_kernel")),
    ("gnn_conv_bwd fused chain", ("gnn_bwd_chain_kernel",)),
    ("gnn_conv_bwd products", ("ZPairs", "DaPairs", "mn_gemm_kernel", "gnn_bwd_f32_kernel")),
    ("gnn_conv_bwd LayerNorm, transposes, sums",
     ("gnn_ln_bwd", "gnn_transpose_kernel", "gnn_dst_sum_kernel", "gnn_src_sum_kernel", "gnn_sum_segs")),
    ("flash_attention_bwd", ("flash_bwd_",)),
    ("gnn_conv layered row table", ("gnn_rows_kernel",)),
    ("gnn_conv layered Dense 0", ("gnn_dense0_tag",)),
    ("gnn_conv layered hidden Dense", ("gnn_dense_tag",)),
    ("gnn_conv layered last Dense", ("gnn_dense_last_tag",)),
    ("gnn_conv layered LayerNorm pass", ("gnn_ln_kernel",)),
    ("gnn_conv pre-pass", ("gnn_prepass_tag",)),
    ("gnn_conv fused message", ("gnn_msg_",)),
    ("gnn_conv sum", ("gnn_agg_kernel",)),
    ("flash_attention", ("flash_attn_",)),
    ("kv_proj", ("kv_proj_tag",)),
    ("edge_attn_csr", ("edge_attn_csr_kernel",)),
    ("optimizer (multi-tensor)", ("multi_tensor", "lpnorm")),
    ("LayerNorm forward + backward", ("layer_norm", "GammaBeta")),
    ("GEMM (cuBLAS, CUTLASS)", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("copies and dtype casts", ("copy", "Memcpy", "Memset")),
    ("reductions", ("reduce_kernel",)),
    ("GELU forward + backward", ("Gelu",)),
]


def kind_of(name: str) -> str:
    return next((kind for kind, marks in KINDS if any(m in name for m in marks)), "other elementwise")
