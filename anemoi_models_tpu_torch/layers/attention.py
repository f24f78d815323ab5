"""Multi-head self-attention with a sliding window.

Counterpart of ``anemoi_models_tpu/layers/attention.py:MultiHeadSelfAttention``:
a fused ``lin_qkv`` (no bias), split into q, k, v in the (B, H, N, D) layout,
attention, and ``projection`` (with bias). The q, k and v handed to the
attention are strided views of ``lin_qkv``'s output, which the kernel reads
in place; its output is laid out (B, N, H, D), so the merge of the heads is
free.

Under a mesh whose ``model`` axis splits the sequence (the hidden mesh's
rows), ``attention_impl="halo"`` and, for a non-causal windowed attention,
``"auto"`` take :func:`~anemoi_models_tpu_torch.ops.ring_attention.halo_window_attention`
(a +-window halo of k and v from the neighbouring ranks), as the JAX layer
selects it. Any other attention under such a mesh (a causal mask, no
window, or another ``attention_impl``) takes
:func:`~anemoi_models_tpu_torch.ops.ring_attention.gathered_attention` (k and
v of every rank gathered, the rank's queries against the whole sequence):
the function the JAX layer computes after resharding over heads. Both run
the flash kernel on the rank's rows. ``seq_len`` is the whole sequence's
length, which a rank holding its rows alone cannot see.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.utils import Dense
from anemoi_models_tpu_torch.ops.attention import dot_product_attention
from anemoi_models_tpu_torch.ops.flash_attention import fold_key
from anemoi_models_tpu_torch.ops.ring_attention import gathered_attention, halo_window_attention
from anemoi_models_tpu_torch.parallel.api import model_sharded

__all__ = ["MultiHeadSelfAttention"]


class MultiHeadSelfAttention(nn.Module):
    """MHSA over (batch, seq, channels) tensors. ``layer_index`` is folded
    into the dropout key, so each layer of a processor draws its own mask."""

    def __init__(self, num_heads: int, embed_dim: int, *, bias: bool = False, is_causal: bool = False,
                 window_size: Optional[int] = None, dropout_p: float = 0.0, attention_impl: str = "auto",
                 layer_index: int = 0, seq_len: int = 0, dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"Head split impossible: embed_dim {embed_dim} is not a multiple of ({num_heads})")
        if attention_impl == "halo" and is_causal:
            raise NotImplementedError("halo attention has no causal mask; use attention_impl='chunked'")
        if attention_impl == "halo" and window_size is None:
            raise ValueError("halo attention requires a window_size")
        self.seq_len = seq_len
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.is_causal = is_causal
        self.window_size = window_size
        self.dropout_p = dropout_p
        self.attention_impl = attention_impl
        self.layer_index = layer_index
        self.lin_qkv = Dense(embed_dim, 3 * embed_dim, bias=bias, dtype=dtype, device=device)
        self.projection = Dense(embed_dim, embed_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, deterministic: bool = True, dropout_key: Optional[int] = None) -> torch.Tensor:
        batch, seq, _ = x.shape
        head_dim = self.embed_dim // self.num_heads
        qkv = self.lin_qkv(x).view(batch, seq, 3, self.num_heads, head_dim)
        query, key, value = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, N, D) views
        rate = 0.0 if deterministic else self.dropout_p
        if rate > 0.0 and dropout_key is None:
            raise ValueError("attention dropout (deterministic=False) needs a dropout_key")
        key_l = fold_key(dropout_key, self.layer_index) if rate > 0.0 else None
        mesh = model_sharded()
        if mesh is None and self.attention_impl == "halo":
            raise ValueError("halo attention requires an active mesh with a model axis > 1")
        if mesh is None:
            out = dot_product_attention(
                query, key, value, window_size=self.window_size, is_causal=self.is_causal,
                impl=self.attention_impl, dropout_rate=rate, dropout_key=key_l,
            )
        else:
            if self.seq_len <= 0:
                raise ValueError("attention over a sequence split by the mesh needs the whole length (seq_len)")
            halo = self.attention_impl == "halo" or (
                self.attention_impl == "auto" and self.window_size is not None and not self.is_causal)
            if halo:
                out = halo_window_attention(query, key, value, window_size=self.window_size, seq_len=self.seq_len,
                                            mesh=mesh, dropout_rate=rate, dropout_key=key_l)
            else:
                out = gathered_attention(query, key, value, window_size=self.window_size, is_causal=self.is_causal,
                                         seq_len=self.seq_len, mesh=mesh, dropout_rate=rate, dropout_key=key_l)
        return self.projection(out.transpose(1, 2).reshape(batch, seq, self.embed_dim))
