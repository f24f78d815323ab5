"""Band-masked (sliding-window) attention: the Hopper kernel, its plain
PyTorch version and the autograd Function.

Replaces ``anemoi_models_tpu/ops/pallas/flash_attention.py:_flash_kernel``
(forward) and keeps the JAX package's backward: the gradient recomputes
through the plain blockwise version, as ``flash_attention.py:_bwd``
recomputes through ``blockwise_attention``. The TPU kernel has no backward
kernel, so the port has none either.

- :func:`blockwise_attention` is the plain version: a q-block loop with
  O(N (blk + 2w)) live memory, fp32 logits and softmax, masking at -1e30,
  ``|i - j| <= w`` and an optional causal mask.
- :func:`flash_attention` takes it for CPU tensors and launches
  ``csrc/flash_attention.cu`` for CUDA tensors (or raises), counting its
  launches in :data:`LAUNCHES`.
- :class:`FlashAttention` is the Function the attention layer runs through.

Shapes: q, k, v are (batch, heads, seq, head_dim); ``window_size`` is the
half-width w, query i attends keys j with ``|i - j| <= w``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from anemoi_models_tpu_torch.ops.edge_attention import _check_launch, _on_cpu, _require

__all__ = ["FlashAttention", "LAUNCHES", "blockwise_attention", "flash_attention", "live_pairs"]

_NEG = -1e30
_HEAD_DIMS = (16, 32, 64, 128)  # head widths csrc/flash_attention.cu is built for
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches; a CPU call runs the plain version and adds nothing
LAUNCHES: dict[str, int] = {"flash_attention": 0}


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: Optional[int] = None,
    is_causal: bool = False,
    block_size: int = 512,
) -> torch.Tensor:
    """Windowed attention over q-blocks, fp32 logits and softmax; the
    weights are rounded to v's dtype before the product with v, and the
    output is in q's dtype."""
    b, h, n, d = q.shape
    blk = min(block_size, n)
    scale = 1.0 / math.sqrt(d)
    kwidth = n if window_size is None else min(blk + 2 * window_size, n)
    blocks = []
    for q0 in range(0, n, blk):
        q1 = min(q0 + blk, n)
        kstart = 0 if window_size is None else min(max(q0 - window_size, 0), n - kwidth)
        ks = k[:, :, kstart:kstart + kwidth].float()
        vs = v[:, :, kstart:kstart + kwidth]
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, q0:q1].float(), ks) * scale
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(kstart, kstart + kwidth, device=q.device)[None, :]
        mask = torch.ones(q1 - q0, kwidth, dtype=torch.bool, device=q.device)
        if window_size is not None:
            mask &= (qpos - kpos).abs() <= window_size
        if is_causal:
            mask &= qpos >= kpos
        w = torch.softmax(s.masked_fill(~mask, _NEG), dim=-1)
        blocks.append(torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(), vs.float()))
    return torch.cat(blocks, dim=2).to(q.dtype)


def live_pairs(n: int, window_size: Optional[int], is_causal: bool) -> int:
    """(query, key) pairs inside the mask: the work the attention needs."""
    i = torch.arange(n, dtype=torch.int64)
    lo = torch.zeros_like(i) if window_size is None else (i - window_size).clamp_min(0)
    hi = torch.full_like(i, n - 1) if window_size is None else (i + window_size).clamp_max(n - 1)
    if is_causal:
        hi = torch.minimum(hi, i)
    return int((hi - lo + 1).sum())


def _strides_ok(t: torch.Tensor) -> bool:
    """Innermost stride 1, every other stride and the address 16-byte
    multiples (the kernel loads rows as 16-byte vectors)."""
    vec = 16 // t.element_size()
    return t.stride(-1) == 1 and all(s % vec == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window_size: Optional[int] = None,
    is_causal: bool = False,
) -> torch.Tensor:
    """Attention output (B, H, N, D) in q's dtype. On the card q, k and v
    share one dtype (fp32 or bf16), shape and strides; rows may be strided
    (a view of a fused projection), channels are contiguous. The output is
    a (B, H, N, D) view of a (B, N, H, D) buffer."""
    if _on_cpu(q, k, v):
        return blockwise_attention(q, k, v, window_size=window_size, is_causal=is_causal)
    _require(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
             f"q, k, v must share fp32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    _require(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape,
             f"q, k, v must share one (B, H, N, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, d = q.shape
    _require(d in _HEAD_DIMS, f"flash_attention takes head widths {_HEAD_DIMS}, got {d}")
    _require(k.stride() == q.stride() and v.stride() == q.stride(), "q, k, v must share strides")
    _require(all(_strides_ok(t) for t in (q, k, v)),
             "q, k, v need contiguous channels and 16-byte aligned rows")
    _require(window_size is None or window_size >= 0, f"window_size must be >= 0, got {window_size}")
    _require(0 < b * h < 65536 and n > 0, f"batch * heads {b * h} or sequence {n} out of range")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    fn = lib.flash_attn_bf16 if q.dtype == torch.bfloat16 else lib.flash_attn_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, d,
            q.stride(0), q.stride(1), q.stride(2), out.stride(0), out.stride(2), out.stride(1),
            -1 if window_size is None else window_size, int(is_causal), 1.0 / math.sqrt(d), stream,
        )
    _check_launch(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out.permute(0, 2, 1, 3)


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` forward; the backward recomputes through
    :func:`blockwise_attention` (default block) and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, window_size: Optional[int], is_causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.window_size, ctx.is_causal = window_size, is_causal
        return flash_attention(q, k, v, window_size, is_causal)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = blockwise_attention(*leaves, window_size=ctx.window_size, is_causal=ctx.is_causal)
        dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None
