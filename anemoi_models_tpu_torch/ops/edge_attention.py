"""Edge attention over a CSR edge list: the Hopper kernels and their plain
PyTorch versions, plus the merge-form partials contract.

Replaces ``anemoi_models_tpu/ops/pallas/edge_attention.py:_feats_kernel``
(with its plain twin ``ops/slot_attention.py:slot_attention_feats_partials``).
The TPU kernel's one-hot gather, slab window and outlier split exist because
Mosaic cannot gather in VMEM; Hopper loads rows by index, so the port runs
straight off the destination-sorted edge list in two kernels
(``csrc/edge_attention.cu``):

- :func:`kv_proj` projects the narrow source features to ``[k|v]`` once per
  node (fp32 accumulation, rounded to the compute dtype, the rounding point of
  ``_feats_kernel``). Bound by FLOPs; a per-edge projection inside the
  attention kernel would cost about mean-degree times as many.
- :func:`edge_attn_csr` computes the partials ``(num, den, m)`` with one CTA
  per (batch, destination). Bound by the gathered row reads, which the 50 MB
  L2 holds for the most part at O96 (the processor's kv is 10.5 MB in bf16).

Each wrapper takes the plain version for a tensor on the CPU, launches its
kernel for a CUDA tensor or raises, and counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from anemoi_models_tpu_torch.ops.segment import segment_max, segment_sum

__all__ = [
    "AttentionPartials",
    "LAUNCHES",
    "csr_from_edge_index",
    "edge_attn_csr",
    "edge_attn_csr_plain",
    "finalize_partials",
    "kv_proj",
    "kv_proj_plain",
    "merge_partials",
]

_NEG = -1e30
_MAX_A2 = 16  # kMaxA2 in csrc/edge_attention.cu
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches per wrapper; a CPU call runs the plain version and adds nothing
LAUNCHES: dict[str, int] = {"kv_proj": 0, "edge_attn_csr": 0}


class AttentionPartials(NamedTuple):
    num: torch.Tensor  # (N, H, D) fp32: sum exp(logit - m) (v + e)
    den: torch.Tensor  # (N, H) fp32: sum exp(logit - m)
    m: torch.Tensor  # (N, H) fp32: max live logit, -1e30 where there is none


def merge_partials(p1: AttentionPartials, p2: AttentionPartials) -> AttentionPartials:
    """Exact combination of two disjoint-edge-set softmax partials."""
    m = torch.maximum(p1.m, p2.m)
    f1 = torch.where(p1.den > 0, torch.exp(p1.m - m), 0.0)
    f2 = torch.where(p2.den > 0, torch.exp(p2.m - m), 0.0)
    return AttentionPartials(
        num=p1.num * f1[..., None] + p2.num * f2[..., None],
        den=p1.den * f1 + p2.den * f2,
        m=m,
    )


def finalize_partials(p: AttentionPartials, out_dtype: torch.dtype) -> torch.Tensor:
    """(num, den, m) -> attention output (N, H, D)."""
    return (p.num / p.den.clamp_min(1e-16)[..., None]).to(out_dtype)


def csr_from_edge_index(
    edge_index: np.ndarray, num_src: int, num_dst: int
) -> tuple[np.ndarray, np.ndarray]:
    """(rowptr (num_dst + 1,), src (E,)) int32 from a destination-sorted
    (2, E) edge index, as the graph builders store it. The kernel reads rows
    by these ids unchecked, so they are validated here, once, on the host."""
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    if dst.size and (np.any(np.diff(dst) < 0) or dst.min() < 0 or dst.max() >= num_dst):
        raise ValueError("edge_index must be sorted by destination, with ids below num_dst")
    if src.size and (src.min() < 0 or src.max() >= num_src):
        raise ValueError(f"source ids outside [0, {num_src})")
    if dst.size >= 2**31:
        raise ValueError(f"{dst.size} edges exceed the kernels' int32 offsets")
    rowptr = np.zeros(num_dst + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(dst, minlength=num_dst))
    return rowptr.astype(np.int32), src.astype(np.int32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def kv_proj_plain(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) . (N, K)^T + b in fp32, rounded to f's dtype."""
    return (f.float() @ w.float().t() + b.float()).to(f.dtype)


def edge_attn_csr_plain(
    q: torch.Tensor,  # (B*Nd, C)
    kv: torch.Tensor,  # (B*Ns, 2C) [k | v]
    rowptr: torch.Tensor,  # (Nd + 1,) int32
    src: torch.Tensor,  # (E,) int32
    a: torch.Tensor,  # (E, A2) edge attributes with a ones column
    w_aug: torch.Tensor,  # (A2, C) edge projection, bias as the last row
    num_heads: int,
) -> AttentionPartials:
    """Partials over the CSR edge list from segment ops, all in fp32."""
    nd = rowptr.numel() - 1
    bnd, c = q.shape
    b = bnd // nd
    ns = kv.shape[0] // b
    h, d = num_heads, c // num_heads
    dst = torch.repeat_interleave(
        torch.arange(nd, device=q.device), rowptr.long().diff()
    )
    src = src.long()
    e = (a.float() @ w_aug.float()).view(-1, h, d)  # (E, H, D)
    kvf = kv.float().view(b, ns, 2, h, d)
    k_j = kvf[:, src, 0] + e
    v_j = kvf[:, src, 1] + e
    q_i = q.float().view(b, nd, h, d)[:, dst]
    logits = (q_i * k_j).sum(-1) / math.sqrt(d)  # (B, E, H)
    m = segment_max(logits, dst, nd).clamp_min(_NEG)  # (B, Nd, H)
    w = torch.exp(logits - m[:, dst])
    den = segment_sum(w, dst, nd)
    num = segment_sum((w[..., None] * v_j).reshape(b, -1, c), dst, nd)
    return AttentionPartials(num.view(bnd, h, d), den.view(bnd, h), m.view(bnd, h))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {device}")
    return False


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _require_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        _require(t.is_contiguous(), f"{name} must be contiguous")


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def kv_proj(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[k|v] = f . w^T + b``: f (M, K) and w (N, K) in the compute dtype
    (fp32 or bf16), b (N,) fp32; returns (M, N) in the compute dtype."""
    if _on_cpu(f, w, b):
        return kv_proj_plain(f, w, b)
    _require(f.dtype in _DTYPES and w.dtype == f.dtype, f"f, w must share fp32|bf16, got {f.dtype}, {w.dtype}")
    _require(b.dtype == torch.float32, f"b must be fp32, got {b.dtype}")
    _require(f.dim() == 2 and w.dim() == 2 and w.shape[1] == f.shape[1], f"bad shapes {f.shape}, {w.shape}")
    _require(b.shape == (w.shape[0],), f"bias shape {tuple(b.shape)} != ({w.shape[0]},)")
    _require_contiguous(f=f, w=w, b=b)
    m, k = f.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=f.dtype, device=f.device)
    if m == 0:
        return out
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    fn = lib.kv_proj_bf16 if f.dtype == torch.bfloat16 else lib.kv_proj_f32
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        rc = fn(f.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream)
    _check_launch(rc, "kv_proj")
    LAUNCHES["kv_proj"] += 1
    return out


def _check_heads(c: int, num_heads: int) -> None:
    _require(num_heads > 0 and c % num_heads == 0, f"C={c} not divisible by {num_heads} heads")
    d = c // num_heads
    v = d // 32 if d > 32 else 1
    _require(
        d in (1, 2, 4, 8, 16, 32, 64, 128) and (c // v) % 32 == 0 and c // v <= 1024,
        f"edge_attn_csr takes head widths 1..128 (powers of two) with C/V a multiple "
        f"of 32 threads; got C={c}, H={num_heads}",
    )


def edge_attn_csr(
    q: torch.Tensor,
    kv: torch.Tensor,
    rowptr: torch.Tensor,
    src: torch.Tensor,
    a: torch.Tensor,
    w_aug: torch.Tensor,
    num_heads: int,
) -> AttentionPartials:
    """Attention partials over a CSR edge list (see :func:`edge_attn_csr_plain`
    for the shapes). q, kv, a and w_aug share the compute dtype (fp32 or
    bf16); num, den and m are fp32."""
    if _on_cpu(q, kv, rowptr, src, a, w_aug):
        return edge_attn_csr_plain(q, kv, rowptr, src, a, w_aug, num_heads)
    dt = q.dtype
    _require(dt in _DTYPES, f"compute dtype must be fp32 or bf16, got {dt}")
    _require(all(t.dtype == dt for t in (kv, a, w_aug)), "q, kv, a, w_aug must share one dtype")
    _require(rowptr.dtype == torch.int32 and src.dtype == torch.int32, "rowptr and src must be int32")
    _require(q.dim() == 2 and kv.dim() == 2 and a.dim() == 2 and w_aug.dim() == 2, "2-D operands expected")
    bnd, c = q.shape
    nd = rowptr.numel() - 1
    _check_heads(c, num_heads)
    _require(nd > 0 and bnd % nd == 0, f"q rows {bnd} not a multiple of {nd} destinations")
    batch = bnd // nd
    _require(kv.shape[1] == 2 * c and kv.shape[0] % batch == 0, f"kv shape {tuple(kv.shape)} for C={c}, B={batch}")
    a2 = a.shape[1]
    _require(a.shape[0] == src.numel() and 0 < a2 <= _MAX_A2, f"a shape {tuple(a.shape)} for {src.numel()} edges")
    _require(w_aug.shape == (a2, c), f"w_aug shape {tuple(w_aug.shape)} != ({a2}, {c})")
    _require_contiguous(q=q, kv=kv, rowptr=rowptr, src=src, a=a, w_aug=w_aug)
    num = torch.empty((bnd, c), dtype=torch.float32, device=q.device)
    den = torch.empty((bnd, num_heads), dtype=torch.float32, device=q.device)
    m = torch.empty((bnd, num_heads), dtype=torch.float32, device=q.device)
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    fn = lib.edge_attn_csr_bf16 if dt == torch.bfloat16 else lib.edge_attn_csr_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), kv.data_ptr(), rowptr.data_ptr(), src.data_ptr(),
            a.data_ptr(), w_aug.data_ptr(), num.data_ptr(), den.data_ptr(), m.data_ptr(),
            batch, nd, kv.shape[0] // batch, c, num_heads, a2, stream,
        )
    _check_launch(rc, "edge_attn_csr")
    LAUNCHES["edge_attn_csr"] += 1
    return AttentionPartials(num.view(bnd, num_heads, c // num_heads), den, m)
