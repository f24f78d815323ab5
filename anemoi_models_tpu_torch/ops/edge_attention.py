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
  ``_feats_kernel``): the Hopper GEMM of ``csrc/gemm_sm90.cuh`` (``wgmma``
  fed by TMA in bf16). A per-edge projection inside the attention kernel
  would cost about mean-degree times as many operations.
- :func:`edge_attn_csr` computes the partials ``(num, den, m)`` with a warp
  per (destination, head group) on a persistent grid, its edges' k/v rows
  several at a time in flight. The rows come from the 50 MB L2 for the most
  part at O96 (the processor's kv is 10.5 MB in bf16); the per-edge
  instructions bound it.

Both kernels share one lane layout (:func:`_lane_layout`): a warp works on a
group of whole heads of at most 256 channels, or on one head of up to 1024
(16 or 32 channels a lane), a head on a power of two of lanes (padded where
the head width is not a power of two), and every width the forward takes
also trains. A head width that no layout takes (one off a multiple of 8,
or above 256 off a multiple of 16 or 32) is padded with zero channels by
the wrappers (:func:`_kernel_head`): zero q, k and w_aug columns add nothing
to the logit, zero v columns are sliced off num, and the scale stays
1/sqrt(D) of the true width. The backward (``csrc/edge_attention_bwd.cu``) replaces
``_feats_bwd_kernel``: :func:`edge_attn_csr_bwd` walks the same CSR edge list
for ``dq`` and the edge gradients (a warp per destination, its head groups in
sequence, its edges' k/v rows several at a time in flight) and the
transposed list (:func:`csr_transpose`) for the per-source ``[dk|dv]``,
reading the edge scalars at each edge's position there (the inverse
permutation ``pos``), and sums ``dw_aug`` from per-destination terms in a
fixed split of the destinations (:func:`_bwd_parts`), then in a fixed order;
fixed-order sums only, so every card gives the same bits. Both kernels take
the edge term ``e = a . w_aug`` in its factored form (``csrc/edge_logit.cuh``):
per destination the products ``<q, w_r>_h`` (and ``<g_num, w_r>_h``), per
edge ``A2 H`` terms, so any number of edge attributes runs, streamed in
chunks.
:class:`EdgeAttnCSR` and :class:`KVProj` are the autograd Functions the
conv runs through; the chain through ``w_kv`` is ``torch.matmul``, as the JAX
package leaves it to XLA.

Each wrapper takes the plain version for a tensor on the CPU, launches its
kernel for a CUDA tensor or raises, and counts its launches in
:data:`LAUNCHES`; on either route it records its call's operations with
:func:`~anemoi_models_tpu_torch.ops.cost.record`.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from anemoi_models_tpu_torch.ops import cost
from anemoi_models_tpu_torch.ops.segment import segment_max, segment_sum

__all__ = [
    "AttentionPartials",
    "CSRTranspose",
    "EdgeAttnCSR",
    "KVProj",
    "LAUNCHES",
    "csr_from_edge_index",
    "csr_transpose",
    "edge_attn_csr",
    "edge_attn_csr_bwd",
    "edge_attn_csr_bwd_plain",
    "edge_attn_csr_plain",
    "finalize_partials",
    "kv_proj",
    "kv_proj_plain",
    "merge_partials",
]

_NEG = -1e30
_GROUP_CHANNELS = 256  # the most channels of a group of several heads
_MAX_HEAD = 1024  # the widest head: a group of its own, 32 channels a lane
_GROUP_LANES = 32  # the lanes of a group: a lane never holds two heads
_DW_CTAS = 4 * 132  # the dw pass's CTAs to aim at: four waves of the H100 SXM's SMs
_DW_COLS, _DW_ROWS = 128, 8  # kDwCols, kDwRows in csrc/edge_attention_bwd.cu: a dw CTA's tile of w_aug
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches per wrapper; a CPU call runs the plain version and adds nothing
LAUNCHES: dict[str, int] = {"kv_proj": 0, "edge_attn_csr": 0, "edge_attn_csr_bwd": 0}


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


class CSRTranspose(NamedTuple):
    perm: torch.Tensor  # (E,) int32 edge ids by source, ascending within a source
    colptr: torch.Tensor  # (Ns + 1,) int32 offsets of each source's edges in perm
    dst: torch.Tensor  # (E,) int32 destination of each edge
    pos: torch.Tensor  # (E,) int32 position of each edge in perm: perm[pos[e]] == e


def csr_transpose(rowptr, src, num_src: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The source-sorted view of a destination-sorted CSR edge list, on the
    host, once per edge set: (perm, colptr, dst, pos) int32 (see
    :class:`CSRTranspose`). ``rowptr`` and ``src`` are numpy arrays or CPU
    tensors."""
    rowptr, src = np.asarray(rowptr, dtype=np.int64), np.asarray(src, dtype=np.int64)
    dst = np.repeat(np.arange(rowptr.size - 1), np.diff(rowptr))
    perm = np.argsort(src, kind="stable")
    pos = np.empty_like(perm)
    pos[perm] = np.arange(perm.size)
    colptr = np.zeros(num_src + 1, dtype=np.int64)
    colptr[1:] = np.cumsum(np.bincount(src, minlength=num_src))
    return perm.astype(np.int32), colptr.astype(np.int32), dst.astype(np.int32), pos.astype(np.int32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def kv_proj_plain(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(M, K) . (N, K)^T + b in fp32, rounded once to ``out_dtype`` (f's
    dtype by default)."""
    return (f.float() @ w.float().t() + b.float()).to(out_dtype or f.dtype)


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


def edge_attn_csr_bwd_plain(
    q: torch.Tensor,  # (B*Nd, C)
    kv: torch.Tensor,  # (B*Ns, 2C)
    rowptr: torch.Tensor,  # (Nd + 1,) int32
    src: torch.Tensor,  # (E,) int32
    a: torch.Tensor,  # (E, A2)
    w_aug: torch.Tensor,  # (A2, C)
    m: torch.Tensor,  # (B*Nd, H) fp32, the forward's max logits
    g_num: torch.Tensor,  # (B*Nd, C) fp32 cotangent of num
    g_den: torch.Tensor,  # (B*Nd, H) fp32 cotangent of den
    num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq (B*Nd, C), dkv (B*Ns, 2C), da (E, A2), dw_aug (A2, C)), all fp32,
    from segment ops, as ``_feats_bwd_kernel`` computes them: the weights are
    recomputed in the forward's m-gauge with the exp argument clamped at 0,
    and ``da``, ``dw_aug`` are summed over the batch."""
    nd = rowptr.numel() - 1
    bnd, c = q.shape
    b = bnd // nd
    ns = kv.shape[0] // b
    h, d = num_heads, c // num_heads
    dst = torch.repeat_interleave(torch.arange(nd, device=q.device), rowptr.long().diff())
    src = src.long()
    e = (a.float() @ w_aug.float()).view(-1, h, d)
    kvf = kv.float().view(b, ns, 2, h, d)
    ke = kvf[:, src, 0] + e  # (B, E, H, D)
    ve = kvf[:, src, 1] + e
    q_i = q.float().view(b, nd, h, d)[:, dst]
    gn = g_num.float().view(b, nd, h, d)[:, dst]
    logits = (q_i * ke).sum(-1) / math.sqrt(d)  # (B, E, H)
    w = torch.exp(torch.clamp(logits - m.view(b, nd, h)[:, dst], max=0.0))
    dl = w * ((gn * ve).sum(-1) + g_den.float().view(b, nd, h)[:, dst])
    sdl = (dl / math.sqrt(d))[..., None]
    dq = segment_sum((sdl * ke).reshape(b, -1, c), dst, nd)
    dk_e = (sdl * q_i).reshape(b, -1, c)
    dv_e = (w[..., None] * gn).reshape(b, -1, c)
    dk = torch.zeros(b, ns, c, device=q.device).index_add_(1, src, dk_e)
    dv = torch.zeros(b, ns, c, device=q.device).index_add_(1, src, dv_e)
    de = (dk_e + dv_e).sum(0)  # (E, C): the edge attributes are batch-invariant
    da = de @ w_aug.float().t()
    dw = a.float().t() @ de
    return dq.view(bnd, c), torch.cat([dk, dv], dim=-1).view(b * ns, 2 * c), da, dw


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


def kv_proj(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``[k|v] = f . w^T + b``: f (M, K) and w (N, K) in the compute dtype
    (fp32 or bf16), b (N,) fp32; returns (M, N) in ``out_dtype``: the compute
    dtype (the default) or, for bf16 operands, fp32. The bf16 GEMM reads
    16-byte rows, so a K or N that is not a multiple of 8 is padded with zero
    columns here (zero terms add nothing; the extra outputs are dropped)."""
    cost.record("kv_proj", lambda: cost.kv_proj_flops(f.shape[0], f.shape[-1], w.shape[0]))
    if _on_cpu(f, w, b):
        with cost.plain():
            return kv_proj_plain(f, w, b, out_dtype)
    return _kv_proj_launch(f, w, b, out_dtype)


def _kv_proj_launch(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype | None) -> torch.Tensor:
    out_dtype = out_dtype or f.dtype
    _require(f.dtype in _DTYPES and w.dtype == f.dtype, f"f, w must share fp32|bf16, got {f.dtype}, {w.dtype}")
    _require(out_dtype in (f.dtype, torch.float32), f"out_dtype must be {f.dtype} or fp32, got {out_dtype}")
    _require(b.dtype == torch.float32, f"b must be fp32, got {b.dtype}")
    _require(f.dim() == 2 and w.dim() == 2 and w.shape[1] == f.shape[1], f"bad shapes {f.shape}, {w.shape}")
    _require(b.shape == (w.shape[0],), f"bias shape {tuple(b.shape)} != ({w.shape[0]},)")
    _require_contiguous(f=f, w=w, b=b)
    m, k = f.shape
    n = w.shape[0]
    if f.dtype == torch.bfloat16 and (k % 8 or n % 8):
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        f = torch.nn.functional.pad(f, (0, kp - k))
        w = torch.nn.functional.pad(w, (0, kp - k, 0, np_ - n))
        return _kv_proj_launch(f, w, torch.nn.functional.pad(b, (0, np_ - n)), out_dtype)[:, :n].contiguous()
    if f.dtype == torch.bfloat16:
        _require(f.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0, "kv_proj in bf16 needs 16-byte aligned rows")
    out = torch.empty((m, n), dtype=out_dtype, device=f.device)
    if m == 0:
        return out
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        if f.dtype == torch.bfloat16:
            rc = lib.kv_proj_bf16(f.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                                  int(out_dtype == torch.float32), stream)
        else:
            rc = lib.kv_proj_f32(f.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream)
    _check_launch(rc, "kv_proj")
    LAUNCHES["kv_proj"] += 1
    return out


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _lane_layout(c: int, num_heads: int) -> tuple[int, int, int]:
    """``(vb, lanes, group)``: how both edge-attention kernels lay a row of
    ``c`` channels and ``num_heads`` heads on a warp. A warp works on one
    head group at a time: ``group = D * g`` channels of ``g`` whole heads,
    ``vb`` the smallest power of two with ``32 * vb >= group``, and a head on
    ``lb`` lanes, ``D / vb`` rounded up to a power of two (the shuffle trees
    run over it; where D is not a power of two the lanes past ``D / vb`` pad
    the head, owning no channel), ``lanes = g * lb <= 32`` in all; g is the
    largest divisor of the head count with ``D * g <= 256`` (or g = 1 for a
    head wider than 256: ``vb`` = 16 or 32), ``D * g`` a multiple of 8 (a
    group's slice of a row is whole 16-byte copies in bf16) and the lanes
    fitting. For a power-of-two D no lane pads (``lanes * vb == group``) and
    the forward's threads of ``max(1, D / 32)`` channels (whose sums the
    backward replays) divide a lane's; for the others a lane runs one chain.
    Takes the head widths :func:`_kernel_head` returns."""
    d = c // num_heads

    def fit(g: int) -> tuple[int, int, int] | None:
        group = d * g
        if group > max(_GROUP_CHANNELS, d) or group % 8:
            return None
        vb = 1
        while 32 * vb < group:
            vb *= 2
        lanes = g * _pow2_at_least(d // vb)
        return (vb, lanes, group) if lanes <= _GROUP_LANES and d % vb == 0 else None

    return next(layout for g in range(min(num_heads, _GROUP_LANES), 0, -1)
                if num_heads % g == 0 and (layout := fit(g)) is not None)


def _check_heads(c: int, num_heads: int) -> None:
    _require(num_heads > 0 and c % num_heads == 0, f"C={c} not divisible by {num_heads} heads")
    _require(c // num_heads <= _MAX_HEAD,
             f"edge_attn_csr takes head widths D = C/H up to {_MAX_HEAD}; got C={c}, H={num_heads}")


def _kernel_head(c: int, num_heads: int) -> int:
    """The head width the kernels run a head of ``D = c / num_heads``
    channels at: D itself where a lane layout takes it (up to 256: a multiple
    of 8, or 1, 2, 4 with C a multiple of 32; above 256: a multiple of the 16
    or 32 channels a lane holds), else D padded with zero channels to the next
    such width. Takes what :func:`_check_heads` accepts."""
    d = c // num_heads
    if d > _GROUP_CHANNELS:
        vb = 16 if d <= 512 else 32
        return -(-d // vb) * vb
    if d % 8 == 0 or (d in (1, 2, 4) and c % 32 == 0):
        return d
    return -(-d // 8) * 8


def _pad_heads(x: torch.Tensor, num_heads: int, d: int, dp: int) -> torch.Tensor:
    """(..., k H d) -> (..., k H dp): each head's d channels followed by
    dp - d zeros, for each of the k row blocks (k = 2 for ``[k|v]``)."""
    lead = x.shape[:-1]
    k = x.shape[-1] // (num_heads * d)
    return torch.nn.functional.pad(x.reshape(*lead, k, num_heads, d), (0, dp - d)).reshape(*lead, k * num_heads * dp)


def _unpad_heads(x: torch.Tensor, num_heads: int, d: int, dp: int) -> torch.Tensor:
    """The inverse of :func:`_pad_heads`: the first d channels of each head."""
    lead = x.shape[:-1]
    k = x.shape[-1] // (num_heads * dp)
    return x.reshape(*lead, k, num_heads, dp)[..., :d].reshape(*lead, k * num_heads * d)


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
    cost.record("edge_attn_csr", lambda: cost.edge_attn_flops(
        q.shape[0] // (rowptr.numel() - 1), src.numel(), rowptr.numel() - 1, q.shape[1], num_heads, a.shape[1]))
    if _on_cpu(q, kv, rowptr, src, a, w_aug):
        with cost.plain():
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
    _require(a.shape[0] == src.numel() and a2 > 0, f"a shape {tuple(a.shape)} for {src.numel()} edges")
    _require(w_aug.shape == (a2, c), f"w_aug shape {tuple(w_aug.shape)} != ({a2}, {c})")
    _require_contiguous(q=q, kv=kv, rowptr=rowptr, src=src, a=a, w_aug=w_aug)
    _require(all(t.data_ptr() % 16 == 0 for t in (q, kv, w_aug)),
             "q, kv and w_aug must start on 16-byte boundaries (rows are read as 16-byte vectors)")
    d = c // num_heads
    dp = _kernel_head(c, num_heads)
    if dp != d:  # zero channels: the logit and the softmax are unchanged, num's extra columns dropped
        q, kv, w_aug = (_pad_heads(t, num_heads, d, dp) for t in (q, kv, w_aug))
        c = num_heads * dp
    vb, _, group = _lane_layout(c, num_heads)
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
            batch, nd, kv.shape[0] // batch, c, num_heads, a2, group, vb, d, stream,
        )
    _check_launch(rc, "edge_attn_csr")
    LAUNCHES["edge_attn_csr"] += 1
    if dp != d:
        num = _unpad_heads(num, num_heads, d, dp)
    return AttentionPartials(num.view(bnd, num_heads, d), den, m)


@functools.lru_cache(maxsize=256)
def _bwd_parts(rows: int, c: int, a2: int) -> int:
    """The parts the backward's ``dw_aug`` sum splits the ``rows``
    destination rows (batch x destinations) into, each summed by its own
    CTAs before the parts are summed in order: enough for about
    ``_DW_CTAS`` CTAs over the (column, attribute-row) tiles of ``(a2, c)``,
    at least 32 rows a part. A function of the shape alone, so every card
    sums in the same order."""
    tiles = -(-c // _DW_COLS) * -(-a2 // _DW_ROWS)
    return max(1, min(-(-rows // 32), -(-_DW_CTAS // tiles)))


def edge_attn_csr_bwd(
    q: torch.Tensor,
    kv: torch.Tensor,
    rowptr: torch.Tensor,
    src: torch.Tensor,
    a: torch.Tensor,
    w_aug: torch.Tensor,
    m: torch.Tensor,
    g_num: torch.Tensor,
    g_den: torch.Tensor,
    num_heads: int,
    csr_t: CSRTranspose,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`edge_attn_csr` with ``m`` held at its forward value
    (see :func:`edge_attn_csr_bwd_plain` for the shapes): ``(dq, dkv, da,
    dw_aug)``, fp32. ``csr_t`` is the edge list's :class:`CSRTranspose` on
    the same device."""
    cost.record("edge_attn_csr_bwd", lambda: cost.edge_attn_bwd_flops(
        q.shape[0] // (rowptr.numel() - 1), src.numel(), rowptr.numel() - 1, q.shape[1], num_heads, a.shape[1]))
    if _on_cpu(q, kv, rowptr, src, a, w_aug, m, g_num, g_den):
        with cost.plain():
            return edge_attn_csr_bwd_plain(q, kv, rowptr, src, a, w_aug, m, g_num, g_den, num_heads)
    dt = q.dtype
    _require(dt in _DTYPES, f"compute dtype must be fp32 or bf16, got {dt}")
    _require(all(t.dtype == dt for t in (kv, a, w_aug)), "q, kv, a, w_aug must share one dtype")
    _require(all(t.dtype == torch.float32 for t in (m, g_num, g_den)), "m, g_num, g_den must be fp32")
    perm, colptr, dst, pos = csr_t
    _require(all(t.dtype == torch.int32 for t in (rowptr, src, perm, colptr, dst, pos)),
             "rowptr, src and the transposed CSR must be int32")
    _require(all(t.device == q.device for t in csr_t), "the transposed CSR must be on q's device")
    bnd, c = q.shape
    nd = rowptr.numel() - 1
    _check_heads(c, num_heads)
    _require(nd > 0 and bnd % nd == 0, f"q rows {bnd} not a multiple of {nd} destinations")
    batch = bnd // nd
    _require(kv.shape[1] == 2 * c and kv.shape[0] % batch == 0, f"kv shape {tuple(kv.shape)} for C={c}, B={batch}")
    ns = kv.shape[0] // batch
    num_edges, a2 = a.shape
    _require(num_edges == src.numel() and a2 > 0, f"a shape {tuple(a.shape)} for {src.numel()} edges")
    _require(w_aug.shape == (a2, c), f"w_aug shape {tuple(w_aug.shape)} != ({a2}, {c})")
    _require(m.shape == (bnd, num_heads) and g_den.shape == (bnd, num_heads) and g_num.shape == (bnd, c),
             f"m, g_num, g_den shapes {tuple(m.shape)}, {tuple(g_num.shape)}, {tuple(g_den.shape)}")
    _require(all(t.numel() == num_edges for t in (perm, dst, pos)) and colptr.numel() == ns + 1,
             "the transposed CSR does not match the edge list")
    _require_contiguous(q=q, kv=kv, rowptr=rowptr, src=src, a=a, w_aug=w_aug, m=m, g_num=g_num,
                        g_den=g_den, perm=perm, colptr=colptr, dst=dst, pos=pos)
    _require(all(t.data_ptr() % 16 == 0 for t in (q, kv, w_aug, g_num)),
             "q, kv, w_aug and g_num must start on 16-byte boundaries (rows are read as 16-byte vectors)")
    dev = q.device
    d = c // num_heads
    dp = _kernel_head(c, num_heads)
    if dp != d:  # as the forward pads: the zero channels' gradients are dropped
        q, kv, w_aug, g_num = (_pad_heads(t, num_heads, d, dp) for t in (q, kv, w_aug, g_num))
        c = num_heads * dp
    vb, _, group = _lane_layout(c, num_heads)
    parts = _bwd_parts(bnd, c, a2)  # the dw_aug sum's split of the destination rows, from the shape alone
    dq = torch.empty((bnd, c), dtype=torch.float32, device=dev)
    dkv = torch.empty((batch * ns, 2 * c), dtype=torch.float32, device=dev)
    da = torch.empty((num_edges, a2), dtype=torch.float32, device=dev)
    dw = torch.empty((a2, c), dtype=torch.float32, device=dev)
    dlw = torch.empty((batch, num_edges, num_heads, 2), dtype=torch.float32, device=dev)  # (dl, w) by position
    adl = torch.empty((bnd, num_heads, a2), dtype=torch.float32, device=dev)  # sum_e a_e dl, per destination
    aw = torch.empty((bnd, num_heads, a2), dtype=torch.float32, device=dev)  # sum_e a_e w
    dw_part = torch.empty((parts, a2, c), dtype=torch.float32, device=dev)
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    fn = lib.edge_attn_csr_bwd_bf16 if dt == torch.bfloat16 else lib.edge_attn_csr_bwd_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            q.data_ptr(), kv.data_ptr(), rowptr.data_ptr(), src.data_ptr(), a.data_ptr(),
            w_aug.data_ptr(), m.data_ptr(), g_num.data_ptr(), g_den.data_ptr(),
            colptr.data_ptr(), perm.data_ptr(), dst.data_ptr(), pos.data_ptr(),
            dq.data_ptr(), dkv.data_ptr(), da.data_ptr(), dw.data_ptr(),
            dlw.data_ptr(), adl.data_ptr(), aw.data_ptr(), dw_part.data_ptr(),
            batch, nd, ns, num_edges, c, num_heads, a2, group, vb, parts, d, stream,
        )
    _check_launch(rc, "edge_attn_csr_bwd")
    LAUNCHES["edge_attn_csr_bwd"] += 1
    if dp != d:
        dq, dkv, dw = (_unpad_heads(t, num_heads, d, dp) for t in (dq, dkv, dw))
    return dq, dkv, da, dw


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class KVProj(torch.autograd.Function):
    """:func:`kv_proj` with the chain of ``_feats_kernel_bwd``: ``df = dkv.w``,
    ``dw = dkv^T.f``, ``db = sum dkv``, in fp32 and rounded to each primal's
    dtype."""

    @staticmethod
    def forward(ctx, f: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(f, w)
        ctx.b_dtype = b.dtype
        return kv_proj(f, w, b)

    @staticmethod
    def backward(ctx, dkv: torch.Tensor):
        f, w = ctx.saved_tensors
        dkv = dkv.float()
        df = (dkv @ w.float()).to(f.dtype) if ctx.needs_input_grad[0] else None
        dw = (dkv.t() @ f.float()).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = dkv.sum(0).to(ctx.b_dtype) if ctx.needs_input_grad[2] else None
        return df, dw, db


class EdgeAttnCSR(torch.autograd.Function):
    """:func:`edge_attn_csr` with :func:`edge_attn_csr_bwd` as its backward.

    Valid under the m-gauge contract of ``slot_attention_feats_kernel``: the
    consumer of ``(num, den, m)`` is invariant to ``(num e^-d, den e^-d, m+d)``
    (as :func:`merge_partials` and :func:`finalize_partials` are), so ``m`` is
    returned non-differentiable and its cotangent is dropped. ``csr_t`` is the
    edge list's :class:`CSRTranspose` on q's device (the layers register it
    as buffers, once per edge set)."""

    @staticmethod
    def forward(ctx, q, kv, a, w_aug, rowptr, src, num_heads: int, csr_t):
        p = edge_attn_csr(q, kv, rowptr, src, a, w_aug, num_heads)
        ctx.save_for_backward(q, kv, a, w_aug, rowptr, src, p.m)
        ctx.num_heads, ctx.csr_t = num_heads, csr_t
        ctx.mark_non_differentiable(p.m)
        return p.num, p.den, p.m

    @staticmethod
    def backward(ctx, g_num, g_den, _g_m):
        q, kv, a, w_aug, rowptr, src, m = ctx.saved_tensors
        # autograd materialises an unused output's cotangent as zeros
        dq, dkv, da, dw = edge_attn_csr_bwd(
            q, kv, rowptr, src, a, w_aug, m, g_num.reshape(q.shape).float().contiguous(),
            g_den.float().contiguous(), ctx.num_heads, ctx.csr_t,
        )
        return dq.to(q.dtype), dkv.to(kv.dtype), da.to(a.dtype), dw.to(w_aug.dtype), None, None, None, None
