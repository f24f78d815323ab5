"""Band-masked (sliding-window) attention: the Hopper kernel, its plain
PyTorch version and the autograd Function.

Replaces ``anemoi_models_tpu/ops/pallas/flash_attention.py:_flash_kernel``
(forward). The JAX package differentiates its blockwise twin
(``flash_attention.py:_bwd``), which XLA fuses; run eagerly on the card that
recompute set the pace of a step, so the port has a backward kernel
(``csrc/flash_attention_bwd.cu``) that computes the gradient of that same
function from the forward's row statistics.

- :func:`blockwise_attention` is the plain version: a q-block loop with
  O(N (blk + 2w)) live memory, fp32 logits and softmax, masking at -1e30,
  ``|i - j| <= w`` and an optional causal mask.
- :func:`flash_attention` takes it for CPU tensors and launches
  ``csrc/flash_attention.cu`` for CUDA tensors (or raises), counting its
  launches in :data:`LAUNCHES`.
- :func:`flash_attention_bwd` is the backward: ``P`` recomputed per tile
  from the forward's log-sum-exp (written by the forward kernel when asked,
  ``return_lse``), ``D_i = rowsum(dO_i * O_i)``; bf16 heads up to 128 on one
  ``wgmma`` + TMA kernel by key blocks that computes S, P, dP and dS once per
  pair and adds each query tile's dQ in key-block order (deterministic, no
  floating-point atomics), fp32 heads up to 128 on register-tiled CUDA-core
  kernels (a pass by key blocks for dK and dV, one by query blocks for dQ),
  wider heads on CUDA-core row kernels. :func:`flash_attention_bwd_plain` is
  its plain version.
- :class:`FlashAttention` is the Function the attention layer runs through.

Shapes: q, k, v are (batch, heads, seq, head_dim); ``window_size`` is the
half-width w, query i attends keys j with ``|i - j| <= w``. With
``q_offset``, ``k_offset`` and ``n_valid`` the rows are a part of a longer
sequence: q's rows sit at global positions ``q_offset + i``, k's and v's
(their own count of rows) at ``k_offset + j``; the band and the causal mask
compare global positions, and keys outside ``[0, n_valid)`` are masked. A
rank of a sequence split over ranks so computes its rows of the unsharded
output, from halo-extended keys (``ops/ring_attention.py``) or from every
key (``layers/attention.py``). A query that sees no key gets 0.

Every head width runs on the card: bf16 heads up to 512 on the ``wgmma``
kernel (a width other than 16, 32, 64, 128, 256 or 512 padded with zero
channels to the next of them, the scale kept at 1/sqrt of the true width;
at 512 its two warpgroups split D), fp32 heads up to 128 on the CUDA-core
tile kernel (padded the same way), and wider heads of either dtype on the
CUDA-core row kernel (up to 1024).

Attention-weight dropout (``dropout_rate`` with a ``dropout_key``) drops
normalized probabilities as the JAX package does: ``out_i = sum_j keep_ij
p_ij v_j / ((1 - rate) l_i)``, the normalizer summing every pair. ``keep_ij``
is :func:`dropout_keep`: word ``j % 4`` of Philox4x32-10 at counter ``(j // 4,
i, b H + h, 0)`` under the 64-bit key, below ``round((1 - rate) 2^32)``, at
the global positions i and j, so a sharded call drops the unsharded call's
pairs. The kernels and the plain version draw the same bits, so the
backward, which redraws the mask with the same key, differentiates the mask
the forward used. :func:`fold_key` derives a key from a seed and counters
(step, layer, lead time); nothing advances between a forward and its
recompute.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from anemoi_models_tpu_torch.ops import cost
from anemoi_models_tpu_torch.ops.edge_attention import _check_launch, _on_cpu, _require

__all__ = [
    "FlashAttention",
    "LAUNCHES",
    "blockwise_attention",
    "dropout_keep",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "fold_key",
    "keep_threshold",
    "live_pairs",
]

_NEG = -1e30
_TILE_DIMS = {torch.bfloat16: (16, 32, 64, 128, 256, 512), torch.float32: (16, 32, 64, 128)}  # the tile kernels' widths
_MAX_HEAD = 1024  # the row kernel's widest head: 32 channels a lane
_DTYPES = (torch.float32, torch.bfloat16)
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

# kernel launches; a CPU call runs the plain version and adds nothing
LAUNCHES: dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}


def fold_key(key: int, *data: int) -> int:
    """A 64-bit key folded with each of ``data`` in turn (splitmix64's
    finalizer over ``key ^ (d * golden ratio)``): a pure function, so the
    same seed, step, layer and lead time give the same key anywhere."""
    for d in data:
        z = (key ^ ((int(d) * 0x9E3779B97F4A7C15) & _MASK64)) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        key = z ^ (z >> 31)
    return key


def keep_threshold(rate: float) -> int:
    """``round((1 - rate) 2^32)``, at most 2^32 - 1: a pair survives where its
    uint32 is below it."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in (0, 1), got {rate}")
    return min(round((1.0 - rate) * 2.0**32), _MASK32)


def _mulhilo(a: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The high and low words of ``a * x`` for a uint32 constant and uint32
    values held in int64, in 16-bit limbs so that no product leaves int64."""
    ah, al = a >> 16, a & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    mid = ah * xl + al * xh
    lo_full = al * xl + ((mid & 0xFFFF) << 16)
    return (ah * xh + (mid >> 16) + (lo_full >> 32)) & _MASK32, lo_full & _MASK32


def _philox(c0, c1, c2, c3, key: int) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 counters, as
    ``csrc/flash_attention.cu:philox4x32_10`` computes it."""
    k0, k1 = key & _MASK32, key >> 32
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def dropout_keep(key: int, keep_below: int, bh: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Whether pair (i, j) of head ``bh`` (= b H + h) survives: word ``j % 4``
    of Philox4x32-10 at counter ``(j // 4, i, bh, 0)`` below ``keep_below``.
    The index tensors broadcast against each other."""
    bh, i, j = torch.broadcast_tensors(bh.long(), i.long(), j.long())
    words = _philox(j >> 2, i, bh, torch.zeros_like(j), key)
    word = torch.stack(words).gather(0, (j & 3)[None])[0]
    return word < keep_below


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: Optional[int] = None,
    is_causal: bool = False,
    block_size: int = 512,
    dropout_rate: float = 0.0,
    dropout_key: Optional[int] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    n_valid: Optional[int] = None,
    return_lse: bool = False,
):
    """Windowed attention over q-blocks, fp32 logits and softmax; the
    weights are rounded to v's dtype before the product with v, and the
    output is in q's dtype. With ``dropout_rate`` > 0 the normalized weights
    of the pairs :func:`dropout_keep` drops under ``dropout_key`` are zeroed
    and the rest divided by ``1 - dropout_rate``. ``q_offset``, ``k_offset``
    and ``n_valid`` (default: every key valid) place the rows in a longer
    sequence (see the module's docstring). With ``return_lse`` it returns
    ``(out, lse)``: each row's log-sum-exp of its scaled logits, fp32 (B, H,
    Nq), +inf for a query that sees no key."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if n_valid is None:
        n_valid = k_offset + nk
    if nq == 0:
        out = q.new_empty(b, h, 0, d)
        return (out, q.new_empty(b, h, 0, dtype=torch.float32)) if return_lse else out
    blk = min(block_size, nq)
    scale = 1.0 / math.sqrt(d)
    kwidth = nk if window_size is None else min(blk + 2 * window_size, nk)
    shift = q_offset - k_offset  # query i sits at key row i + shift
    edges = k_offset < 0 or k_offset + nk > n_valid  # some keys are out of [0, n_valid)
    if dropout_rate > 0.0:
        if dropout_key is None:
            raise ValueError("attention dropout_rate > 0 needs a dropout_key")
        keep_below = keep_threshold(dropout_rate)
        bh = torch.arange(b * h, device=q.device).view(b, h, 1, 1)
    blocks, lses = [], []
    for q0 in range(0, nq, blk):
        q1 = min(q0 + blk, nq)
        kstart = 0 if window_size is None else min(max(q0 + shift - window_size, 0), nk - kwidth)
        ks = k[:, :, kstart:kstart + kwidth].float()
        vs = v[:, :, kstart:kstart + kwidth]
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, q0:q1].float(), ks) * scale
        qpos = torch.arange(q0, q1, device=q.device)[:, None] + q_offset
        kpos = torch.arange(kstart, kstart + kwidth, device=q.device)[None, :] + k_offset
        mask = torch.ones(q1 - q0, kwidth, dtype=torch.bool, device=q.device)
        if window_size is not None:
            mask &= (qpos - kpos).abs() <= window_size
        if is_causal:
            mask &= qpos >= kpos
        if edges:
            mask &= (kpos >= 0) & (kpos < n_valid)
        s = s.masked_fill(~mask, _NEG)
        if return_lse:
            lses.append(torch.where(mask.any(-1), torch.logsumexp(s, -1), math.inf))
        w = torch.softmax(s, dim=-1)
        if edges or shift:  # a query that sees no key gets 0, as the kernels give it
            w = torch.where(mask.any(-1, keepdim=True), w, 0.0)
        if dropout_rate > 0.0:
            keep = dropout_keep(dropout_key, keep_below, bh, qpos, kpos.clamp_min(0))
            w = torch.where(keep, w / (1.0 - dropout_rate), 0.0)
        blocks.append(torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(), vs.float()))
    out = torch.cat(blocks, dim=2).to(q.dtype)
    return (out, torch.cat(lses, dim=2)) if return_lse else out


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,  # (B, H, Nq, D) the forward's output
    d_out: torch.Tensor,  # (B, H, Nq, D) its cotangent
    lse: torch.Tensor,  # (B, H, Nq) fp32 the forward's row log-sum-exp
    *,
    window_size: Optional[int] = None,
    is_causal: bool = False,
    block_size: int = 512,
    dropout_rate: float = 0.0,
    dropout_key: Optional[int] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`blockwise_attention`, written out over the
    same q-blocks: ``(dq, dk, dv)`` fp32. ``P`` is recomputed from ``lse``,
    ``D_i = rowsum(dO_i * O_i)``, ``dS = P (dP - D_i)`` with ``dP`` the
    gradient of the dropped weights through the forward's mask
    (:func:`dropout_keep` under ``dropout_key``). It rounds where
    ``csrc/flash_attention_bwd.cu`` rounds: the dropped weights and ``dS`` to
    the inputs' dtype before their products, every sum in fp32."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if n_valid is None:
        n_valid = k_offset + nk
    dq = torch.zeros(b, h, nq, d, device=q.device)
    dk, dv = torch.zeros(b, h, nk, d, device=q.device), torch.zeros(b, h, nk, d, device=q.device)
    if nq == 0:
        return dq, dk, dv
    dt = q.dtype
    blk = min(block_size, nq)
    scale = 1.0 / math.sqrt(d)
    kwidth = nk if window_size is None else min(blk + 2 * window_size, nk)
    shift = q_offset - k_offset
    drop = dropout_rate > 0.0
    if drop:
        if dropout_key is None:
            raise ValueError("attention dropout_rate > 0 needs a dropout_key")
        keep_below = keep_threshold(dropout_rate)
        bh = torch.arange(b * h, device=q.device).view(b, h, 1, 1)
    delta = (d_out.float() * out.float()).sum(-1)
    for q0 in range(0, nq, blk):
        q1 = min(q0 + blk, nq)
        kstart = 0 if window_size is None else min(max(q0 + shift - window_size, 0), nk - kwidth)
        ks, vs = k[:, :, kstart:kstart + kwidth].float(), v[:, :, kstart:kstart + kwidth].float()
        qb, gb = q[:, :, q0:q1].float(), d_out[:, :, q0:q1].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qb, ks) * scale
        qpos = torch.arange(q0, q1, device=q.device)[:, None] + q_offset
        kpos = torch.arange(kstart, kstart + kwidth, device=q.device)[None, :] + k_offset
        mask = (kpos >= 0) & (kpos < n_valid) & torch.ones(q1 - q0, 1, dtype=torch.bool, device=q.device)
        if window_size is not None:
            mask &= (qpos - kpos).abs() <= window_size
        if is_causal:
            mask &= qpos >= kpos
        p = torch.where(mask, torch.exp(s - lse[:, :, q0:q1, None]), 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", gb, vs)
        pd = p
        if drop:
            keep = dropout_keep(dropout_key, keep_below, bh, qpos, kpos.clamp_min(0))
            pd = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
            dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
        dv[:, :, kstart:kstart + kwidth] += torch.einsum("bhqk,bhqd->bhkd", pd.to(dt).float(), gb)
        ds = (p * (dp - delta[:, :, q0:q1, None])).to(dt).float()
        dq[:, :, q0:q1] = torch.einsum("bhqk,bhkd->bhqd", ds, ks) * scale
        dk[:, :, kstart:kstart + kwidth] += torch.einsum("bhqk,bhqd->bhkd", ds, qb) * scale
    return dq, dk, dv


def live_pairs(n: int, window_size: Optional[int], is_causal: bool, nk: Optional[int] = None, q_offset: int = 0,
               k_offset: int = 0, n_valid: Optional[int] = None) -> int:
    """(query, key) pairs inside the mask: the work the attention needs. ``n``
    query rows; ``nk`` key rows (default ``n``), placed as
    :func:`blockwise_attention` places them."""
    nk = n if nk is None else nk
    n_valid = k_offset + nk if n_valid is None else n_valid
    i = torch.arange(n, dtype=torch.int64) + q_offset
    lo = torch.full_like(i, max(k_offset, 0))
    hi = torch.full_like(i, min(k_offset + nk, n_valid) - 1)
    if window_size is not None:
        lo = torch.maximum(lo, i - window_size)
        hi = torch.minimum(hi, i + window_size)
    if is_causal:
        hi = torch.minimum(hi, i)
    return int((hi - lo + 1).clamp_min(0).sum())


def _strides_ok(t: torch.Tensor) -> bool:
    """Innermost stride 1, every other stride and the address 16-byte
    multiples (the kernel loads rows as 16-byte vectors)."""
    vec = 16 // t.element_size()
    return t.stride(-1) == 1 and all(s % vec == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0


def _tile_width(d: int, dtype: torch.dtype) -> int:
    """The head width a tile kernel runs a head of ``d`` channels at (the
    next width it is built for), or ``d`` itself where the row kernel takes
    it (above the tile kernels' widest)."""
    widths = _TILE_DIMS[dtype]
    return next((w for w in widths if w >= d), d)


def _bwd_width(d: int) -> int:
    """The head width the backward runs a head of ``d`` channels at: the
    next of 16, 32, 64, 128 (the tile kernels, either dtype) up to 128,
    else ``d`` itself (the row kernels)."""
    return next((w for w in (16, 32, 64, 128) if w >= d), d)


def _bwd_query_tiles(nq: int) -> int:
    """The 64-query tiles whose dQ the bf16 backward kernel adds to in key
    block order, a counter each (``csrc/flash_attention_bwd.cu:kFbQueries``)."""
    return -(-nq // 64)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window_size: Optional[int] = None,
    is_causal: bool = False,
    dropout_rate: float = 0.0,
    dropout_key: Optional[int] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    n_valid: Optional[int] = None,
    return_lse: bool = False,
):
    """Attention output (B, H, Nq, D) in q's dtype, and with ``return_lse``
    the rows' log-sum-exp (fp32 (B, H, Nq), as :func:`blockwise_attention`
    gives it; the kernel writes it beside an output of the same bits). On the card q, k and v
    share one dtype (fp32 or bf16), B, H and D; k and v share one shape
    (B, H, Nk, D) and strides; rows may be strided (a view of a fused
    projection), channels are contiguous. The output is a (B, H, Nq, D) view
    of a (B, Nq, H, D) buffer. ``dropout_rate`` > 0 drops attention weights
    under ``dropout_key``; ``q_offset``, ``k_offset`` and ``n_valid`` place
    the rows in a longer sequence (see the module's docstring)."""
    if dropout_rate > 0.0 and dropout_key is None:
        raise ValueError("attention dropout_rate > 0 needs a dropout_key")
    cost.record("flash_attention", lambda: cost.flash_flops(
        q.shape[0] * q.shape[1], live_pairs(q.shape[2], window_size, is_causal, k.shape[2], q_offset, k_offset, n_valid),
        q.shape[3]))
    if _on_cpu(q, k, v):
        with cost.plain():
            return blockwise_attention(q, k, v, window_size=window_size, is_causal=is_causal,
                                       dropout_rate=dropout_rate, dropout_key=dropout_key, q_offset=q_offset,
                                       k_offset=k_offset, n_valid=n_valid, return_lse=return_lse)
    _require(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
             f"q, k, v must share fp32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    _require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape and k.shape[:2] == q.shape[:2]
             and k.shape[3] == q.shape[3],
             f"q (B, H, Nq, D) and k, v (B, H, Nk, D) must share B, H and D, got {tuple(q.shape)}, "
             f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    n_valid = k_offset + nk if n_valid is None else n_valid
    _require(0 < d <= _MAX_HEAD, f"flash_attention takes head widths up to {_MAX_HEAD}, got {d}")
    _require(v.stride() == k.stride(), "k and v must share strides")
    _require(window_size is None or window_size >= 0, f"window_size must be >= 0, got {window_size}")
    _require(0 < b * h < 65536 and nk > 0, f"batch * heads {b * h} or key rows {nk} out of range")
    _require(q_offset >= 0 and max(q_offset + nq, abs(k_offset) + nk, n_valid) < 2**31,
             f"positions out of range: q_offset {q_offset}, k_offset {k_offset}, n_valid {n_valid}")
    _require(0.0 <= dropout_rate < 1.0, f"dropout_rate must be in [0, 1), got {dropout_rate}")
    dk = _tile_width(d, q.dtype)
    if dk != d:  # zero channels: the logits are unchanged, the output's extra columns dropped
        q, k, v = (torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v))
    if dk <= _TILE_DIMS[q.dtype][-1]:  # the tile kernels read rows as 16-byte vectors
        _require(all(_strides_ok(t) for t in (q, k, v)), "q, k, v need contiguous channels and 16-byte aligned rows")
    else:
        _require(all(t.stride(-1) == 1 for t in (q, k, v)), "q, k, v need contiguous channels")
    out = torch.empty((b, nq, h, dk), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if return_lse else None
    if nq == 0:  # no query rows: nothing to launch
        out = out.permute(0, 2, 1, 3)[..., :d]
        return (out, lse) if return_lse else out
    drop = dropout_rate > 0.0
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    fn = lib.flash_attn_bf16 if q.dtype == torch.bfloat16 else lib.flash_attn_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, nq, nk, dk,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            out.stride(0), out.stride(2), out.stride(1),
            -1 if window_size is None else window_size, int(is_causal), q_offset, k_offset, n_valid,
            1.0 / math.sqrt(d), int(drop), keep_threshold(dropout_rate) if drop else 0,
            (dropout_key & _MASK32) if drop else 0, (dropout_key >> 32) if drop else 0,
            1.0 / (1.0 - dropout_rate), None if lse is None else lse.data_ptr(), stream,
        )
    _check_launch(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    out = out.permute(0, 2, 1, 3)[..., :d]
    return (out, lse) if return_lse else out


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    d_out: torch.Tensor,
    lse: torch.Tensor,
    window_size: Optional[int] = None,
    is_causal: bool = False,
    dropout_rate: float = 0.0,
    dropout_key: Optional[int] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` fp32 of :func:`flash_attention` at its inputs, from
    its output ``out``, the cotangent ``d_out`` (q's dtype) and the row
    log-sum-exp ``lse`` it returned; the call's other arguments as the
    forward's. On the card one launch of ``csrc/flash_attention_bwd.cu``
    (the row terms D, then one bf16 kernel or the two fp32 or row kernels)."""
    if dropout_rate > 0.0 and dropout_key is None:
        raise ValueError("attention dropout_rate > 0 needs a dropout_key")
    cost.record("flash_attention_bwd", lambda: cost.flash_bwd_flops(
        q.shape[0] * q.shape[1], live_pairs(q.shape[2], window_size, is_causal, k.shape[2], q_offset, k_offset, n_valid),
        q.shape[3]))
    if _on_cpu(q, k, v, out, d_out, lse):
        with cost.plain():
            return flash_attention_bwd_plain(q, k, v, out, d_out, lse, window_size=window_size, is_causal=is_causal,
                                             dropout_rate=dropout_rate, dropout_key=dropout_key, q_offset=q_offset,
                                             k_offset=k_offset, n_valid=n_valid)
    dt = q.dtype
    _require(dt in _DTYPES and all(t.dtype == dt for t in (k, v, out, d_out)),
             f"q, k, v, out and d_out must share fp32 or bf16, got {[str(t.dtype) for t in (q, k, v, out, d_out)]}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    _require(q.dim() == 4 and k.shape == (b, h, nk, d) and v.shape == k.shape and out.shape == q.shape
             and d_out.shape == q.shape, f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
             f"out {tuple(out.shape)}, d_out {tuple(d_out.shape)}")
    _require(lse.dtype == torch.float32 and lse.shape == (b, h, nq) and lse.is_contiguous(), "lse must be fp32 (B, H, Nq)")
    n_valid = k_offset + nk if n_valid is None else n_valid
    _require(0 < d <= _MAX_HEAD, f"flash_attention_bwd takes head widths up to {_MAX_HEAD}, got {d}")
    _require(v.stride() == k.stride(), "k and v must share strides")
    _require(window_size is None or window_size >= 0, f"window_size must be >= 0, got {window_size}")
    _require(0 < b * h < 65536 and nk > 0, f"batch * heads {b * h} or key rows {nk} out of range")
    _require(q_offset >= 0 and max(q_offset + nq, abs(k_offset) + nk, n_valid) < 2**31,
             f"positions out of range: q_offset {q_offset}, k_offset {k_offset}, n_valid {n_valid}")
    _require(0.0 <= dropout_rate < 1.0, f"dropout_rate must be in [0, 1), got {dropout_rate}")
    dk_ = _bwd_width(d)
    if dk_ != d:  # zero channels: the logits and D_i are unchanged, the gradients' extra columns dropped
        q, k, v, out, d_out = (torch.nn.functional.pad(t, (0, dk_ - d)) for t in (q, k, v, out, d_out))
    if not all(_strides_ok(t) for t in (q, k, v, out, d_out)):  # the kernels read rows as 16-byte vectors
        q, k, v, out, d_out = (t.contiguous() for t in (q, k, v, out, d_out))
    # dq is added to (the bf16 tile kernel) and stays 0 for a query that sees no key; every key's dk, dv is written
    dq = torch.zeros((b, h, nq, dk_), dtype=torch.float32, device=q.device)
    dkk = torch.empty((b, h, nk, dk_), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, h, nk, dk_), dtype=torch.float32, device=q.device)
    if nq == 0:
        return dq[..., :d], dkk[..., :d].zero_(), dv[..., :d].zero_()
    delta = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    # the bf16 tile kernel's work counter and each query tile's count of the key blocks that have added to its dq
    counters = torch.zeros(1 + b * h * _bwd_query_tiles(nq), dtype=torch.int32, device=q.device) \
        if dt == torch.bfloat16 and dk_ <= 128 else None
    drop = dropout_rate > 0.0
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    fn = lib.flash_attn_bwd_bf16 if dt == torch.bfloat16 else lib.flash_attn_bwd_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dkk.data_ptr(), dv.data_ptr(), b, h, nq, nk, dk_,
            *q.stride()[:3], *k.stride()[:3], *out.stride()[:3], *d_out.stride()[:3],
            -1 if window_size is None else window_size, int(is_causal), q_offset, k_offset, n_valid,
            1.0 / math.sqrt(d), int(drop), keep_threshold(dropout_rate) if drop else 0,
            (dropout_key & _MASK32) if drop else 0, (dropout_key >> 32) if drop else 0,
            1.0 / (1.0 - dropout_rate), None if counters is None else counters.data_ptr(), stream,
        )
    _check_launch(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    if dk_ != d:
        dq, dkk, dv = dq[..., :d], dkk[..., :d], dv[..., :d]
    return dq, dkk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` forward (with its row log-sum-exp), and
    :func:`flash_attention_bwd` backward, with the forward's dropout key and
    so its mask."""

    @staticmethod
    def forward(ctx, q, k, v, window_size: Optional[int], is_causal: bool, dropout_rate: float = 0.0,
                dropout_key: Optional[int] = None, q_offset: int = 0, k_offset: int = 0,
                n_valid: Optional[int] = None):
        ctx.kw = dict(window_size=window_size, is_causal=is_causal, dropout_rate=dropout_rate,
                      dropout_key=dropout_key, q_offset=q_offset, k_offset=k_offset, n_valid=n_valid)
        out, lse = flash_attention(q, k, v, **ctx.kw, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, g.to(q.dtype), lse, **ctx.kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None, None, None
