"""Sequence-parallel sliding-window attention by halo exchange.

Counterpart of ``anemoi_models_tpu/ops/ring_attention.py``. The sequence
(the hidden mesh's rows) is split contiguously over the ``model`` axis. A
query within ``window_size`` positions of its keys needs only a +-w halo of
k and v from its two neighbours. The JAX package sends them with two
``ppermute``s; gloo has no ``send`` for CUDA tensors, so here each rank
all-gathers every rank's first and last w rows of k and v (one all-gather
of 4 w rows a rank) and takes its neighbours'. Each rank then attends its
own rows under the band and ``kpos in [0, N)`` masks, a sequence that does
not divide the axis padded internally, exactly as the JAX function does.

The JAX package computes this with ``einsum`` outside any Pallas kernel, and
so does the port, in plain torch ops (the flash kernel with a key offset is
a later step). Attention-weight dropout draws per rank, as the JAX package
draws per shard, so its pattern depends on the rank count.
"""

from __future__ import annotations

from typing import Optional

import torch

from anemoi_models_tpu_torch.ops.flash_attention import fold_key
from anemoi_models_tpu_torch.parallel.api import Mesh
from anemoi_models_tpu_torch.parallel.primitives import sync_tensor

__all__ = ["halo_window_attention"]


def _local_attention(q, k, v, qpos, kpos, n_total: int, window: int, dropout_rate: float,
                     dropout_key: Optional[int]) -> torch.Tensor:
    """Attention of q (B, H, n, D) at positions ``qpos`` against k / v
    (B, H, m, D) at ``kpos``: keys in ``[0, n_total)`` and within the
    window; fp32 scores and softmax, the weights in v's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = (kpos[None, :] >= 0) & (kpos[None, :] < n_total) & ((qpos[:, None] - kpos[None, :]).abs() <= window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        gen = torch.Generator(device=q.device)
        gen.manual_seed(int(dropout_key))
        keep = torch.rand(w.shape, generator=gen, device=q.device) >= dropout_rate
        w = torch.where(keep, w / (1.0 - dropout_rate), torch.zeros_like(w))
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


def halo_window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: int,
    seq_len: int,
    mesh: Mesh,
    axis: str = "model",
    dropout_rate: float = 0.0,
    dropout_key: Optional[int] = None,
) -> torch.Tensor:
    """Windowed attention over this rank's rows (B, H, n_local, D) of a
    ``seq_len``-long sequence split over ``axis``. ``dropout_rate`` > 0 drops
    attention weights under ``dropout_key`` folded with the rank's index."""
    if dropout_rate > 0.0 and dropout_key is None:
        raise ValueError("halo attention dropout_rate > 0 requires a dropout_key")
    size, index = mesh.shape[axis], mesh.coords[axis]
    shard_len = -(-seq_len // size)
    lo, hi = mesh.rows(seq_len, axis)
    if q.shape[-2] != hi - lo:
        raise ValueError(f"rank {index} holds rows [{lo}, {hi}) of {seq_len}, got {q.shape[-2]}")
    w = window_size
    if w > shard_len:
        raise ValueError(f"window ({w}) must fit in one shard ({shard_len}); use fewer shards")
    pad = shard_len - q.shape[-2]
    if pad:  # the last rank's rows padded to the shard length; the kpos < seq_len mask drops them
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    # one all-gather: each rank's first and last w rows of k and v
    edges = torch.stack([k[..., :w, :], k[..., -w:, :], v[..., :w, :], v[..., -w:, :]])  # (4, B, H, w, D)
    pool = sync_tensor(edges.unsqueeze(0), dim=0, axis=axis, size=size)  # (S, 4, B, H, w, D)
    left, right = pool[(index - 1) % size], pool[(index + 1) % size]
    k_ext = torch.cat([left[1], k, right[0]], dim=-2)
    v_ext = torch.cat([left[3], v, right[2]], dim=-2)
    off = index * shard_len
    qpos = off + torch.arange(shard_len, device=q.device)
    kpos = off - w + torch.arange(shard_len + 2 * w, device=q.device)
    out = _local_attention(q, k_ext, v_ext, qpos, kpos, seq_len, w, dropout_rate,
                           fold_key(dropout_key, index) if dropout_rate > 0.0 else None)
    return out[..., : hi - lo, :] if pad else out

