"""Sequence-parallel attention over a sequence split by the ``model`` axis.

Counterpart of ``anemoi_models_tpu/ops/ring_attention.py`` and of the JAX
attention layer's resharded path (``layers/attention.py:86-106``). The
sequence (the hidden mesh's rows) is split contiguously over the axis; each
rank holds its query rows and computes its rows of the unsharded output on
the flash kernel, whose query and key offsets place the rows in the whole
sequence (``ops/flash_attention.py``):

- :func:`halo_window_attention`: a query within ``window_size`` positions of
  its keys needs only a +-w halo of k and v from its two neighbours. The JAX
  package sends them with two ``ppermute``s; gloo has no ``send`` for CUDA
  tensors, so here each rank all-gathers every rank's first and last w rows
  of k and v (one all-gather of 4 w rows a rank) and takes its neighbours'.
  The rank's queries then attend ``[left | own | right]`` under the band and
  the ``[0, N)`` mask, a sequence that does not divide the axis padded
  internally, as the JAX function does.
- :func:`gathered_attention`: any other attention (a causal mask, no
  window): k and v of every rank are all-gathered and the rank's queries
  attend the whole sequence. The JAX layer reaches the same function by two
  all-to-alls (sequence-sharded to head-sharded and back); gloo has no
  all-to-all for CUDA tensors.

Both go through :class:`~anemoi_models_tpu_torch.ops.flash_attention.FlashAttention`
(the kernel on the card, the plain version on the CPU; the backward
recomputes through the plain version) and draw attention-weight dropout at
global positions, so a sharded forward drops exactly the unsharded one's
pairs. The JAX package draws per shard, so its pattern depends on the rank
count; neither package's draw matches the other's bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from anemoi_models_tpu_torch.ops.flash_attention import FlashAttention
from anemoi_models_tpu_torch.parallel.api import Mesh
from anemoi_models_tpu_torch.parallel.primitives import sync_tensor

__all__ = ["gathered_attention", "halo_window_attention"]


def _rank_rows(q: torch.Tensor, seq_len: int, mesh: Mesh, axis: str) -> tuple[int, int]:
    lo, hi = mesh.rows(seq_len, axis)
    if q.shape[-2] != hi - lo:
        raise ValueError(f"rank {mesh.coords[axis]} holds rows [{lo}, {hi}) of {seq_len}, got {q.shape[-2]}")
    return lo, hi


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
    attention weights under ``dropout_key``, at global positions."""
    if dropout_rate > 0.0 and dropout_key is None:
        raise ValueError("halo attention dropout_rate > 0 requires a dropout_key")
    size, index = mesh.shape[axis], mesh.coords[axis]
    shard_len = -(-seq_len // size)
    lo, _ = _rank_rows(q, seq_len, mesh, axis)
    w = window_size
    if w > shard_len:
        raise ValueError(f"window ({w}) must fit in one shard ({shard_len}); use fewer shards")
    pad = shard_len - k.shape[-2]
    if pad:  # the last rank's rows padded to the shard length; n_valid = seq_len masks them
        k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    # one all-gather: each rank's first and last w rows of k and v
    edges = torch.stack([k[..., :w, :], k[..., -w:, :], v[..., :w, :], v[..., -w:, :]])  # (4, B, H, w, D)
    pool = sync_tensor(edges.unsqueeze(0), dim=0, axis=axis, size=size)  # (S, 4, B, H, w, D)
    left, right = pool[(index - 1) % size], pool[(index + 1) % size]
    kv_ext = torch.stack([torch.cat([left[1], k, right[0]], dim=-2), torch.cat([left[3], v, right[2]], dim=-2)])
    return FlashAttention.apply(q, kv_ext[0], kv_ext[1], w, False, dropout_rate, dropout_key, lo,
                                index * shard_len - w, seq_len)


def gathered_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: Optional[int],
    is_causal: bool,
    seq_len: int,
    mesh: Mesh,
    axis: str = "model",
    dropout_rate: float = 0.0,
    dropout_key: Optional[int] = None,
) -> torch.Tensor:
    """Attention of this rank's query rows (B, H, n_local, D) of a
    ``seq_len``-long sequence split over ``axis`` against every key: one
    all-gather of the ranks' k and v rows (its adjoint sums the ranks'
    cotangents in fp32 and returns each rank its rows), then the rank's rows
    of the unsharded attention."""
    if dropout_rate > 0.0 and dropout_key is None:
        raise ValueError("attention dropout_rate > 0 requires a dropout_key")
    lo, _ = _rank_rows(q, seq_len, mesh, axis)
    kv = sync_tensor(torch.stack([k, v]), dim=3, axis=axis, size=seq_len)  # (2, B, H, seq_len, D)
    return FlashAttention.apply(q, kv[0], kv[1], window_size, is_causal, dropout_rate, dropout_key, lo, 0, seq_len)
