"""Segment ops over destination-sorted edges, in plain PyTorch.

Counterpart of ``anemoi_models_tpu/ops/segment.py``. ``data`` is (..., E, C)
with ``segment_ids`` (E,) shared over the leading axes. These are the plain
reductions the CPU version of the edge-attention kernel is built from; on the
card the kernel (``ops/edge_attention.py``) replaces them.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum", "segment_max", "segment_softmax", "gather_nodes"]


def gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather node features per edge: x (B, N, C), idx (E,) -> (B, E, C)."""
    return x.index_select(-2, idx.long())


def _expand(segment_ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(E,) ids -> the (..., E, C) index shape of ``data``."""
    shape = [1] * data.ndim
    shape[-2] = -1
    return segment_ids.long().view(shape).expand_as(data)


def _zeros_like_segments(data: torch.Tensor, num_segments: int, fill: float) -> torch.Tensor:
    shape = (*data.shape[:-2], num_segments, data.shape[-1])
    return torch.full(shape, fill, dtype=data.dtype, device=data.device)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum ``data`` (..., E, C) into segments (..., num_segments, C)."""
    out = _zeros_like_segments(data, num_segments, 0.0)
    return out.scatter_add_(-2, _expand(segment_ids, data), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Max over segments; empty segments get -inf."""
    out = _zeros_like_segments(data, num_segments, float("-inf"))
    return out.scatter_reduce_(-2, _expand(segment_ids, data), data, reduce="amax")


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Softmax over edges sharing a destination; ``scores`` (..., E, H).
    Accumulates in fp32 and returns the input dtype."""
    scores32 = scores.float()
    seg_max = segment_max(scores32, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ids = segment_ids.long()
    exp = torch.exp(scores32 - seg_max.index_select(-2, ids))
    denom = segment_sum(exp, segment_ids, num_segments).index_select(-2, ids)
    return (exp / denom.clamp_min(1e-16)).to(scores.dtype)
