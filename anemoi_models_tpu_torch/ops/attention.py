"""Scaled-dot-product attention with an optional sliding window.

Counterpart of ``anemoi_models_tpu/ops/attention.py:dot_product_attention``.
The JAX package picks among a plain einsum version, a chunked version and the
Pallas kernel with ``impl`` (any other name, ``"flash"`` among them, takes
the einsum version); all compute one function. The port has one path for
every ``impl``: :class:`~anemoi_models_tpu_torch.ops.flash_attention.FlashAttention`,
which runs the hand-written kernel on a CUDA tensor and the plain blockwise
version on a CPU tensor. Attention-weight dropout runs inside the kernel,
keyed by ``dropout_key`` (``ops/flash_attention.py``); the JAX package draws
it with ``jax.random`` on its chunked path, so the two packages drop
different pairs at the same rate.
"""

from __future__ import annotations

from typing import Optional

import torch

from anemoi_models_tpu_torch.ops.flash_attention import FlashAttention

__all__ = ["dot_product_attention"]

IMPLS = ("auto", "pallas", "chunked", "reference", "flash")


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    window_size: Optional[int] = None,
    is_causal: bool = False,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    dropout_key: Optional[int] = None,
) -> torch.Tensor:
    """Attention over (batch, heads, seq, head_dim) tensors; ``window_size``
    is the half-width of the window (query i attends keys within +-w);
    ``dropout_rate`` > 0 drops attention weights under ``dropout_key``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if dropout_rate > 0.0 and dropout_key is None:
        raise ValueError("attention dropout_rate > 0 requires a dropout_key")
    return FlashAttention.apply(query, key, value, window_size, is_causal, dropout_rate, dropout_key)
