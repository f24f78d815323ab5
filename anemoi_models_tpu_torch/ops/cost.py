"""The operations a call executes: the hand-written kernels' formulas, the
card's peak rates, and a counter of one call's FLOPs.

The count is a stated model of what the card executes, recompute included,
in two parts:

- the aten operations that ``torch.utils.flop_counter`` has a formula for
  (the matrix products, attention and convolutions of ``FlopCounterMode``'s
  registry), seen by :class:`FlopCount`, a dispatch mode: cuBLAS's products;
- each hand-written kernel's calls times its formula below, recorded by the
  kernel's wrapper where it chooses its route (:func:`record`). The
  kernels run through ctypes, so the dispatch mode never sees them; on the
  CPU the wrapper runs the kernel's plain version under :func:`plain`,
  which hides it from the counter, so one call counts the same on the CPU
  route and on the card.

The formulas are the fewest operations each function needs (the FLOP side
of a kernel's bound):

- ``kv_proj``: ``2 M K N`` for the (M, K) x (K, N) product;
- ``edge_attn_csr``: per edge the logit and the weighted sum of v (4 C) and
  two A2 H terms of the factored edge term, per destination two A2 C
  products: ``E (4 C + 4 A2 H) + Nd 4 A2 C``;
- ``edge_attn_csr_bwd``: per edge the logit, <g_num, v>, dq, dk and dv
  (10 C) and six A2 H terms, per destination five A2 C products:
  ``E (10 C + 12 A2 H) + Nd 10 A2 C``;
- ``gnn_conv`` (both routes): the first Dense factored per node (2 C^2 for
  each destination and each source row), 2 C^2 per edge for each Dense;
- ``gnn_conv_bwd``: the forward recomputed (``gnn_conv``'s count), then per
  edge and Dense the weight gradient and the input gradient (4 C^2), per node
  the first Dense's input and weight gradients (4 C^2 for each destination
  and each source row): three times the forward's count;
- ``flash_attention``: ``4 D`` per (query, key) pair inside the mask, per
  head;
- ``flash_attention_bwd``: per pair and head the logit recomputed, dO . v,
  dV, dQ and dK (``10 D``), 2.5 times the forward's count;

each times the batch. Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "FlopCount",
    "HBM_BPS",
    "PEAK_FLOPS",
    "card_peaks",
    "edge_attn_bwd_flops",
    "edge_attn_flops",
    "flash_bwd_flops",
    "flash_flops",
    "gnn_conv_bwd_flops",
    "gnn_conv_flops",
    "kv_proj_flops",
    "plain",
    "record",
]

# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, FLOP/s by operand type
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16 tensor": 989e12, "fp32": 67e12}
# the cards whose peaks are known, by a part of torch.cuda.get_device_name()
_CARDS = {"H100 80GB HBM3": PEAK_FLOPS, "H100 SXM": PEAK_FLOPS}


def card_peaks(name: str) -> Optional[dict]:
    """The peak FLOP/s by operand type of the card named ``name``, or None
    for a card not in the table."""
    return next((peaks for key, peaks in _CARDS.items() if key in name), None)


def kv_proj_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def edge_attn_flops(batch: int, num_edges: int, nd: int, c: int, heads: int, a2: int) -> int:
    return batch * (num_edges * (4 * c + 4 * a2 * heads) + nd * 4 * a2 * c)


def edge_attn_bwd_flops(batch: int, num_edges: int, nd: int, c: int, heads: int, a2: int) -> int:
    return batch * (num_edges * (10 * c + 12 * a2 * heads) + nd * 10 * a2 * c)


def gnn_conv_flops(batch: int, num_edges: int, nd: int, ns: int, c: int, n_dense: int) -> int:
    return batch * (2 * c * c * (nd + ns) + 2 * c * c * n_dense * num_edges)


def gnn_conv_bwd_flops(batch: int, num_edges: int, nd: int, ns: int, c: int, n_dense: int) -> int:
    return 3 * gnn_conv_flops(batch, num_edges, nd, ns, c, n_dense)


def flash_flops(batch_heads: int, pairs: int, d: int) -> int:
    return 4 * d * pairs * batch_heads


def flash_bwd_flops(batch_heads: int, pairs: int, d: int) -> int:
    return 10 * d * pairs * batch_heads


# the counters open now, innermost last, and how deep the plain versions hiding from them are nested
_ACTIVE: list["FlopCount"] = []
_HIDDEN = [0]


def record(name: str, flops: Callable[[], int]) -> None:
    """One call of kernel ``name`` (or of its plain version on the CPU):
    adds a launch and ``flops()`` to every open :class:`FlopCount`.
    ``flops`` is called only while one is open."""
    if _ACTIVE:
        n = flops()
        for counter in _ACTIVE:
            launches, total = counter.kernels.get(name, (0, 0))
            counter.kernels[name] = (launches + 1, total + n)


@contextlib.contextmanager
def plain():
    """Hide the aten operations inside from every :class:`FlopCount`: a
    kernel's plain version, whose work :func:`record` has counted."""
    _HIDDEN[0] += 1
    try:
        yield
    finally:
        _HIDDEN[0] -= 1


class FlopCount(TorchDispatchMode):
    """Counts the FLOPs of what runs inside it: ``aten`` (the aten
    operations ``torch.utils.flop_counter`` has a formula for, outside
    :func:`plain`) and ``kernels`` (name -> (calls, FLOPs), from
    :func:`record`). The autograd engine carries the mode into the backward,
    so a train step counts its backward and its recompute."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.aten = 0
        self.kernels: dict[str, tuple[int, int]] = {}

    @property
    def total(self) -> int:
        return self.aten + sum(flops for _, flops in self.kernels.values())

    def __enter__(self) -> "FlopCount":
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self._registry.get(func._overloadpacket)
        if formula is not None and not _HIDDEN[0]:
            self.aten += int(formula(*args, **kwargs, out_val=out))
        return out
