"""The work a step or a lead needs, from the configuration's shapes and the
graph's edge counts alone: the yardstick of ``mfu.*`` and the roofline
shares, whatever route or recompute the program takes.

The kernel formulas are a frozen copy of the port's ``ops/cost.py`` (the
fewest operations each function needs):

- ``kv_proj``: ``2 M K N`` for the (M, K) x (K, N) product;
- ``edge_attn``: per edge the logit and the weighted sum of v (4 C) and two
  A2 H terms of the factored edge term, per destination two A2 C products:
  ``E (4 C + 4 A2 H) + Nd 4 A2 C``;
- ``edge_attn_bwd``: ``E (10 C + 12 A2 H) + Nd 10 A2 C``;
- ``flash``: ``4 D`` per (query, key) pair inside the band, per head;
  ``flash_bwd``: ``10 D``.

A Dense of (M, K) x (K, N) is ``2 M K N`` forward and twice that backward
(the input's and the weight's gradients). A train step is one forward and
one backward; the recompute of the remat policy is not work the step needs.

The least time of a kernel's call is ``max(FLOPs / peak, bytes / HBM rate)``,
bytes counting each input read once and each output written once (bf16
activations and weights, fp32 partials, gradients and int32 tables, as the
kernels take and give them). Peaks: NVIDIA's data sheet for the H100 SXM
(dense bf16 989 TFLOP/s, HBM3 3.35 TB/s, at 700 W).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16, F32, I32 = 2, 4, 4


def kv_proj_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def edge_attn_flops(batch: int, num_edges: int, nd: int, c: int, heads: int, a2: int) -> int:
    return batch * (num_edges * (4 * c + 4 * a2 * heads) + nd * 4 * a2 * c)


def edge_attn_bwd_flops(batch: int, num_edges: int, nd: int, c: int, heads: int, a2: int) -> int:
    return batch * (num_edges * (10 * c + 12 * a2 * heads) + nd * 10 * a2 * c)


def flash_flops(batch_heads: int, pairs: int, d: int) -> int:
    return 4 * d * pairs * batch_heads


def flash_bwd_flops(batch_heads: int, pairs: int, d: int) -> int:
    return 10 * d * pairs * batch_heads


def band_pairs(n: int, window: int) -> int:
    """(query, key) pairs with |i - j| <= window in a sequence of n."""
    i = np.arange(n, dtype=np.int64)
    return int((np.minimum(i + window, n - 1) - np.maximum(i - window, 0) + 1).sum())


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


@dataclass(frozen=True)
class EdgeSetShape:
    ns: int
    nd: int
    edges: int


@dataclass(frozen=True)
class Shapes:
    """The sizes the work follows: the configuration's and the graph's."""

    flavor: str
    c: int
    heads: int
    layers: int
    mlp: int
    window: int
    n_in: int
    n_out: int
    multistep: int
    trainable: int
    a2: int  # edge attributes + trainable edge features + the bias column
    grid: int
    hidden: int
    enc: EdgeSetShape
    proc: EdgeSetShape
    dec: EdgeSetShape
    batch: int = 1

    @classmethod
    def of(cls, config: dict, graph_sizes: dict, variables, batch: int = 1) -> "Shapes":
        """``graph_sizes``: node counts ``data``, ``hidden``, edge counts
        ``enc``, ``proc``, ``dec`` and ``edge_attr_dim`` (the static
        attributes' width)."""
        g, h = graph_sizes["data"], graph_sizes["hidden"]
        return cls(
            flavor=config["flavor"], c=config["num_channels"], heads=config["num_heads"],
            layers=config["num_layers"], mlp=config["mlp_hidden_ratio"] * config["num_channels"],
            window=config["window_size"] or 0, n_in=len(variables.inputs), n_out=len(variables.outputs),
            multistep=config["multistep_input"], trainable=config["trainable_hidden"],
            a2=graph_sizes["edge_attr_dim"] + config["trainable_edges"] + 1, grid=g, hidden=h,
            enc=EdgeSetShape(g, h, graph_sizes["enc"]), proc=EdgeSetShape(h, h, graph_sizes["proc"]),
            dec=EdgeSetShape(h, g, graph_sizes["dec"]), batch=batch,
        )

    def edge_sets(self) -> list[EdgeSetShape]:
        """The GraphTransformer convolutions of one forward, in order."""
        return [self.enc] + ([self.proc] * self.layers if self.flavor == "graphtransformer" else []) + [self.dec]


def _dense(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def dense_flops(s: Shapes) -> int:
    """The forward's Dense products outside the hand-written kernels."""
    b, c, f = s.batch, s.c, s.mlp
    node_attr = 2 * 2 + s.trainable  # sin/cos of (lat, lon) and the trainable features
    data_in = s.multistep * s.n_in + node_attr

    def gt_dst(nd: int) -> int:
        # [q | r], projection, the MLP; the edge term is the kernels' (factored)
        return b * (_dense(nd, c, 2 * c) + _dense(nd, c, c) + 2 * _dense(nd, c, f))

    total = b * _dense(s.grid, data_in, c) + b * _dense(s.hidden, node_attr, c)  # encoder embeddings
    total += gt_dst(s.hidden)
    total += b * _dense(s.grid, data_in, c)  # decoder's destination embedding
    total += gt_dst(s.grid) + b * _dense(s.grid, c, s.n_out)
    if s.flavor == "graphtransformer":
        total += s.layers * gt_dst(s.hidden)
    else:
        total += s.layers * b * (_dense(s.hidden, c, 3 * c) + _dense(s.hidden, c, c) + 2 * _dense(s.hidden, c, f))
    return total


def edge_calls(s: Shapes, train: bool) -> list[tuple[str, int, int]]:
    """(kernel, FLOPs, bytes) of every call of ``kv_proj``, ``edge_attn_csr``
    and, for a train step, ``edge_attn_csr_bwd``, that one forward (and one
    backward) needs."""
    b, c, h, a2 = s.batch, s.c, s.heads, s.a2
    out = []
    for es in s.edge_sets():
        ns, nd, e = es.ns, es.nd, es.edges
        out.append(("kv_proj", kv_proj_flops(b * ns, c, 2 * c),
                    BF16 * (b * ns * c + 2 * c * c + b * ns * 2 * c) + F32 * 2 * c))
        shared = BF16 * (b * nd * c + b * ns * 2 * c + e * a2 + a2 * c) + I32 * (nd + 1 + e)
        out.append(("edge_attn_csr", edge_attn_flops(b, e, nd, c, h, a2),
                    shared + F32 * b * nd * (c + 2 * h)))
        if train:
            transposed = I32 * (3 * e + ns + 1)
            cotangents = F32 * b * nd * (2 * h + c)  # m, g_den, g_num
            grads = F32 * (b * nd * c + b * ns * 2 * c + e * a2 + a2 * c)
            out.append(("edge_attn_csr_bwd", edge_attn_bwd_flops(b, e, nd, c, h, a2),
                        shared + transposed + cotangents + grads))
    return out


def flash_calls(s: Shapes, train: bool) -> list[tuple[str, int, int]]:
    """(kernel, FLOPs, bytes) of every band-attention call one forward (and
    one backward) needs: none for the GraphTransformer."""
    if s.flavor != "transformer":
        return []
    b, n, c, h = s.batch, s.hidden, s.c, s.heads
    pairs = band_pairs(n, s.window)
    fwd = ("flash_attention", flash_flops(b * h, pairs, c // h), BF16 * 4 * b * n * c + F32 * b * h * n)
    bwd = ("flash_attention_bwd", flash_bwd_flops(b * h, pairs, c // h), BF16 * 8 * b * n * c + F32 * b * h * n)
    return [fwd, bwd] * s.layers if train else [fwd] * s.layers


def model_flops(s: Shapes, train: bool) -> int:
    """The FLOPs of one forward (and for a train step, its backward)."""
    dense = dense_flops(s) * (3 if train else 1)
    kv_bwd = sum(2 * f for name, f, _ in edge_calls(s, False) if name == "kv_proj") if train else 0
    kernels = sum(f for _, f, _ in edge_calls(s, train) + flash_calls(s, train))
    return dense + kv_bwd + kernels


def least_time_s(calls: list[tuple[str, int, int]]) -> float:
    return sum(least_s(f, nb) for _, f, nb in calls)
