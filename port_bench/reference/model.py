"""Plain PyTorch reference of the AIFS encoder-processor-decoder.

Written from the published description of anemoi-models' GraphTransformer
and Transformer models (``models/encoder_processor_decoder.py``,
``layers/mapper.py``, ``layers/block.py``, ``layers/processor.py``), with no
kernel, cache or code of the program under test. It takes the weights by
the names of the model's state dict, the inputs, and the graph as the node
coordinates and edge lists of its file, and derives everything else itself:
node attributes, edge attributes, the edge lists by destination, edge
features.

- Node attributes: ``[sin(lat), sin(lon), cos(lat), cos(lon)]`` and the
  node set's trainable tensor.
- Edge attributes: ``edge_length``, the great-circle angle between the two
  ends over the edge set's largest; ``edge_dirs``, the unit vector of
  ``(dlat, dlon cos(mid latitude))`` from source to destination, ``dlon``
  wrapped to [-pi, pi) (0 where the ends coincide).
- GraphTransformer block (mapper or processor): ``q, r = W_q LN(x_dst)``;
  ``k, v = W_kv LN(x_src)``; per edge ``e = W_e [attr, trainable]``;
  per head ``alpha = softmax over the destination's edges of q . (k + e) /
  sqrt(d)``, ``out = sum alpha (v + e)``; ``y = W_p (out + r) + x_dst``;
  ``y + W_2 gelu(W_1 LN(y))``. The encoder embeds its source rows before the
  source LayerNorm; the decoder ends in ``W LN(y)`` to the outputs.
- Transformer block: ``x + W_p attn(W_qkv LN(x))`` with each query seeing
  the keys within ``window`` positions on either side; then the MLP.
- Model: ``out = decoder(processor(encoder(x)) + encoder(x), x)`` plus the
  prognostic inputs of the last step.

GELU is the tanh form and the LayerNorms' epsilon 1e-6, as in the JAX
models the port follows. Everything runs in float32 with TF32 off
(:func:`strict_fp32`). With ``fp8=True`` every product's operands are
rounded to float8 (e4m3 forward, e5m2 for the gradients, per-tensor scale):
the control, one precision below the configuration's bfloat16.

It works in blocks of destination rows (and, for the Transformer, of
queries) so that the per-edge tensors of a 4-million-edge encoder fit, and
under ``torch.utils.checkpoint`` when gradients are recorded, so a training
step holds a block's activations only while it runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_EPS = 1e-6
_EDGES_PER_BLOCK = 1 << 18
_ROWS_PER_BLOCK = 1 << 15
_QUERIES_PER_BLOCK = 1024


def strict_fp32() -> None:
    """float32 products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


@dataclass
class Precision:
    fp8: bool = False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.linear(self.q(x), self.q(w), b)


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, _EPS)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _run(fn: Callable, *args):
    """``fn(*args)``, under a checkpoint when gradients are recorded (the
    tensors ``fn`` reads from its closure get theirs too)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def edge_attributes(src: np.ndarray, dst: np.ndarray, index: np.ndarray) -> dict[str, np.ndarray]:
    """``edge_length`` (E, 1) and ``edge_dirs`` (E, 2) of the edges
    ``index`` (2, E) between nodes at (lat, lon) radians ``src`` and ``dst``."""
    a, b = src[index[0]], dst[index[1]]
    dlat = b[:, 0] - a[:, 0]
    dlon = np.remainder(b[:, 1] - a[:, 1] + np.pi, 2 * np.pi) - np.pi
    hav = np.sin(dlat / 2) ** 2 + np.cos(a[:, 0]) * np.cos(b[:, 0]) * np.sin(dlon / 2) ** 2
    angle = 2.0 * np.arcsin(np.sqrt(np.clip(hav, 0.0, 1.0)))
    length = angle / max(float(angle.max()), 1e-12) if len(angle) else angle
    dirs = np.stack([dlat, dlon * np.cos(0.5 * (a[:, 0] + b[:, 0]))], axis=-1)
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = np.divide(dirs, norm, out=np.zeros_like(dirs), where=norm > 1e-12)
    return {"edge_length": length[:, None].astype(np.float32), "edge_dirs": dirs.astype(np.float32)}


class EdgeSet:
    """One edge set from the graph's edge list, sorted by destination:
    sources, each destination's range, and the static attributes."""

    def __init__(self, arrays: dict, src: str, dst: str, num_dst: int, attributes: list[str], device) -> None:
        base = f"edge::{src}::to::{dst}"
        index = np.asarray(arrays[f"{base}::edge_index"], np.int64)
        coords = [np.asarray(arrays[f"node::{n}::coords"], np.float64) for n in (src, dst)]
        derived = edge_attributes(*coords, index)
        order = np.argsort(index[1], kind="stable")
        self.order = torch.as_tensor(order, device=device)
        self.src = torch.as_tensor(index[0][order], device=device)
        dst_sorted = index[1][order]
        ptr = np.zeros(num_dst + 1, np.int64)
        np.add.at(ptr, dst_sorted + 1, 1)
        self.ptr = np.cumsum(ptr)
        self.dst = torch.as_tensor(dst_sorted, device=device)
        attrs = [derived[a].reshape(len(order), -1) for a in attributes]
        self.attr = torch.as_tensor(np.concatenate(attrs, axis=1)[order], device=device)
        self.num_dst = num_dst

    def blocks(self, rows_cap: int = _ROWS_PER_BLOCK) -> list[tuple[int, int]]:
        """Destination ranges of at most ``_EDGES_PER_BLOCK`` edges (or one
        destination) and ``rows_cap`` rows."""
        out, lo = [], 0
        while lo < self.num_dst:
            hi = int(np.searchsorted(self.ptr, self.ptr[lo] + _EDGES_PER_BLOCK, side="right")) - 1
            hi = min(max(hi, lo + 1), lo + rows_cap, self.num_dst)
            out.append((lo, hi))
            lo = hi
        return out


def _edge_attention(p: Precision, q, k, v, e, dst_local, nd: int, heads: int):
    """Softmax over each destination's edges, per head: q (nd, C); k, v, e
    (edges, C); dst_local (edges,) in [0, nd). Returns (nd, C)."""
    c = q.shape[-1]
    d = c // heads
    qe = p.q(q).view(nd, heads, d)[dst_local]
    logit = (qe * p.q(k + e).view(-1, heads, d)).sum(-1) / math.sqrt(d)
    top = torch.full((nd, heads), -torch.inf, device=q.device).scatter_reduce(
        0, dst_local[:, None].expand(-1, heads), logit.detach(), "amax")
    w = torch.exp(logit - top[dst_local])
    den = torch.zeros((nd, heads), device=q.device).index_add(0, dst_local, w)
    num = torch.zeros((nd, heads, d), device=q.device).index_add(0, dst_local, w[..., None] * p.q(v + e).view(-1, heads, d))
    return (num / den[..., None]).reshape(nd, c)


class Reference:
    """The reference model of one configuration over one graph."""

    def __init__(self, config: dict, arrays: dict, variables, device, fp8: bool = False) -> None:
        self.cfg = config
        self.p = Precision(fp8)
        self.c = config["num_channels"]
        self.heads = config["num_heads"]
        self.layers = config["num_layers"]
        self.flavor = config["flavor"]
        self.window = config["window_size"]
        attrs = config["edge_attributes"]
        coords = {name: np.asarray(arrays[f"node::{name}::coords"], np.float64) for name in ("data", "hidden")}
        self.num = {name: len(c) for name, c in coords.items()}
        self.sincos = {name: torch.as_tensor(np.concatenate([np.sin(c), np.cos(c)], axis=-1), dtype=torch.float32,
                                             device=device) for name, c in coords.items()}
        self.enc = EdgeSet(arrays, "data", "hidden", self.num["hidden"], attrs, device)
        self.dec = EdgeSet(arrays, "hidden", "data", self.num["data"], attrs, device)
        self.proc = (EdgeSet(arrays, "hidden", "hidden", self.num["hidden"], attrs, device)
                     if self.flavor == "graphtransformer" else None)
        self.prog_in = torch.as_tensor(variables.prog_in, device=device)
        self.prog_out = torch.as_tensor(variables.prog_out, device=device)

    # -- GraphTransformer pieces -----------------------------------------
    def _kv(self, w, pre: str, feats_fn: Callable, n_rows: int):
        """W_kv LN1(feats(rows)) over every source row, in row blocks."""
        def block(lo, hi):
            def fn():
                f = feats_fn(lo, hi)
                return self.p.linear(_ln(f, w[f"{pre}layer_norm1.weight"], w[f"{pre}layer_norm1.bias"]),
                                     w[f"{pre}lin_kv.weight"], w[f"{pre}lin_kv.bias"])
            return _run(fn)
        return torch.cat([block(lo, min(lo + _ROWS_PER_BLOCK, n_rows)) for lo in range(0, n_rows, _ROWS_PER_BLOCK)])

    def _gt_rows(self, w, pre: str, edges: EdgeSet, trainable, kv, x_dst_fn: Callable, lo: int, hi: int,
                 mapper: bool, finish: Optional[Callable] = None):
        """The block's destination rows [lo, hi): attention over their edges,
        projection with the skip, the MLP; ``finish`` after it."""
        c, h = self.c, self.heads
        e0, e1 = int(edges.ptr[lo]), int(edges.ptr[hi])
        src = edges.src[e0:e1]
        dst_local = edges.dst[e0:e1] - lo
        attr = torch.cat([edges.attr[e0:e1], trainable[edges.order[e0:e1]]], dim=-1)
        x_dst = x_dst_fn(lo, hi)
        ln = "layer_norm2" if mapper else "layer_norm1"
        q_name = "lin_qs" if mapper else "lin_qr"
        q, r = self.p.linear(_ln(x_dst, w[f"{pre}{ln}.weight"], w[f"{pre}{ln}.bias"]),
                             w[f"{pre}{q_name}.weight"], w[f"{pre}{q_name}.bias"]).chunk(2, dim=-1)
        e = self.p.linear(attr, w[f"{pre}lin_edge.weight"], w[f"{pre}lin_edge.bias"])
        kv_e = kv[src]
        out = _edge_attention(self.p, q, kv_e[:, :c], kv_e[:, c:], e, dst_local, hi - lo, h)
        y = self.p.linear(out + r, w[f"{pre}projection.weight"], w[f"{pre}projection.bias"]) + x_dst
        m = f"{pre}node_dst_mlp."
        hdn = _gelu(self.p.linear(_ln(y, w[m + "norm.weight"], w[m + "norm.bias"]), w[m + "fc1.weight"],
                                  w[m + "fc1.bias"]))
        y = y + self.p.linear(hdn, w[m + "fc2.weight"], w[m + "fc2.bias"])
        return y if finish is None else finish(y)

    def _gt_layer(self, w, pre, edges, trainable, kv, x_dst_fn, mapper, finish=None, rows_cap=_ROWS_PER_BLOCK):
        outs = []
        for lo, hi in edges.blocks(rows_cap):
            def fn(kv_, lo=lo, hi=hi):
                return self._gt_rows(w, pre, edges, trainable, kv_, x_dst_fn, lo, hi, mapper, finish)
            outs.append(_run(fn, kv))
        return torch.cat(outs)

    # -- Transformer pieces ----------------------------------------------
    def _band_attention(self, q, k, v):
        """(N, H, d) each; query i sees keys j with |i - j| <= window."""
        n, h, d = q.shape
        wd = self.window
        outs = []
        for q0 in range(0, n, _QUERIES_PER_BLOCK):
            q1 = min(q0 + _QUERIES_PER_BLOCK, n)
            k0, k1 = max(q0 - wd, 0), min(q1 + wd, n)

            def fn(qb, kb, vb, q0=q0, q1=q1, k0=k0, k1=k1):
                s = torch.einsum("qhd,khd->hqk", self.p.q(qb), self.p.q(kb)) / math.sqrt(d)
                qi = torch.arange(q0, q1, device=q.device)[:, None]
                kj = torch.arange(k0, k1, device=q.device)[None, :]
                s = s.masked_fill((qi - kj).abs() > wd, -torch.inf)
                a = torch.softmax(s, dim=-1)
                return torch.einsum("hqk,khd->qhd", self.p.q(a), self.p.q(vb))
            outs.append(_run(fn, q[q0:q1], k[k0:k1], v[k0:k1]))
        return torch.cat(outs).reshape(n, h * d)

    def _transformer_layer(self, w, pre, x):
        n, c = x.shape
        h = self.heads
        qkv = self.p.linear(_ln(x, w[pre + "layer_norm1.weight"], w[pre + "layer_norm1.bias"]),
                            w[pre + "attention.lin_qkv.weight"]).view(n, 3, h, c // h)
        att = self._band_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2])
        x = x + self.p.linear(att, w[pre + "attention.projection.weight"], w[pre + "attention.projection.bias"])
        hdn = _gelu(self.p.linear(_ln(x, w[pre + "layer_norm2.weight"], w[pre + "layer_norm2.bias"]),
                                  w[pre + "fc1.weight"], w[pre + "fc1.bias"]))
        return x + self.p.linear(hdn, w[pre + "fc2.weight"], w[pre + "fc2.bias"])

    # -- the model -------------------------------------------------------
    def forward(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        """x (1, multistep, 1, grid, n_in) normalised -> (1, 1, grid, n_out)."""
        g = self.num["data"]
        x_flat = x[0, :, 0].permute(1, 0, 2).reshape(g, -1)
        data_latent = torch.cat([x_flat, self.sincos["data"], w["node_attributes.trainable.data"]], dim=-1)
        hidden_in = torch.cat([self.sincos["hidden"], w["node_attributes.trainable.hidden"]], dim=-1)

        # encoder: data -> hidden
        def enc_src(lo, hi):
            return self.p.linear(data_latent[lo:hi], w["encoder.emb_nodes_src.weight"], w["encoder.emb_nodes_src.bias"])
        kv = self._kv(w, "encoder.proc.", enc_src, g)
        hidden = self.p.linear(hidden_in, w["encoder.emb_nodes_dst.weight"], w["encoder.emb_nodes_dst.bias"])
        latent = self._gt_layer(w, "encoder.proc.", self.enc, w["encoder.trainable.trainable"], kv,
                                lambda lo, hi: hidden[lo:hi], mapper=True)

        # processor
        xp = latent
        per_chunk = self.layers // self.cfg["num_chunks"]
        for layer in range(self.layers):
            pre = f"processor.proc.{layer // per_chunk}.blocks.{layer % per_chunk}."
            if self.flavor == "graphtransformer":
                xp = self._gt_processor_layer(w, pre, xp)
            else:
                xp = _run(lambda x_, pre=pre: self._transformer_layer(w, pre, x_), xp)
        latent = xp + latent

        # decoder: hidden -> data, then the outputs
        kv = self._kv(w, "decoder.proc.", lambda lo, hi: latent[lo:hi], self.num["hidden"])

        def dec_dst(lo, hi):
            return self.p.linear(data_latent[lo:hi], w["decoder.emb_nodes_dst.weight"], w["decoder.emb_nodes_dst.bias"])

        def extract(y):
            y = _ln(y, w["decoder.node_data_extractor_norm.weight"], w["decoder.node_data_extractor_norm.bias"])
            return self.p.linear(y, w["decoder.node_data_extractor.weight"], w["decoder.node_data_extractor.bias"])
        out = self._gt_layer(w, "decoder.proc.", self.dec, w["decoder.trainable.trainable"], kv, dec_dst,
                             mapper=True, finish=extract)
        out = out.index_add(-1, self.prog_out, x[0, -1, 0].index_select(-1, self.prog_in))
        return out[None, None]

    def _gt_processor_layer(self, w, pre, x):
        def kv_fn(x_):
            xn = _ln(x_, w[pre + "layer_norm1.weight"], w[pre + "layer_norm1.bias"])
            return self.p.linear(xn, w[pre + "lin_kv.weight"], w[pre + "lin_kv.bias"])
        kv = _run(kv_fn, x)
        return self._gt_layer(w, pre, self.proc, w["processor.trainable.trainable"], kv,
                              lambda lo, hi: x[lo:hi], mapper=False)
