"""The GNN flavor's edge-MLP convolution over a CSR edge list: the Hopper
kernel, its plain PyTorch version and the autograd Function.

Replaces ``anemoi_models_tpu/ops/pallas/gnn_conv.py:_kernel`` (with its
plain twin ``ops/slot_gnn.py:_slot_gnn_once`` / ``apply_mlp_params``):

    msg = LN(MLP(cat[x_i, x_j, e])) * gamma + beta + e     (per edge)
    agg = sum over each destination's edges of msg         (fp32)

with x_i the destination's row, x_j the source's, and the MLP's Dense
layers, biases and LayerNorm affine cast to the compute dtype. The TPU
kernel's slot layout, slab window and outlier list exist because Mosaic
cannot gather in VMEM; the port runs straight off the destination-sorted
edge list (no cap). Edge features stay in the edge set's own order, which
the graph functions sort by destination, so it is the CSR order.

- The first Dense factors as the TPU kernel computes it, in three fp32
  dots: ``x_i . W0[:, 0:C]`` and ``x_j . W0[:, C:2C]`` are computed once per
  node (:func:`node_products`, with ``b0`` folded into the destination's)
  and gathered per edge, so only ``e . W0[:, 2C:3C]`` and the two C x C
  layers run per edge (6 C^2 operations per edge in place of 10 C^2).
- :func:`gnn_conv_plain` follows the kernel's rounding points: fp32
  accumulation, the activation in fp32 then rounded, LayerNorm statistics
  in fp32 and the normalised value rounded before gamma and beta, ``agg``
  summed from the rounded ``msg``. It takes any MLP depth.
- :func:`gnn_conv` takes it for CPU tensors and, for CUDA tensors, launches
  one of two kernel routes (or raises), chosen by :func:`_gnn_route`:
  ``fused`` (``csrc/gnn_conv.cu``: C in {32, 64, 128, 256} with three Dense
  layers, the TPU kernel's case) runs the per-node pre-pass (the Hopper GEMM
  of ``csrc/gemm_sm90.cuh`` in bf16, the CUDA cores in fp32), then the
  message and aggregation kernels; ``layered`` (``csrc/gnn_conv_layered.cu``:
  every other width and any MLP depth) runs the same pre-pass, then per
  chunk of :data:`LAYERED_CHUNK` edges one GEMM per Dense with the factored
  first layer's gather, the activation and the rounding in its epilogues, a
  LayerNorm row kernel, and the same aggregation; in bf16 its pre-pass and
  Dense GEMMs run on the warp-specialised persistent pipeline of
  ``csrc/gemm_sm90_ws.cuh``. The GEMM's tensor maps
  need 16-byte rows, so a width that is not a multiple of 8 is padded with
  zero columns (activations, edge features, weights, biases and the
  LayerNorm's gamma and beta; a zero column stays zero through every Dense,
  whatever the activation makes of it, since it meets zero weights), the
  LayerNorm's statistics run over the true width and the outputs are sliced
  back. Each call counts one launch of its route in :data:`LAUNCHES`. There
  is no plain route on the card.
- :class:`GNNConv` is the Function GraphConv runs through: its backward
  recomputes through the plain version and differentiates it, as
  ``ops/slot_gnn.py:conv_bwd`` recomputes through ``_slot_gnn_once``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from anemoi_models_tpu_torch.layers.utils import get_activation
from anemoi_models_tpu_torch.ops import cost
from anemoi_models_tpu_torch.ops.edge_attention import _check_launch, _on_cpu, _require, _require_contiguous

__all__ = ["GNNConv", "LAUNCHES", "LAYERED_CHUNK", "aggregate", "gnn_conv", "gnn_conv_plain", "gnn_prepass",
           "mlp_operands", "node_products"]

_FUSED_WIDTHS = (32, 64, 128, 256)  # channel widths csrc/gnn_conv.cu's fused kernels are built for
_DTYPES = (torch.float32, torch.bfloat16)
# act_fn's codes in csrc/gnn_common.cuh: every activation of the reference's registry (layers/utils.py)
_ACT_CODES = {"identity": 0, "silu": 1, "swish": 1, "gelu": 2, "relu": 3, "tanh": 4, "sigmoid": 5, "leakyrelu": 6,
              "elu": 7, "softplus": 8, "mish": 9}
# edge rows per chunk of the layered route: its scratch is two (chunk, C)
# activations in the compute dtype and one in fp32 (512 MiB at C = 1024 in bf16)
LAYERED_CHUNK = 65536

# kernel launches, one per gnn_conv call of each route (the pre-pass, message
# or Dense and LayerNorm kernels, and the aggregation; gnn_prepass alone is
# counted apart); a CPU call runs the plain version and adds nothing
LAUNCHES: dict[str, int] = {"gnn_conv": 0, "gnn_conv_layered": 0, "gnn_prepass": 0}


def _gnn_route(c: int, n_dense: int) -> str:
    """Which kernel route takes a GNN conv of width ``c`` with ``n_dense``
    Dense layers on the card: ``"fused"`` (``csrc/gnn_conv.cu``) for the
    widths it is built for with three Dense layers, ``"layered"``
    (``csrc/gnn_conv_layered.cu``) for every other width and depth, a width
    that is not a multiple of 8 padded to one (:func:`_padded`)."""
    if c <= 0:
        raise ValueError(f"the GNN conv kernels take C > 0, got C={c}")
    if n_dense < 2:
        raise ValueError(f"the GNN conv kernels take at least two Dense layers, got {n_dense}")
    return "fused" if c in _FUSED_WIDTHS and n_dense == 3 else "layered"


def mlp_operands(dense: Sequence[tuple[torch.Tensor, torch.Tensor]], norm: tuple[torch.Tensor, torch.Tensor],
                 dtype: torch.dtype) -> list[torch.Tensor]:
    """The edge MLP as the kernel reads it, differentiably: each Dense
    ``(weight (out, in), bias)`` in ``dtype``, the weight contiguous in
    torch's Linear layout (K-major, as the tensor cores read it), then the
    LayerNorm's ``(gamma, beta)`` in ``dtype``."""
    ops = []
    for w, b in dense:
        ops += [w.to(dtype).contiguous(), b.to(dtype)]
    return ops + [norm[0].to(dtype), norm[1].to(dtype)]


def aggregate(msg: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """(B, Nd, C) fp32: each destination's sum of its CSR row of ``msg``."""
    nd = rowptr.numel() - 1
    dst = torch.repeat_interleave(torch.arange(nd, device=msg.device), rowptr.long().diff())
    agg = torch.zeros(msg.shape[0], nd, msg.shape[-1], dtype=torch.float32, device=msg.device)
    return agg.index_add_(1, dst, msg.float())


def node_products(x_dst: torch.Tensor, x_src: torch.Tensor, w0: torch.Tensor,
                  b0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The first Dense's per-node terms, fp32: ``x_dst . W0[:, 0:C]^T + b0``
    and ``x_src . W0[:, C:2C]^T``, with ``w0`` (C, 3C) as
    :func:`mlp_operands` gives it."""
    c = x_dst.shape[-1]
    return (x_dst.float() @ w0[:, :c].float().t() + b0.float(),
            x_src.float() @ w0[:, c:2 * c].float().t())


def gnn_conv_plain(
    x_dst: torch.Tensor,  # (B, Nd, C) destination rows
    x_src: torch.Tensor,  # (B, Ns, C) source rows (x_dst itself on a self-graph)
    e: torch.Tensor,  # (B, E, C) edge features in CSR order
    rowptr: torch.Tensor,  # (Nd + 1,) int32
    src: torch.Tensor,  # (E,) int32
    ops: Sequence[torch.Tensor],  # mlp_operands(...): w0, b0, ..., gamma, beta
    activation: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(agg (B, Nd, C) fp32, msg (B, E, C) in e's dtype)."""
    dt = e.dtype
    act = get_activation(activation)
    nd = rowptr.numel() - 1
    dst = torch.repeat_interleave(torch.arange(nd, device=e.device), rowptr.long().diff())
    *dense, gamma, beta = ops
    c = e.shape[-1]
    p_dst, p_src = node_products(x_dst, x_src, dense[0], dense[1])
    h = e.float() @ dense[0][:, 2 * c:].float().t() + p_dst[:, dst] + p_src[:, src.long()]
    for i in range(2, len(dense), 2):
        h = act(h).to(dt).float() @ dense[i].float().t() + dense[i + 1].float()
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    hn = ((h - mu) * torch.rsqrt(var + 1e-6)).to(dt)
    msg = hn * gamma + beta + e
    return aggregate(msg, rowptr), msg


def _padded(x_dst: torch.Tensor, x_src: torch.Tensor, e: torch.Tensor, ops: Sequence[torch.Tensor],
            cp: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """The conv's operands at width ``cp`` (a multiple of 8 above C), the new
    columns zero: the rows of x_dst, x_src and e, each Dense's output rows and
    input columns (the first Dense's three C-wide blocks each padded in
    place), its bias, and the LayerNorm's gamma and beta."""
    c = e.shape[-1]
    rows = [torch.nn.functional.pad(t, (0, cp - c)).contiguous() for t in (x_dst, x_src, e)]
    *dense, gamma, beta = ops
    out = []
    for i in range(0, len(dense), 2):
        w, b = dense[i], dense[i + 1]
        blocks = w.shape[1] // c
        wp = torch.zeros((cp, blocks * cp), dtype=w.dtype, device=w.device)
        for k in range(blocks):
            wp[:c, k * cp:k * cp + c] = w[:, k * c:(k + 1) * c]
        out += [wp, torch.nn.functional.pad(b, (0, cp - c))]
    out += [torch.nn.functional.pad(gamma, (0, cp - c)), torch.nn.functional.pad(beta, (0, cp - c))]
    return (*rows, out)


def gnn_conv(
    x_dst: torch.Tensor,
    x_src: torch.Tensor,
    e: torch.Tensor,
    rowptr: torch.Tensor,
    src: torch.Tensor,
    ops: Sequence[torch.Tensor],
    activation: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gnn_conv_plain`'s function; on the card every operand shares
    the compute dtype (fp32 or bf16) and is contiguous."""
    n_dense = (len(ops) - 2) // 2
    fused = e.shape[-1] in _FUSED_WIDTHS and n_dense == 3  # _gnn_route's choice, which the card checks below
    cost.record("gnn_conv" if fused else "gnn_conv_layered", lambda: cost.gnn_conv_flops(
        e.shape[0], src.numel(), rowptr.numel() - 1, x_src.shape[1], e.shape[-1], n_dense))
    if _on_cpu(x_dst, x_src, e, rowptr, src, *ops):
        with cost.plain():
            return gnn_conv_plain(x_dst, x_src, e, rowptr, src, ops, activation)
    code = _ACT_CODES.get(activation.lower())
    if code is None:
        raise NotImplementedError(f"the GNN conv kernels have no activation {activation!r}; they take {sorted(_ACT_CODES)}")
    dt = e.dtype
    _require(dt in _DTYPES, f"compute dtype must be fp32 or bf16, got {dt}")
    _require(all(t.dtype == dt for t in (x_dst, x_src, *ops)), "x_dst, x_src, e and the MLP must share one dtype")
    _require(rowptr.dtype == torch.int32 and src.dtype == torch.int32, "rowptr and src must be int32")
    _require(x_dst.dim() == 3 and x_src.dim() == 3 and e.dim() == 3, "x_dst, x_src, e must be (B, N, C)")
    _require(len(ops) % 2 == 0, f"ops must be (weight, bias) per Dense, then gamma, beta; got {len(ops)} tensors")
    batch, nd, c = x_dst.shape
    ns, num_edges = x_src.shape[1], src.numel()
    *dense, gamma, beta = ops
    n_dense = len(dense) // 2
    route = _gnn_route(c, n_dense)
    _require(nd == rowptr.numel() - 1 and nd > 0 and ns > 0, f"x_dst has {nd} rows for {rowptr.numel() - 1} destinations")
    _require(x_src.shape[0] == batch and x_src.shape[2] == c, f"x_src shape {tuple(x_src.shape)}")
    _require(e.shape == (batch, num_edges, c), f"e shape {tuple(e.shape)} != ({batch}, {num_edges}, {c})")
    weights, biases = dense[0::2], dense[1::2]
    _require(weights[0].shape == (c, 3 * c) and all(w.shape == (c, c) for w in weights[1:]),
             f"weights {[tuple(w.shape) for w in weights]} for C={c} (torch Linear layout)")
    _require(all(t.shape == (c,) for t in (*biases, gamma, beta)), "biases and LayerNorm affine must be (C,)")
    _require_contiguous(x_dst=x_dst, x_src=x_src, e=e, rowptr=rowptr, src=src, gamma=gamma, beta=beta,
                        **{f"dense_{i}": t for i, t in enumerate(dense)})
    c_ln = c  # the LayerNorm's statistics run over the true width
    if c % 8:
        c = c + 8 - c % 8
        x_dst, x_src, e, ops = _padded(x_dst, x_src, e, ops, c)
        *dense, gamma, beta = ops
    _require(all(t.data_ptr() % 16 == 0 for t in (x_dst, x_src, e, *ops)), "rows must be 16-byte aligned")
    msg = torch.empty_like(e)
    agg = torch.empty((batch, nd, c), dtype=torch.float32, device=e.device)
    # the pre-pass's fp32 per-node tables, scratch of this call
    p_dst = torch.empty((batch, nd, c), dtype=torch.float32, device=e.device)
    p_src = torch.empty((batch, ns, c), dtype=torch.float32, device=e.device)
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    suffix = "bf16" if dt == torch.bfloat16 else "f32"
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        if route == "fused":
            rc = getattr(lib, f"gnn_conv_{suffix}")(
                x_dst.data_ptr(), x_src.data_ptr(), e.data_ptr(), rowptr.data_ptr(), src.data_ptr(),
                *(t.data_ptr() for t in ops), p_dst.data_ptr(), p_src.data_ptr(), msg.data_ptr(), agg.data_ptr(),
                batch, nd, ns, num_edges, c, code, stream,
            )
        else:
            # per chunk: two activations in the compute dtype (ping-pong) and the last Dense's fp32 output
            chunk = max(1, min(LAYERED_CHUNK, batch * num_edges))
            h0, h1 = (torch.empty((chunk, c), dtype=dt, device=e.device) for _ in range(2))
            hf = torch.empty((chunk, c), dtype=torch.float32, device=e.device)
            ptrs = (ctypes.c_void_p * len(dense))(*(t.data_ptr() for t in dense))
            rc = getattr(lib, f"gnn_conv_layered_{suffix}")(
                x_dst.data_ptr(), x_src.data_ptr(), e.data_ptr(), rowptr.data_ptr(), src.data_ptr(), ptrs, n_dense,
                gamma.data_ptr(), beta.data_ptr(), p_dst.data_ptr(), p_src.data_ptr(), h0.data_ptr(), h1.data_ptr(),
                hf.data_ptr(), chunk, msg.data_ptr(), agg.data_ptr(), batch, nd, ns, num_edges, c, c_ln, code, stream,
            )
    name = "gnn_conv" if route == "fused" else "gnn_conv_layered"
    _check_launch(rc, name)
    LAUNCHES[name] += 1
    if c != c_ln:
        return agg[..., :c_ln].contiguous(), msg[..., :c_ln].contiguous()
    return agg, msg


def gnn_prepass(x_dst: torch.Tensor, x_src: torch.Tensor, w0: torch.Tensor,
                b0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass that :func:`gnn_conv` launches first, alone, on the card:
    :func:`node_products` of (B, N, C) rows in fp32 or bf16 through
    ``csrc/gnn_conv.cu``'s ``gnn_prepass_*`` (one launch, counted in
    :data:`LAUNCHES`). For timing it apart from the message kernel and for
    holding it against :func:`node_products`; no model path calls it."""
    _require(x_dst.is_cuda, "gnn_prepass runs on the card only; node_products is its plain version")
    dt = x_dst.dtype
    _require(dt in _DTYPES and all(t.dtype == dt for t in (x_src, w0, b0)), "x_dst, x_src, w0, b0 must share fp32|bf16")
    batch, nd, c = x_dst.shape
    _require(c % 8 == 0 and w0.shape == (c, 3 * c) and b0.shape == (c,) and x_src.shape[::2] == (batch, c),
             f"shapes {tuple(x_dst.shape)}, {tuple(x_src.shape)}, {tuple(w0.shape)}")
    _require_contiguous(x_dst=x_dst, x_src=x_src, w0=w0, b0=b0)
    ns = x_src.shape[1]
    p_dst = torch.empty((batch, nd, c), dtype=torch.float32, device=x_dst.device)
    p_src = torch.empty((batch, ns, c), dtype=torch.float32, device=x_dst.device)
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    fn = lib.gnn_prepass_bf16 if dt == torch.bfloat16 else lib.gnn_prepass_f32
    with torch.cuda.device(x_dst.device):
        stream = torch.cuda.current_stream(x_dst.device).cuda_stream
        rc = fn(x_dst.data_ptr(), x_src.data_ptr(), w0.data_ptr(), b0.data_ptr(), p_dst.data_ptr(),
                p_src.data_ptr(), batch * nd, batch * ns, c, stream)
    _check_launch(rc, "gnn_prepass")
    LAUNCHES["gnn_prepass"] += 1
    return p_dst, p_src


class GNNConv(torch.autograd.Function):
    """:func:`gnn_conv` with the edge MLP's parameters as inputs
    (``params``: each Dense's fp32 ``weight``, ``bias``, then the
    LayerNorm's ``weight``, ``bias``); the backward recomputes through
    :func:`gnn_conv_plain`. Returns ``(agg fp32, msg)``."""

    @staticmethod
    def forward(ctx, x_dst, x_src, e, rowptr, src, activation: str, *params):
        ctx.save_for_backward(x_dst, x_src, e, rowptr, src, *params)
        ctx.activation = activation
        return gnn_conv(x_dst, x_src, e, rowptr, src, _operands(params, e.dtype), activation)

    @staticmethod
    def backward(ctx, g_agg, g_msg):
        x_dst, x_src, e, rowptr, src, *params = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x_dst, x_src, e, *params)]
        with torch.enable_grad():
            xd, xs, ee, *ps = leaves
            agg, msg = gnn_conv_plain(xd, xs, ee, rowptr, src, _operands(ps, e.dtype), ctx.activation)
        grads = torch.autograd.grad((agg, msg), leaves, (g_agg, g_msg))
        return (*grads[:3], None, None, None, *grads[3:])


def _operands(params: Sequence[torch.Tensor], dtype: torch.dtype) -> list[torch.Tensor]:
    dense = [(params[i], params[i + 1]) for i in range(0, len(params) - 2, 2)]
    return mlp_operands(dense, (params[-2], params[-1]), dtype)
