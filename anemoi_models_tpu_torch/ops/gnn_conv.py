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
- :func:`gnn_conv_bwd` is the backward (``csrc/gnn_conv_bwd.cu``, every
  width, depth and activation): per chunk of :data:`LAYERED_CHUNK` edge rows
  it recomputes the edge MLP from a rerun of the pre-pass, runs the
  LayerNorm's backward and the input-gradient chain from the last Dense to
  the first (in bf16 at the widths of ``_CHAIN_WIDTHS`` one fused kernel per
  64 edge rows, :func:`_bwd_route`; else a launch per product), then every
  Dense's weight gradient in one grouped launch that reads the chunk as it
  lies (no transposed copy), and sums the first Dense's per-edge gradient
  per destination and, over the transposed CSR, per source, then the first
  Dense's per-node products (the JAX package leaves every product of this
  backward to XLA). :func:`gnn_conv_bwd_plain` is its plain version: an
  explicit backward at the kernel's rounding points.
- :class:`GNNConv` is the Function GraphConv runs through: :func:`gnn_conv`
  forward, :func:`gnn_conv_bwd` backward (the JAX package's
  ``ops/slot_gnn.py:conv_bwd`` differentiates its plain twin instead).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from anemoi_models_tpu_torch.layers.utils import get_activation
from anemoi_models_tpu_torch.ops import cost
from anemoi_models_tpu_torch.ops.edge_attention import (
    CSRTranspose,
    _check_launch,
    _on_cpu,
    _require,
    _require_contiguous,
    csr_transpose,
)

__all__ = ["GNNConv", "LAUNCHES", "LAYERED_CHUNK", "act_grad", "aggregate", "gnn_conv", "gnn_conv_bwd",
           "gnn_conv_bwd_plain", "gnn_conv_plain", "gnn_prepass", "mlp_operands", "node_products"]

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
LAUNCHES: dict[str, int] = {"gnn_conv": 0, "gnn_conv_layered": 0, "gnn_prepass": 0, "gnn_conv_bwd": 0}
# the backward's fixed splits (a function of the shape alone, so every card sums in one order): the edge
# rows of a chunk each column-sum partial covers (a LayerNorm-backward CTA, a fused-chain CTA, a consumer
# warpgroup of the bf16 input gradients, a transpose tile of the fp32 route), and the CTAs the weight
# gradients' K split aims at (every Dense of a chunk in one launch on the bf16 route)
_BWD_ROWS = 64
_DW_CTAS = 128
# the fused backward chain (csrc/gnn_conv_bwd.cu:gnn_bwd_chain_kernel): the widths it is built for, its most
# Dense layers, and the shared memory a block may have
_CHAIN_WIDTHS = (32, 64, 128, 256)
_CHAIN_MAX_DENSE = 4
_SMEM_LIMIT = 232448
_BWD_MAX_DENSE = 14  # csrc/gnn_conv_bwd.cu: its grouped launches and sums take at most 14 Dense


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


def act_grad(activation: str, z: torch.Tensor) -> torch.Tensor:
    """d act(z) / dz of each activation of :data:`_ACT_CODES`, fp32, as
    torch's autograd takes it (ReLU' = 0 and LeakyReLU' = 0.01 at 0, GELU
    in its tanh form)."""
    name = activation.lower()
    if name in ("silu", "swish"):
        s = torch.sigmoid(z)
        return s * (1 + z * (1 - s))
    if name == "gelu":
        k = math.sqrt(2 / math.pi)
        t = torch.tanh(k * (z + 0.044715 * z ** 3))
        return 0.5 * (1 + t) + 0.5 * z * (1 - t * t) * k * (1 + 3 * 0.044715 * z * z)
    if name == "relu":
        return (z > 0).to(z.dtype)
    if name == "leakyrelu":
        return torch.where(z > 0, 1.0, 0.01)
    if name == "tanh":
        return 1 - torch.tanh(z) ** 2
    if name == "sigmoid":
        s = torch.sigmoid(z)
        return s * (1 - s)
    if name == "elu":
        return torch.where(z > 0, 1.0, torch.exp(z))
    if name == "softplus":
        return torch.sigmoid(z)
    if name == "mish":
        t = torch.tanh(torch.nn.functional.softplus(z))
        return t + z * torch.sigmoid(z) * (1 - t * t)
    if name == "identity":
        return torch.ones_like(z)
    raise NotImplementedError(f"no derivative for activation {activation!r}; known: {sorted(_ACT_CODES)}")


def gnn_conv_bwd_plain(
    x_dst: torch.Tensor,
    x_src: torch.Tensor,
    e: torch.Tensor,
    rowptr: torch.Tensor,
    src: torch.Tensor,
    ops: Sequence[torch.Tensor],
    activation: str,
    g_agg: torch.Tensor,  # (B, Nd, C) fp32 cotangent of agg
    g_msg: torch.Tensor,  # (B, E, C) cotangent of msg
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """The backward of :func:`gnn_conv_plain`, written out: ``(dx_dst,
    dx_src, de, dops)`` in fp32, ``dops`` one gradient per operand of
    ``ops``. It rounds where ``csrc/gnn_conv_bwd.cu`` rounds: the
    recomputed activations to the compute dtype (the forward's points), the
    gradient of each Dense's output to the compute dtype before its products
    (a tensor-core operand), and the per-node sums of the first Dense's
    gradient to it before the node-level products; every product and sum in
    fp32. The roundings are straight-through: the gradient passes a
    rounding unchanged."""
    dt = e.dtype
    act = get_activation(activation)
    nd = rowptr.numel() - 1
    dst = torch.repeat_interleave(torch.arange(nd, device=e.device), rowptr.long().diff())
    srcl = src.long()
    *dense, gamma, beta = ops
    n_dense = len(dense) // 2
    b, _, c = e.shape
    w0c = dense[0][:, 2 * c:]
    p_dst, p_src = node_products(x_dst, x_src, dense[0], dense[1])
    h = e.float() @ w0c.float().t() + p_dst[:, dst] + p_src[:, srcl]
    zs, acts = [], []
    for i in range(1, n_dense):
        zs.append(h)
        acts.append(act(h).to(dt))
        h = acts[-1].float() @ dense[2 * i].float().t() + dense[2 * i + 1].float()
    mu = h.mean(-1, keepdim=True)
    rs = torch.rsqrt(((h - mu) ** 2).mean(-1, keepdim=True) + 1e-6)
    xhat = (h - mu) * rs
    dmsg = g_msg.float() + g_agg.float()[:, dst]
    dgamma = (dmsg * xhat.to(dt).float()).sum((0, 1))
    dbeta = dmsg.sum((0, 1))
    dy = dmsg * gamma.float()
    dh = (rs * (dy - dy.mean(-1, keepdim=True) - xhat * (dy * xhat).mean(-1, keepdim=True))).to(dt)
    grads: list[torch.Tensor] = [None] * (2 * n_dense)
    for i in range(n_dense - 1, 0, -1):
        dhf = dh.float().reshape(-1, c)
        grads[2 * i] = dhf.t() @ acts[i - 1].float().reshape(-1, c)
        grads[2 * i + 1] = dhf.sum(0)
        dh = ((dh.float() @ dense[2 * i].float()) * act_grad(activation, zs[i - 1])).to(dt)
    dhf = dh.float()
    de = dmsg + dhf @ w0c.float()
    dw_c = dhf.reshape(-1, c).t() @ e.float().reshape(-1, c)
    # per node: the sums of dh0 over each destination's and each source's edges, rounded
    pd = torch.zeros(b, nd, c, device=e.device).index_add_(1, dst, dhf).to(dt).float()
    ps = torch.zeros(b, x_src.shape[1], c, device=e.device).index_add_(1, srcl, dhf).to(dt).float()
    w0 = dense[0].float()
    dx_dst, dx_src = pd @ w0[:, :c], ps @ w0[:, c:2 * c]
    dw_a = pd.reshape(-1, c).t() @ x_dst.float().reshape(-1, c)
    dw_b = ps.reshape(-1, c).t() @ x_src.float().reshape(-1, c)
    grads[0], grads[1] = torch.cat([dw_a, dw_b, dw_c], dim=1), dhf.reshape(-1, c).sum(0)
    return dx_dst, dx_src, de, grads + [dgamma, dbeta]


def _csr_t_of(rowptr: torch.Tensor, src: torch.Tensor, num_src: int) -> CSRTranspose:
    """The transposed CSR of an edge list, built on the host for a caller
    that passed none (the layers pass the one their edge set holds)."""
    t = csr_transpose(rowptr.cpu().numpy(), src.cpu().numpy(), num_src)
    return CSRTranspose(*(torch.from_numpy(a).to(rowptr.device) for a in t))


def _chain_smem(c: int, n_dense: int) -> int:
    """Bytes of shared memory the fused backward chain takes at width ``c``
    with ``n_dense`` Dense (``csrc/gnn_conv_bwd.cu:Chain::smem``): a
    three-stage ring of weight slices (K 32 wide at C = 256, else 64 or C),
    the (64, C) bf16 A tile, one fp32 (64, C) z tile per hidden Dense, the
    column sums, the row-statistic exchange, the barriers and the alignment
    slack."""
    kbk = 32 if c == 256 else min(c, 64)
    return 1024 + 3 * c * kbk * 2 + 64 * c * 2 + (n_dense - 1) * 64 * c * 4 + 32 * c + 4 * 2 * 64 * 4 + 7 * 8


def _bwd_route(c: int, n_dense: int, dtype: torch.dtype) -> str:
    """Which chain the backward runs a chunk through on the card: ``"fused"``
    (one kernel per 64 edge rows, ``gnn_bwd_chain_kernel``) in bf16 at the
    widths it is built for with a depth whose z tiles fit its shared memory,
    else ``"layered"`` (a launch per product)."""
    _gnn_route(c, n_dense)  # the widths and depths the kernels take
    fits = n_dense <= _CHAIN_MAX_DENSE and _chain_smem(c, n_dense) <= _SMEM_LIMIT
    return "fused" if dtype == torch.bfloat16 and c in _CHAIN_WIDTHS and fits else "layered"


def _dw_splits(c: int, chunk: int, dt: torch.dtype, n_problems: int = 1) -> int:
    """The K split of the weight gradients' GEMMs over a chunk's edge rows:
    about :data:`_DW_CTAS` CTAs over the ``n_problems`` (C, C) outputs of one
    launch (bf16: every Dense of the chunk on ``csrc/gemm_sm90_mn.cuh``'s
    128 x 256 tiles, or 128 x 128 where 256 does not divide C; fp32: one Dense
    on 64 x 64 CUDA-core tiles), a function of the shape alone."""
    if dt == torch.bfloat16:
        tiles, kstep = -(-c // 128) * -(-c // (256 if c % 256 == 0 else 128)) * n_problems, 64
    else:
        tiles, kstep = (-(-c // 64)) ** 2, 16
    return max(1, min(-(-_DW_CTAS // tiles), -(-chunk // kstep)))


def gnn_conv_bwd(
    x_dst: torch.Tensor,
    x_src: torch.Tensor,
    e: torch.Tensor,
    rowptr: torch.Tensor,
    src: torch.Tensor,
    ops: Sequence[torch.Tensor],
    activation: str,
    g_agg: torch.Tensor,
    g_msg: torch.Tensor,
    csr_t: CSRTranspose | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """:func:`gnn_conv_bwd_plain`'s function. On the card the operands are
    :func:`gnn_conv`'s, ``g_agg`` fp32 and ``g_msg`` in the compute dtype;
    ``csr_t`` is the edge list's :class:`CSRTranspose` on the same device
    (built on the host when not given). One launch of
    ``csrc/gnn_conv_bwd.cu``."""
    n_dense = (len(ops) - 2) // 2
    cost.record("gnn_conv_bwd", lambda: cost.gnn_conv_bwd_flops(
        e.shape[0], src.numel(), rowptr.numel() - 1, x_src.shape[1], e.shape[-1], n_dense))
    if _on_cpu(x_dst, x_src, e, rowptr, src, g_agg, g_msg, *ops):
        with cost.plain():
            return gnn_conv_bwd_plain(x_dst, x_src, e, rowptr, src, ops, activation, g_agg, g_msg)
    code = _ACT_CODES.get(activation.lower())
    if code is None:
        raise NotImplementedError(f"the GNN conv kernels have no activation {activation!r}; they take {sorted(_ACT_CODES)}")
    dt = e.dtype
    _require(dt in _DTYPES, f"compute dtype must be fp32 or bf16, got {dt}")
    _require(all(t.dtype == dt for t in (x_dst, x_src, g_msg, *ops)), "x_dst, x_src, e, g_msg and the MLP must share one dtype")
    _require(g_agg.dtype == torch.float32, "g_agg must be fp32")
    _require(rowptr.dtype == torch.int32 and src.dtype == torch.int32, "rowptr and src must be int32")
    _require(x_dst.dim() == 3 and x_src.dim() == 3 and e.dim() == 3, "x_dst, x_src, e must be (B, N, C)")
    batch, nd, c = x_dst.shape
    ns, num_edges = x_src.shape[1], src.numel()
    *dense, gamma, beta = ops
    _gnn_route(c, n_dense)  # the widths and depths the kernels take
    _require(n_dense <= _BWD_MAX_DENSE, f"the GNN conv's backward kernel takes at most {_BWD_MAX_DENSE} Dense, got {n_dense}")
    _require(nd == rowptr.numel() - 1 and nd > 0 and ns > 0, f"x_dst has {nd} rows for {rowptr.numel() - 1} destinations")
    _require(x_src.shape[0] == batch and x_src.shape[2] == c, f"x_src shape {tuple(x_src.shape)}")
    _require(e.shape == (batch, num_edges, c) and g_msg.shape == e.shape and g_agg.shape == x_dst.shape,
             f"e, g_msg, g_agg shapes {tuple(e.shape)}, {tuple(g_msg.shape)}, {tuple(g_agg.shape)}")
    weights, biases = dense[0::2], dense[1::2]
    _require(weights[0].shape == (c, 3 * c) and all(w.shape == (c, c) for w in weights[1:]),
             f"weights {[tuple(w.shape) for w in weights]} for C={c} (torch Linear layout)")
    _require(all(t.shape == (c,) for t in (*biases, gamma, beta)), "biases and LayerNorm affine must be (C,)")
    _require_contiguous(x_dst=x_dst, x_src=x_src, e=e, rowptr=rowptr, src=src, g_agg=g_agg, g_msg=g_msg,
                        gamma=gamma, beta=beta, **{f"dense_{i}": t for i, t in enumerate(dense)})
    if csr_t is None:
        csr_t = _csr_t_of(rowptr, src, ns)
    perm, colptr = csr_t.perm, csr_t.colptr
    _require(perm.dtype == torch.int32 and colptr.dtype == torch.int32 and perm.device == e.device
             and colptr.device == e.device, "the transposed CSR must be int32 on e's device")
    _require(perm.numel() == num_edges and colptr.numel() == ns + 1, "the transposed CSR does not match the edge list")
    c_ln = c  # the LayerNorm's statistics run over the true width
    if c % 8:
        c = c + 8 - c % 8
        x_dst, x_src, e, ops = _padded(x_dst, x_src, e, ops, c)
        *dense, gamma, beta = ops
        g_agg, g_msg = (torch.nn.functional.pad(t, (0, c - c_ln)).contiguous() for t in (g_agg, g_msg))
    _require(all(t.data_ptr() % 16 == 0 for t in (x_dst, x_src, e, g_msg, g_agg, *ops)), "rows must be 16-byte aligned")
    dev = e.device
    chunk = max(1, min(LAYERED_CHUNK, batch * num_edges))
    blocks = -(-chunk // _BWD_ROWS)
    bf16 = dt == torch.bfloat16
    route = _bwd_route(c_ln, n_dense, dt)  # a padded width takes the layered chain
    splits = _dw_splits(c, chunk, dt, n_dense if bf16 else 1)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    p_dst, p_src = f32(batch, nd, c), f32(batch, ns, c)
    layered = route == "layered"
    z, h = (f32(n_dense - 1, chunk, c), f32(chunk, c)) if layered else (f32(0), f32(0))
    a = torch.empty((n_dense - 1, chunk, c), dtype=dt, device=dev)
    rows = torch.empty((chunk, 2), dtype=torch.int32, device=dev)
    db_parts, ln_parts = f32(n_dense, blocks, c), f32(blocks, 2, c)
    # the per-node sums of dh0, fp32 (written by the first chunk, added to by the others)
    de, dp_dst, dp_src, dx_dst, dx_src = (f32(batch, num_edges, c), f32(batch, nd, c), f32(batch, ns, c),
                                          f32(batch, nd, c), f32(batch, ns, c))
    dw, db, dln = f32(n_dense + 2, c, c), f32(n_dense, c), f32(2, c)
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    lib = load_kernels()
    ptrs = (ctypes.c_void_p * len(dense))(*(t.data_ptr() for t in dense))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16:
            # every Dense's dh (the grouped weight gradients read them all), the per-node sums rounded for the
            # node products, and the weight gradients' partials (every Dense, then the node blocks)
            dh = torch.empty((n_dense, chunk, c), dtype=dt, device=dev)
            node_t = torch.empty((batch * (nd + ns), c), dtype=dt, device=dev)
            dw_parts = f32(n_dense + 2, splits, c, c)
            rc = lib.gnn_conv_bwd_bf16(
                x_dst.data_ptr(), x_src.data_ptr(), e.data_ptr(), rowptr.data_ptr(), src.data_ptr(),
                colptr.data_ptr(), perm.data_ptr(), ptrs, n_dense, gamma.data_ptr(), g_agg.data_ptr(),
                g_msg.data_ptr(), p_dst.data_ptr(), p_src.data_ptr(), z.data_ptr(), a.data_ptr(), h.data_ptr(),
                dh.data_ptr(), rows.data_ptr(), node_t.data_ptr(), dw_parts.data_ptr(), splits, db_parts.data_ptr(),
                blocks, ln_parts.data_ptr(), blocks, chunk, int(route == "fused"), de.data_ptr(), dp_dst.data_ptr(),
                dp_src.data_ptr(), dx_dst.data_ptr(), dx_src.data_ptr(), dw.data_ptr(), db.data_ptr(),
                dln.data_ptr(), batch, nd, ns, num_edges, c, c_ln, code, stream,
            )
        else:
            # the CUDA-core products' second operands as K-major (C_in, C_out) copies: Dense 0's edge block, each
            # later Dense, then Dense 0's destination and source blocks; the weight gradients read transposed
            # copies of the chunk
            w0 = dense[0]
            dense_t = [w0[:, 2 * c:].t().contiguous()] + [w.t().contiguous() for w in dense[2::2]] + \
                [w0[:, :c].t().contiguous(), w0[:, c:2 * c].t().contiguous()]
            ptrs_t = (ctypes.c_void_p * len(dense_t))(*(t.data_ptr() for t in dense_t))
            ld_t = -(-chunk // 8) * 8
            dh0, dh1 = f32(chunk, c), f32(chunk, c)
            tr_a, tr_b = f32(c, ld_t), f32(c, ld_t)
            dw_parts = f32(n_dense, splits, c, c)
            rc = lib.gnn_conv_bwd_f32(
                x_dst.data_ptr(), x_src.data_ptr(), e.data_ptr(), rowptr.data_ptr(), src.data_ptr(),
                colptr.data_ptr(), perm.data_ptr(), ptrs, ptrs_t, n_dense, gamma.data_ptr(), beta.data_ptr(),
                g_agg.data_ptr(), g_msg.data_ptr(), p_dst.data_ptr(), p_src.data_ptr(), z.data_ptr(), a.data_ptr(),
                h.data_ptr(), dh0.data_ptr(), dh1.data_ptr(), rows.data_ptr(), tr_a.data_ptr(), tr_b.data_ptr(),
                ld_t, None, dw_parts.data_ptr(), splits, db_parts.data_ptr(), blocks, ln_parts.data_ptr(), blocks,
                chunk, de.data_ptr(), dp_dst.data_ptr(), dp_src.data_ptr(), dx_dst.data_ptr(), dx_src.data_ptr(),
                dw.data_ptr(), db.data_ptr(), dln.data_ptr(), batch, nd, ns, num_edges, c, c_ln, code, stream,
            )
    _check_launch(rc, "gnn_conv_bwd")
    LAUNCHES["gnn_conv_bwd"] += 1
    grads = [torch.cat([dw[n_dense], dw[n_dense + 1], dw[0]], dim=1), db[0]]
    for i in range(1, n_dense):
        grads += [dw[i], db[i]]
    grads += [dln[0], dln[1]]
    if c != c_ln:
        grads = [_unpad_operand(t, c_ln, c) for t in grads]
        dx_dst, dx_src, de = (t[..., :c_ln].contiguous() for t in (dx_dst, dx_src, de))
    return dx_dst, dx_src, de, grads


def _unpad_operand(t: torch.Tensor, c: int, cp: int) -> torch.Tensor:
    """A gradient of a :func:`_padded` operand at the true width ``c``: a
    bias or affine (cp,), or a weight (cp, k cp) with its k blocks each cut."""
    if t.dim() == 1:
        return t[:c]
    blocks = t.shape[1] // cp
    return torch.cat([t[:c, k * cp:k * cp + c] for k in range(blocks)], dim=1)


class GNNConv(torch.autograd.Function):
    """:func:`gnn_conv` with the edge MLP's parameters as inputs, and
    :func:`gnn_conv_bwd` as its backward. ``apply(x_dst, x_src, e, rowptr,
    src, [csr_t,] activation, *params)``: ``csr_t``, the edge list's
    :class:`CSRTranspose` on the edges' device, may be left out (the card's
    backward then builds it); ``params``: each Dense's fp32 ``weight``,
    ``bias``, then the LayerNorm's ``weight``, ``bias``. Returns ``(agg
    fp32, msg)``."""

    @staticmethod
    def forward(ctx, x_dst, x_src, e, rowptr, src, *rest):
        csr_t = rest[0] if isinstance(rest[0], CSRTranspose) else None
        activation, *params = rest[1:] if csr_t is not None else rest
        ctx.save_for_backward(x_dst, x_src, e, rowptr, src, *params)
        ctx.activation, ctx.csr_t, ctx.n_lead = activation, csr_t, 6 + (csr_t is not None)
        return gnn_conv(x_dst, x_src, e, rowptr, src, _operands(params, e.dtype), activation)

    @staticmethod
    def backward(ctx, g_agg, g_msg):
        x_dst, x_src, e, rowptr, src, *params = ctx.saved_tensors
        ops = _operands(params, e.dtype)
        dx_dst, dx_src, de, grads = gnn_conv_bwd(
            x_dst, x_src, e, rowptr, src, ops, ctx.activation, g_agg.float().contiguous(),
            g_msg.to(e.dtype).contiguous(), ctx.csr_t,
        )
        return (dx_dst.to(x_dst.dtype), dx_src.to(x_src.dtype), de.to(e.dtype), *([None] * (ctx.n_lead - 3)),
                *(g.to(p.dtype) for g, p in zip(grads, params)))


def _operands(params: Sequence[torch.Tensor], dtype: torch.dtype) -> list[torch.Tensor]:
    dense = [(params[i], params[i + 1]) for i in range(0, len(params) - 2, 2)]
    return mlp_operands(dense, (params[-2], params[-1]), dtype)
