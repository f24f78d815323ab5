"""Time the port's redesigned kernels of two checkouts in turns on one CUDA
card, and the timing helpers chip_smoke.py shares.

    python3 kernel_turns.py PARENT_ROOT .                 # parent, this, this, parent; every kernel
    python3 kernel_turns.py PARENT_ROOT . --kernels fwd,bwd
    python3 kernel_turns.py PARENT_ROOT . --kernels gnn_bwd,flash_bwd   # the backward kernels
    python3 kernel_turns.py --worker ROOT [--kernels ...]  # one turn: JSON of ROOT's kernels
    python3 kernel_turns.py PARENT_ROOT . --requests       # the GNN request and train step at C = 1024
    python3 kernel_turns.py PARENT_ROOT . --steps          # each flavor's train steps

Each turn is its own process that imports ``anemoi_models_tpu_torch`` from
its root (so each builds its own kernels into ``ROOT/build``) and times, at
the O96 main path's shapes with seeded inputs:

- ``kv``: ``kv_proj`` at M = 10,242 and M = 40,320 (K = 256, N = 512) in
  bf16 and fp32 with ``torch.addmm`` beside it, with a SHA-256 of its output;
- ``gnn``: ``gnn_conv`` (C = 256, three Dense: the fused route) on the
  processor (self-graph), encoder and decoder edge sets in bf16 and fp32,
  at C = 36 (the layered route, padded to 40) on the processor set, and the
  layered route at C = 384, 512 and 1024 (the production width) on the three
  sets, with a SHA-256 of agg and msg; each bf16 layered shape at C = 1024
  also with its device ms per call split by launch (``layered_split``:
  pre-pass, row table, Dense 0, hidden Dense, last Dense, LayerNorm pass,
  sum) from ``torch.profiler``;
- ``fwd``: ``edge_attn_csr`` (A2 = 8, batch 1) at C = 256 with 4 heads on
  the processor, encoder and decoder edge sets, and on the processor set at
  C = 1024 with 16 heads (the production width), C = 512 and C = 1024 with 4
  heads (D = 128, 256), C = 640 with 2 heads, C = 1024 with 2 and 1 heads
  (D = 320, 512, 1024: a head wider than 256) and C = 40 with 4 heads (D =
  10, padded to 16), in bf16 and fp32, with a SHA-256 of its outputs (num,
  den, m after ``x + 0.0``, so that only the sign of an exact zero may
  differ) per turn;
- ``bwd``: ``edge_attn_csr_bwd`` at the same shapes, with a SHA-256 of each
  of dq, dkv, da and dw_aug;
- ``flash``: ``flash_attention`` at (B*H, N, D) = (4, 10,242, 64) with
  w = 512, no window, ragged N = 4,098 (w = 512) and causal (w = 512), at
  D = 24, 48, 96, 256 and 512 with w = 512, and with attention dropout
  (p = 0.1) at D = 64, w = 512, q, k and v strided views of one fused
  projection, in bf16 and fp32, with a SHA-256 of its output;
- ``gnn_bwd``: ``gnn_conv_bwd`` (SiLU, three Dense, cotangents on agg and
  msg, the edge set's transposed CSR given) at the shapes of
  ``chip_smoke.py``'s backward phase: the processor, encoder and decoder
  sets at C = 256 (fp32 and bf16) and C = 1024 (bf16), and C = 36 (padded to
  40) on the processor's set (fp32 and bf16), with a SHA-256 of each
  gradient and, in bf16, the device kernels of one call by name from
  ``torch.profiler`` (``kernels``; ``transposes``: those named
  ``gnn_transpose_kernel``);
- ``flash_bwd``: ``flash_attention_bwd`` at the O96 processor's (B*H, N, D)
  = (4, 10,242, 64) from the forward kernel's row log-sum-exp, q, k and v
  strided views of one fused projection: w = 512, causal w = 512, dropout
  0.1 with w = 512, and rank 1's 5,121 rows of a two-rank split against its
  halo-extended keys (w = 512), in bf16 and fp32, with a SHA-256 of each of
  dq, dk and dv.

With ``--requests`` each turn serves and trains the GNN at the production
width (O96, C = 1024, bf16: the layered route) through ROOT's own
``chip_smoke.phase_serving`` (three timed ``predict_step`` requests and a
profiled one) and ``chip_smoke.phase_train`` (two timed steps after a
warm-up at lr 1e-5, and a profiled one), and reports for each the ms, the
device's busy ms and the device time by kind. With ``--steps`` each turn
trains through ROOT's ``chip_smoke.phase_train`` (three timed steps after a
warm-up, remat "full") the O96 flagship of each flavor (C = 256, 4 heads;
the GraphTransformer also under "none") and the GNN and the
GraphTransformer at the production width (C = 1024, lr 1e-5; 16 heads),
and through ``chip_smoke.policy_runs`` three steps of the Transformer with
attention dropout 0.1 (C = 256, lr 1e-5), with the ms, peak memory and
launches of a step of each.

Device ms come from CUDA events around launches queued behind a
``torch.cuda._sleep`` that outlasts the host's enqueue, so they bracket
device work only; host us is the wrapper's enqueue time per call. A shape
that a checkout's wrapper refuses (ValueError: a width it does not take) is
recorded as refused, with the message. Prints one ``turn`` JSON line per
turn, the card's name and power limit, and a ``same_bits`` line: per kernel,
shape and output, whether the two checkouts' outputs hash alike, for the
shapes both take.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

_SLEEP_CYCLES_PER_MS: float | None = None


def _cycles_per_ms() -> float:
    """The rate of ``torch.cuda._sleep``'s cycle counter, measured once."""
    import torch

    global _SLEEP_CYCLES_PER_MS
    if _SLEEP_CYCLES_PER_MS is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS = 10_000_000 / start.elapsed_time(end)
    return _SLEEP_CYCLES_PER_MS


def host_us(fn, iters: int = 50, warmup: int = 3) -> float:
    """The host's microseconds per call of ``fn`` (its enqueue time; the
    device keeps up with the kernel wrappers timed here)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call over ``iters`` calls after warm-up: the calls
    are queued behind a device sleep that outlasts their enqueue, so the
    CUDA events around them bracket device work, not the host's issue rate.
    (A ``fn`` that synchronises inside, as some plain versions do, still
    counts its host time.)"""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * enqueue_ms + 1.0, 500.0) * _cycles_per_ms()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


KERNELS = ("kv", "gnn", "fwd", "bwd", "flash", "gnn_bwd", "flash_bwd")
# the layered GNN route's launches, by a mark in the kernel's name (first match)
LAYERED_KINDS = (("pre-pass", "gnn_prepass_tag"), ("row table", "gnn_rows_kernel"), ("Dense 0", "gnn_dense0_tag"),
                 ("hidden Dense", "gnn_dense_tag"), ("last Dense", "gnn_dense_last_tag"), ("LayerNorm", "gnn_ln_kernel"),
                 ("sum", "gnn_agg_kernel"))


def kernels_per_call(fn, iters: int = 3) -> dict:
    """Device kernels per call of ``fn``, by name, from ``torch.profiler``
    over ``iters`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        name = kernel_name(e.name)
        names[name] = names.get(name, 0) + 1 / iters
    return names


def kernel_name(name: str) -> str:
    """A profiled kernel's name without its namespaces, template arguments
    and parameters: ``(anonymous namespace)::gnn_bwd_chain_kernel<256>(...)``
    -> ``gnn_bwd_chain_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1] or name[:60]


def layered_split(fn, iters: int = 5) -> dict:
    """Device ms and launches per call of ``fn`` (a layered ``gnn_conv``
    call), by LAYERED_KINDS, from ``torch.profiler`` over ``iters`` calls
    after a warm-up; kernels of no kind count as "other"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {kind: {"ms": 0.0, "launches": 0.0} for kind, _ in LAYERED_KINDS + (("other", ""),)}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        kind = next((k for k, mark in LAYERED_KINDS if mark in e.name), "other")
        split[kind]["ms"] += e.time_range.elapsed_us() / 1e3 / iters
        split[kind]["launches"] += 1 / iters
    return split
EDGE_SETS = (("processor", ("hidden", "hidden")), ("encoder", ("data", "hidden")), ("decoder", ("hidden", "data")))


def _digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, -0.0 read as +0.0."""
    h = hashlib.sha256()
    for t in tensors:
        h.update((t.float() + 0.0).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _timed(entry: dict, run, *timers) -> dict:
    """``entry`` with ``sha256`` (of ``run()``'s outputs: one digest, or one
    per named output) and each ``(key, fn, iters)`` timer; ``refused`` and
    the message where the wrapper refuses the shape."""
    try:
        got = run()
    except ValueError as exc:
        return {**entry, "refused": str(exc)}
    entry["sha256"] = {k: _digest([v]) for k, v in got.items()} if isinstance(got, dict) else _digest(got)
    for key, fn, iters in timers:
        entry[key] = fn(iters)
    return entry


def _worker(root: str, which: tuple) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
    from anemoi_models_tpu_torch.ops import edge_attention as ea
    from anemoi_models_tpu_torch.ops import flash_attention as fa
    from anemoi_models_tpu_torch.ops import gnn_conv as gc
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    load_kernels()
    out = {"package": os.path.dirname(ea.__file__), "build_s": time.perf_counter() - t0, "kv_proj": [],
           "gnn_conv": [], "edge_attn_csr": [], "edge_attn_csr_bwd": [], "flash_attention": [], "gnn_conv_bwd": [],
           "flash_attention_bwd": []}
    graph = build_enc_proc_dec_graph(grid_lat=96, mesh_refinements=5, grid="octahedral")
    gen = torch.Generator().manual_seed(0)
    c = 256
    for m in (graph["hidden"].num_nodes, graph["data"].num_nodes) if "kv" in which else ():
        f32, w32 = torch.randn(m, c, generator=gen), torch.randn(2 * c, c, generator=gen) * c ** -0.5
        b32 = torch.randn(2 * c, generator=gen) * 0.1
        for dt in (torch.bfloat16, torch.float32):
            f, w, b = f32.to(dev, dt), w32.to(dev, dt), b32.to(dev)
            b_dt = b.to(dt)
            out["kv_proj"].append({"shape": f"{m}x{c} . {c}x{2 * c}", "dtype": str(dt).split(".")[-1],
                                   "sha256": _digest([ea.kv_proj(f, w, b)]),
                                   "ms": cuda_ms(lambda: ea.kv_proj(f, w, b)),
                                   "host_us": host_us(lambda: ea.kv_proj(f, w, b)),
                                   "addmm_ms": cuda_ms(lambda: torch.addmm(b_dt, f, w.t()))})
    # (C): the fused route at 256 on every set; the layered route at 36 (padded) on the processor's, and at
    # 384, 512 and the production width 1024 on every set
    gnn_shapes = [(label, names, 256) for label, names in EDGE_SETS] + [("processor", EDGE_SETS[0][1], 36)] + [
        (label, names, cg) for cg in (384, 512, 1024) for label, names in EDGE_SETS]
    for label, (s_name, d_name), cg in gnn_shapes if "gnn" in which else ():
        ei = graph[(s_name, "to", d_name)].edge_index
        ns, nd = graph[s_name].num_nodes, graph[d_name].num_nodes
        rowptr, src = (torch.from_numpy(t).to(dev) for t in ea.csr_from_edge_index(ei, ns, nd))
        x_dst = torch.randn(1, nd, cg, generator=gen)
        x_src = x_dst if label == "processor" else torch.randn(1, ns, cg, generator=gen)
        e = torch.randn(1, ei.shape[1], cg, generator=gen)
        dense = [(torch.randn(cg, k, generator=gen) * k ** -0.5, torch.randn(cg, generator=gen) * 0.1)
                 for k in (3 * cg, cg, cg)]
        norm = (1 + 0.1 * torch.randn(cg, generator=gen), 0.1 * torch.randn(cg, generator=gen))
        for dt in (torch.bfloat16, torch.float32):
            xd, e_d = x_dst.to(dev, dt), e.to(dev, dt)
            xs = xd if label == "processor" else x_src.to(dev, dt)
            ops = [t.to(dev) for t in gc.mlp_operands(dense, norm, dt)]
            args = (xd, xs, e_d, rowptr, src, ops, "SiLU")
            timers = [("ms", lambda n: cuda_ms(lambda: gc.gnn_conv(*args), iters=n), 20),
                      ("host_us", lambda n: host_us(lambda: gc.gnn_conv(*args), iters=n), 20)]
            if cg == 1024 and dt == torch.bfloat16:
                timers.append(("split", lambda n: layered_split(lambda: gc.gnn_conv(*args), iters=n), 5))
            out["gnn_conv"].append(_timed(
                {"shape": f"{label} E={ei.shape[1]}" + ("" if cg == 256 else f" C={cg}"),
                 "dtype": str(dt).split(".")[-1]},
                lambda: gc.gnn_conv(*args), *timers))
            del args, ops, xd, xs, e_d
    # (C, heads): the flagship on every edge set; the production width and D = 128, 256 on the processor's
    attn_shapes = [(label, names, 256, 4) for label, names in EDGE_SETS] + [
        ("processor", EDGE_SETS[0][1], cc, hh)
        for cc, hh in ((1024, 16), (512, 4), (1024, 4), (640, 2), (1024, 2), (1024, 1), (40, 4))]
    for label, (s_name, d_name), ca, h in attn_shapes if ("fwd" in which or "bwd" in which) else ():
        ei = graph[(s_name, "to", d_name)].edge_index
        ns, nd = graph[s_name].num_nodes, graph[d_name].num_nodes
        rowptr_np, src_np = ea.csr_from_edge_index(ei, ns, nd)
        rowptr, src = torch.from_numpy(rowptr_np).to(dev), torch.from_numpy(src_np).to(dev)
        csr_t = ea.CSRTranspose(*(torch.from_numpy(t).to(dev) for t in ea.csr_transpose(rowptr_np, src_np, ns)))
        a2 = 8
        q32, kv32 = torch.randn(nd, ca, generator=gen), torch.randn(ns, 2 * ca, generator=gen)
        a32, wa32 = torch.randn(ei.shape[1], a2, generator=gen), torch.randn(a2, ca, generator=gen) * 0.3
        g_num, g_den = torch.randn(nd, ca, generator=gen).to(dev), torch.randn(nd, h, generator=gen).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            q, kv, a, wa = (t.to(dev, dt) for t in (q32, kv32, a32, wa32))
            fwd = (q, kv, rowptr, src, a, wa, h)
            shape = f"{label} E={ei.shape[1]}" + ("" if (ca, h) == (256, 4) else f" C={ca} H={h}")
            entry = {"shape": shape, "dtype": str(dt).split(".")[-1]}
            if "fwd" in which:
                out["edge_attn_csr"].append(_timed(
                    dict(entry), lambda: ea.edge_attn_csr(*fwd),
                    ("ms", lambda n: cuda_ms(lambda: ea.edge_attn_csr(*fwd), iters=n), 20),
                    ("host_us", lambda n: host_us(lambda: ea.edge_attn_csr(*fwd), iters=n), 50)))
            if "bwd" in which:
                def bwd():
                    m = ea.edge_attn_csr(*fwd).m
                    args = (q, kv, rowptr, src, a, wa, m, g_num, g_den, h, csr_t)
                    bwd.args = args
                    return dict(zip(("dq", "dkv", "da", "dw_aug"), ea.edge_attn_csr_bwd(*args)))
                out["edge_attn_csr_bwd"].append(_timed(
                    dict(entry), bwd,
                    ("ms", lambda n: cuda_ms(lambda: ea.edge_attn_csr_bwd(*bwd.args), iters=n), 20),
                    ("host_us", lambda n: host_us(lambda: ea.edge_attn_csr_bwd(*bwd.args), iters=n), 20)))
    n0, w0, h = 10242, 512, 4
    # (N, w, causal, D, dropout rate): the O96 shapes, the head widths the kernels pad or run on wide
    # lanes, and attention dropout (a checkout whose wrapper has no dropout refuses it)
    flash_shapes = [(n0, w0, False, 64, 0.0), (n0, None, False, 64, 0.0), (2 * n0 // 5 + 2, w0, False, 64, 0.0),
                    (n0, w0, True, 64, 0.0)] + [(n0, w0, False, dd, 0.0) for dd in (24, 48, 96, 256, 512)] + [
                    (n0, w0, False, 64, 0.1)]
    drops = "dropout_key" in inspect.signature(fa.flash_attention).parameters
    for n, window, causal, d, rate in flash_shapes if "flash" in which else ():
        qkv32 = torch.randn(1, n, 3, h, d, generator=gen)
        for dt in (torch.bfloat16, torch.float32):
            qkv = qkv32.to(dev, dt)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            entry = {"shape": f"B*H={h} N={n} D={d} w={window}{' causal' if causal else ''}"
                              + (f" dropout={rate}" if rate else ""), "dtype": str(dt).split(".")[-1]}
            if rate and not drops:
                out["flash_attention"].append({**entry, "refused": "no attention dropout in this checkout"})
                continue
            extra = (rate, fa.fold_key(0, 1, 2)) if rate else ()

            def call(q=q, k=k, v=v, window=window, causal=causal, extra=extra):
                return fa.flash_attention(q, k, v, window, causal, *extra)

            out["flash_attention"].append(_timed(
                entry, lambda: [call()],
                ("ms", lambda it: cuda_ms(call, iters=it), 20),
                ("host_us", lambda it: host_us(call, iters=it), 50)))
    if "gnn_bwd" in which:
        out["gnn_conv_bwd"] = _gnn_bwd_turn(graph, dev)
    if "flash_bwd" in which:
        out["flash_attention_bwd"] = _flash_bwd_turn(dev)
    return out


# (edge set, C, dtypes): chip_smoke.py's GNN_BWD_CASES, fp32 not at the production width
GNN_BWD_SHAPES = tuple((label, names, c) for c in (256, 1024) for label, names in EDGE_SETS) + (
    ("processor", EDGE_SETS[0][1], 36),)


def _gnn_bwd_turn(graph, dev) -> list:
    import torch

    from anemoi_models_tpu_torch.ops import edge_attention as ea
    from anemoi_models_tpu_torch.ops import gnn_conv as gc

    gen = torch.Generator().manual_seed(21)
    rows = []
    for label, (s_name, d_name), c in GNN_BWD_SHAPES:
        ei = graph[(s_name, "to", d_name)].edge_index
        ns, nd = graph[s_name].num_nodes, graph[d_name].num_nodes
        rowptr_np, src_np = ea.csr_from_edge_index(ei, ns, nd)
        rowptr, src = torch.from_numpy(rowptr_np).to(dev), torch.from_numpy(src_np).to(dev)
        csr_t = ea.CSRTranspose(*(torch.from_numpy(t).to(dev) for t in ea.csr_transpose(rowptr_np, src_np, ns)))
        x_dst = torch.randn(1, nd, c, generator=gen)
        x_src = x_dst if label == "processor" else torch.randn(1, ns, c, generator=gen)
        e = torch.randn(1, ei.shape[1], c, generator=gen)
        dense = [(torch.randn(c, k, generator=gen) * k ** -0.5, torch.randn(c, generator=gen) * 0.1)
                 for k in (3 * c, c, c)]
        norm = (1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
        g_agg = torch.randn(1, nd, c, generator=gen).to(dev)
        g_msg = torch.randn(1, ei.shape[1], c, generator=gen)
        for dt in (torch.bfloat16,) if c == 1024 else (torch.bfloat16, torch.float32):
            xd, e_d, gm = x_dst.to(dev, dt), e.to(dev, dt), g_msg.to(dev, dt)
            xs = xd if label == "processor" else x_src.to(dev, dt)
            ops = [t.to(dev) for t in gc.mlp_operands(dense, norm, dt)]
            args = (xd, xs, e_d, rowptr, src, ops, "SiLU", g_agg, gm, csr_t)

            def run(args=args):
                dx_dst, dx_src, de, grads = gc.gnn_conv_bwd(*args)
                return {"dx_dst": dx_dst, "dx_src": dx_src, "de": de, **{f"d op {i}": g for i, g in enumerate(grads)}}

            timers = [("ms", lambda n, args=args: cuda_ms(lambda: gc.gnn_conv_bwd(*args), iters=n), 10),
                      ("host_us", lambda n, args=args: host_us(lambda: gc.gnn_conv_bwd(*args), iters=n), 10)]
            if dt == torch.bfloat16:
                timers.append(("kernels", lambda n, args=args: kernels_per_call(lambda: gc.gnn_conv_bwd(*args), n), 3))
            entry = _timed({"shape": f"{label} E={ei.shape[1]} C={c}", "dtype": str(dt).split(".")[-1]}, run, *timers)
            if "kernels" in entry:
                entry["transposes"] = sum(n for k, n in entry["kernels"].items() if "transpose" in k)
                entry["device_kernels"] = sum(entry["kernels"].values())
            rows.append(entry)
            del args, ops, xd, xs, e_d, gm
    return rows


def _flash_bwd_turn(dev) -> list:
    import torch

    from anemoi_models_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(23)
    n0, w0, h, d = 10242, 512, 4, 64
    half = n0 - n0 // 2
    qkv32 = torch.randn(1, n0, 3, h, d, generator=gen)
    g32 = torch.randn(1, h, n0, d, generator=gen)
    key = fa.fold_key(19, 2, 1)
    cases = (("w=512", (0, n0), (0, n0), False, 0.0), ("causal w=512", (0, n0), (0, n0), True, 0.0),
             ("w=512 dropout=0.1", (0, n0), (0, n0), False, 0.1),
             ("halo rank 1 w=512", (half, n0), (half - w0, n0), False, 0.0))
    rows = []
    for label, (q0, q1), (k0, k1), causal, rate in cases:
        for dt in (torch.bfloat16, torch.float32):
            qkv = qkv32.to(dev, dt)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            q, k, v = q[:, :, q0:q1], k[:, :, k0:k1], v[:, :, k0:k1]
            g = g32[:, :, q0:q1].to(dev, dt)
            kw = dict(window_size=w0, is_causal=causal, dropout_rate=rate, dropout_key=key if rate else None,
                      q_offset=q0, k_offset=k0, n_valid=n0)
            out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)

            def call(q=q, k=k, v=v, out=out, g=g, lse=lse, kw=kw):
                return fa.flash_attention_bwd(q, k, v, out, g, lse, **kw)

            rows.append(_timed({"shape": f"B*H={h} D={d} {label}: {q1 - q0} query rows, {k1 - k0} keys",
                                "dtype": str(dt).split(".")[-1]}, lambda call=call: dict(zip(("dq", "dk", "dv"), call())),
                               ("ms", lambda it, call=call: cuda_ms(call, iters=it), 10),
                               ("host_us", lambda it, call=call: host_us(call, iters=it), 20)))
    return rows


def _request_worker(root: str) -> dict:
    """The GNN C = 1024 request and train step of ROOT's checkout, through
    its chip_smoke, each profiled once."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    load_kernels()
    graph = build_enc_proc_dec_graph(grid_lat=96, mesh_refinements=5, grid="octahedral")
    dev, profile_dir = torch.device("cuda", 0), os.path.join(root, "build", "request_profile")
    out = cs.phase_serving(graph, dev, "gnn", profile_dir, channels=1024, expected=cs.EXPECTED["gnn production"][0])
    train, _ = cs.phase_train(graph, dev, profile_dir, "gnn", remat_none=False, channels=1024, lr=1e-5,
                              expected=cs.EXPECTED["gnn production"][1], steps=3, must_fall=False)
    return {"package": root, "request_ms": out["request_ms"], "device_busy_ms": out["profile"]["device_busy_ms"],
            "wall_ms_under_profiler": out["profile"]["wall_ms_under_profiler"], "peak_mem_gib": out["peak_mem_gib"],
            "request_by_kind": out["profile"]["by_kind"], "train_step_ms": train["step_ms"],
            "train_device_busy_ms": train["profile"]["device_busy_ms"],
            "train_wall_ms_under_profiler": train["profile"]["wall_ms_under_profiler"],
            "train_device_kernels": train["profile"]["device_kernels"], "train_by_kind": train["profile"]["by_kind"],
            "train_peak_mem_gib": train["peak_mem_gib"]}


def _steps_worker(root: str) -> dict:
    """Each flavor's train steps of ROOT's checkout, through its chip_smoke:
    the flagships, the GNN and the GraphTransformer at C = 1024, and the
    Transformer with dropout 0.1."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    load_kernels()
    graph = build_enc_proc_dec_graph(grid_lat=96, mesh_refinements=5, grid="octahedral")
    dev = torch.device("cuda", 0)
    out = {"package": root}

    def keep(label, run):
        out[label] = {"step_ms": run["step_ms"], "peak_mem_gib": run["peak_mem_gib"], "per_step": run["per_step"]}

    flagship, _ = cs.phase_train(graph, dev, None, "graphtransformer")
    keep("graphtransformer", flagship)
    keep("graphtransformer none", flagship["remat_none"])
    keep("graphtransformer C=1024", cs.phase_train(graph, dev, None, "graphtransformer", remat_none=False,
                                                   channels=1024, heads=16, lr=1e-5)[0])
    for flavor in ("gnn", "transformer"):
        keep(flavor, cs.phase_train(graph, dev, None, flavor, remat_none=False)[0])
    keep("gnn C=1024", cs.phase_train(graph, dev, None, "gnn", remat_none=False, channels=1024, lr=1e-5,
                                      expected=cs.EXPECTED["gnn production"][1], must_fall=False)[0])
    cfg = cs.memory_config("transformer", 256, 4)
    cfg.model.processor.dropout_p = 0.1
    runs, _ = cs.policy_runs(graph, dev, cfg, "transformer", ("full",), 4, 1e-5, dropout=True)
    out["transformer dropout 0.1"] = {"step_ms": runs["full"]["step_ms"], "peak_mem_gib": runs["full"]["peak_gib"],
                                      "per_step": runs["full"]["per_step"]}
    return out


def _which(args: list) -> tuple:
    if "--kernels" not in args:
        return KERNELS
    which = tuple(args[args.index("--kernels") + 1].split(","))
    if not set(which) <= set(KERNELS):
        raise SystemExit(f"kernel_turns: --kernels takes a comma list of {KERNELS}")
    return which


def main() -> None:
    args = sys.argv[1:]
    which = _which(args)
    requests = "--requests" in args
    steps = "--steps" in args
    if args[:1] == ["--worker"]:
        turn = _request_worker(args[1]) if requests else _steps_worker(args[1]) if steps else _worker(args[1], which)
        print("turn", json.dumps(turn), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: no CUDA card")
    roots = [a for i, a in enumerate(args)
             if a not in ("--kernels", "--requests", "--steps") and (i == 0 or args[i - 1] != "--kernels")]
    if len(roots) != 2:
        raise SystemExit("usage: kernel_turns.py PARENT_ROOT ROOT [--kernels kv,gnn,fwd,bwd,flash,gnn_bwd,flash_bwd | "
                         "--requests | --steps]")
    print("card:", card(), flush=True)
    turns = []
    for root in (roots[0], roots[1], roots[1], roots[0]):
        mode = ["--requests"] if requests else ["--steps"] if steps else ["--kernels", ",".join(which)]
        run = subprocess.run([sys.executable, __file__, "--worker", root, *mode], timeout=900, capture_output=True,
                             text=True)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr, end="", file=sys.stderr)
            raise SystemExit(f"kernel_turns: the turn of {root} failed ({run.returncode})")
        turns.append(next(json.loads(line[5:]) for line in run.stdout.splitlines() if line.startswith("turn ")))
    if requests or steps:
        return
    # the parent's and this checkout's outputs, per kernel, shape and output: bit for bit alike or not
    same = {}
    for kernel in ("kv_proj", "gnn_conv", "edge_attn_csr", "edge_attn_csr_bwd", "flash_attention", "gnn_conv_bwd",
                   "flash_attention_bwd"):
        new_by_key = {(e["shape"], e["dtype"]): e for e in turns[1].get(kernel, [])}
        for old in turns[0].get(kernel, []):
            new = new_by_key.get((old["shape"], old["dtype"]))
            if new is None or "sha256" not in old or "sha256" not in new:
                continue
            key = f"{kernel} {old['shape']} {old['dtype']}"
            if isinstance(old["sha256"], dict):
                for name in old["sha256"]:
                    same[f"{key} {name}"] = old["sha256"][name] == new["sha256"].get(name)
            else:
                same[key] = old["sha256"] == new["sha256"]
    print("same_bits", json.dumps(same), flush=True)


if __name__ == "__main__":
    main()
