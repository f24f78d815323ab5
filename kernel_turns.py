"""Time the port's redesigned kernels (kv_proj, gnn_conv) of two checkouts
in turns on one CUDA card, and the timing helpers chip_smoke.py shares.

    python3 kernel_turns.py PARENT_ROOT .      # runs parent, this, this, parent
    python3 kernel_turns.py --worker ROOT      # one turn: JSON of ROOT's kernels

Each turn is its own process that imports ``anemoi_models_tpu_torch`` from
its root (so each builds its own kernels into ``ROOT/build``) and times, at
the O96 main path's shapes with seeded inputs: ``kv_proj`` at M = 10,242 and
M = 40,320 (K = 256, N = 512) in bf16 and fp32 with ``torch.addmm`` beside
it, and ``gnn_conv`` on the processor (self-graph), encoder and decoder edge
sets in bf16 and fp32. Device ms come from CUDA events around launches
queued behind a ``torch.cuda._sleep`` that outlasts the host's enqueue, so
they bracket device work only; host us is the wrapper's enqueue time per
call. Prints one ``turn`` JSON line per turn and the card's name and power
limit.
"""

from __future__ import annotations

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


def _worker(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
    from anemoi_models_tpu_torch.ops import edge_attention as ea
    from anemoi_models_tpu_torch.ops import gnn_conv as gc
    from anemoi_models_tpu_torch.ops.kernels import load_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    load_kernels()
    out = {"package": os.path.dirname(ea.__file__), "build_s": time.perf_counter() - t0, "kv_proj": [], "gnn_conv": []}
    graph = build_enc_proc_dec_graph(grid_lat=96, mesh_refinements=5, grid="octahedral")
    gen = torch.Generator().manual_seed(0)
    c = 256
    for m in (graph["hidden"].num_nodes, graph["data"].num_nodes):
        f32, w32 = torch.randn(m, c, generator=gen), torch.randn(2 * c, c, generator=gen) * c ** -0.5
        b32 = torch.randn(2 * c, generator=gen) * 0.1
        for dt in (torch.bfloat16, torch.float32):
            f, w, b = f32.to(dev, dt), w32.to(dev, dt), b32.to(dev)
            b_dt = b.to(dt)
            out["kv_proj"].append({"shape": f"{m}x{c} . {c}x{2 * c}", "dtype": str(dt).split(".")[-1],
                                   "ms": cuda_ms(lambda: ea.kv_proj(f, w, b)),
                                   "host_us": host_us(lambda: ea.kv_proj(f, w, b)),
                                   "addmm_ms": cuda_ms(lambda: torch.addmm(b_dt, f, w.t()))})
    for label, (s_name, d_name) in (("processor", ("hidden", "hidden")), ("encoder", ("data", "hidden")),
                                    ("decoder", ("hidden", "data"))):
        ei = graph[(s_name, "to", d_name)].edge_index
        ns, nd = graph[s_name].num_nodes, graph[d_name].num_nodes
        rowptr, src = (torch.from_numpy(t).to(dev) for t in ea.csr_from_edge_index(ei, ns, nd))
        x_dst = torch.randn(1, nd, c, generator=gen)
        x_src = x_dst if label == "processor" else torch.randn(1, ns, c, generator=gen)
        e = torch.randn(1, ei.shape[1], c, generator=gen)
        dense = [(torch.randn(c, k, generator=gen) * k ** -0.5, torch.randn(c, generator=gen) * 0.1)
                 for k in (3 * c, c, c)]
        norm = (1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
        for dt in (torch.bfloat16, torch.float32):
            xd, e_d = x_dst.to(dev, dt), e.to(dev, dt)
            xs = xd if label == "processor" else x_src.to(dev, dt)
            ops = [t.to(dev) for t in gc.mlp_operands(dense, norm, dt)]
            args = (xd, xs, e_d, rowptr, src, ops, "SiLU")
            out["gnn_conv"].append({"shape": f"{label} E={ei.shape[1]}", "dtype": str(dt).split(".")[-1],
                                    "ms": cuda_ms(lambda: gc.gnn_conv(*args)),
                                    "host_us": host_us(lambda: gc.gnn_conv(*args), iters=20)})
    return out


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        print("turn", json.dumps(_worker(sys.argv[2])), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: no CUDA card")
    roots = sys.argv[1:]
    if len(roots) != 2:
        raise SystemExit("usage: kernel_turns.py PARENT_ROOT ROOT")
    print("card:", card(), flush=True)
    for root in (roots[0], roots[1], roots[1], roots[0]):
        subprocess.run([sys.executable, __file__, "--worker", root], check=True, timeout=900)


if __name__ == "__main__":
    main()
