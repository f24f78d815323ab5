"""Smoke test of the PyTorch port on one CUDA card (H100).

Builds the port's CUDA kernels from ``anemoi_models_tpu_torch/csrc``, then:

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the O96 / refinement-5 main path (kv_proj on the processor's
   10,242 nodes; edge_attn_csr on the real processor, encoder and decoder
   edge sets; a case with destinations that have no edge), fp32 within
   atol = rtol = 1e-5 (only the summation order differs) and bf16 within
   2e-2, and times both with CUDA events;
2. runs a reduced model (O48 grid, refinement-4 mesh, C=64, 2 layers) in fp32
   through the kernels on the card and through the plain versions on the CPU,
   from the same seeded weights, within 1e-4 * max(1, mean |ref|);
3. serves the flagship (O96, r5, C=256, 8 layers in 2 chunks, 4 heads, bf16,
   batch 1, two input steps) through ``AnemoiModelInterface.predict_step``:
   three requests on seeded inputs, finite outputs of the right shape, and
   exactly 10 launches of each kernel per request.

Prints the card's name and power limit, per-phase numbers, one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result line, on any failure or when there is no card.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from anemoi_models_tpu_torch.data_indices import IndexCollection
from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.ops import edge_attention as ea
from anemoi_models_tpu_torch.ops.kernels import build_log, load_kernels
from anemoi_models_tpu_torch.utils import DotDict

SOURCE = "anemoi_models_tpu_torch/csrc/edge_attention.cu"
REPLACES = "anemoi_models_tpu/ops/pallas/edge_attention.py:626"  # _feats_kernel
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
NAME_TO_INDEX = {"lsm": 0, "z_500": 1, "t_850": 2, "q_700": 3, "t2m": 4, "tp": 5}
EDGE_ATTRS = ["edge_length", "edge_dirs"]
TRAINABLE_EDGES = 4


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events over ``iters`` calls after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want, tol: float, what: str) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        bad = (got - want).abs() - tol * want.abs()
        raise AssertionError(f"{what}: kernel disagrees with plain (worst excess {bad.max().item():.3e}, tol {tol})")
    return (got - want).abs().max().item()


def model_config(num_channels: int, num_layers: int, num_chunks: int, dtype: str) -> DotDict:
    """The flagship config of the JAX package's entry point, written for the port."""
    mapper = {
        "trainable_size": TRAINABLE_EDGES,
        "num_heads": 4,
        "sub_graph_edge_attributes": EDGE_ATTRS,
    }
    return DotDict({
        "data": {
            "forcing": ["lsm"],
            "diagnostic": ["tp"],
            "processors": {
                "normalizer": {
                    "_target_": "anemoi.models.preprocessing.normalizer.InputNormalizer",
                    "config": {"default": "mean-std"},
                },
            },
        },
        "graph": {"data": "data", "hidden": "hidden"},
        "training": {"multistep_input": 2},
        "model": {
            "num_channels": num_channels,
            "compute_dtype": dtype,
            "trainable_parameters": {"hidden": 8},
            "model": {"_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"},
            "encoder": {"_target_": "anemoi.models.layers.mapper.GraphTransformerForwardMapper", **mapper},
            "processor": {
                "_target_": "anemoi.models.layers.processor.GraphTransformerProcessor",
                "num_layers": num_layers,
                "num_chunks": num_chunks,
                "graph_impl": "pallas",
                **mapper,
            },
            "decoder": {"_target_": "anemoi.models.layers.mapper.GraphTransformerBackwardMapper", **mapper},
        },
    })


def statistics(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    n = len(NAME_TO_INDEX)
    return {
        "mean": rng.rand(n) * 10,
        "stdev": rng.rand(n) + 0.5,
        "minimum": np.zeros(n),
        "maximum": np.ones(n) * 20,
    }


def interface(graph, cfg: DotDict, device, seed: int) -> AnemoiModelInterface:
    """Interface with seeded flax-style weights; trainable tensors (zero at
    init) get seeded noise so the edge- and node-attribute paths carry signal."""
    iface = AnemoiModelInterface(
        config=cfg, graph_data=graph, statistics=statistics(seed),
        data_indices=IndexCollection(cfg, NAME_TO_INDEX), device=device,
    )
    gen = torch.Generator().manual_seed(seed)
    iface.init_params(gen)
    with torch.no_grad():
        for p in iface.model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen).to(p.device))
    return iface


def phase_kernels(graph, dev) -> tuple[dict, list]:
    """Kernel against plain at main-path shapes; returns per-kernel summary
    (bf16, the serving dtype) and a row per case."""
    gen = torch.Generator().manual_seed(0)
    c, h = 256, 4
    n_hidden = graph["hidden"].num_nodes
    rows, summary = [], {"kv_proj": {}, "edge_attn_csr": {}}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    def record(name, shape, dtype, err, ms, plain_ms):
        rows.append({"kernel": name, "shape": shape, "dtype": str(dtype).split(".")[-1],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        if dtype == torch.bfloat16:
            s = summary[name]
            s["max_abs_err"] = max(s.get("max_abs_err", 0.0), err)
            if shape.startswith("processor") or name == "kv_proj":
                s["ms"], s["plain_ms"] = ms, plain_ms

    f32 = randn(n_hidden, c)
    w32 = randn(2 * c, c, scale=c ** -0.5)
    b32 = randn(2 * c, scale=0.1)
    for dt in (torch.float32, torch.bfloat16):
        f, w, b = f32.to(dev, dt), w32.to(dev, dt), b32.to(dev)
        got, want = ea.kv_proj(f, w, b), ea.kv_proj_plain(f, w, b)
        torch.cuda.synchronize()
        err = max_err(got, want, TOL[dt], f"kv_proj {dt}")
        record("kv_proj", f"processor {n_hidden}x{c} . {c}x{2 * c}", dt, err,
               cuda_ms(lambda: ea.kv_proj(f, w, b)), cuda_ms(lambda: ea.kv_proj_plain(f, w, b)))

    cases = {
        "processor": ("hidden", "hidden"),
        "encoder": ("data", "hidden"),
        "decoder": ("hidden", "data"),
    }
    for label, (s_name, d_name) in cases.items():
        es = graph[(s_name, "to", d_name)]
        ns, nd = graph[s_name].num_nodes, graph[d_name].num_nodes
        rowptr, src = ea.csr_from_edge_index(es.edge_index, ns, nd)
        static = torch.from_numpy(es.attr_tensor(EDGE_ATTRS))
        a32 = torch.cat([static, randn(es.num_edges, TRAINABLE_EDGES, scale=0.1),
                         torch.ones(es.num_edges, 1)], dim=-1)
        q32, kv32 = randn(nd, c), randn(ns, 2 * c)
        wa32 = randn(a32.shape[1], c, scale=0.3)
        rp, sr = torch.from_numpy(rowptr).to(dev), torch.from_numpy(src).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            q, kv, a, wa = (t.to(dev, dt) for t in (q32, kv32, a32, wa32))
            got = ea.edge_attn_csr(q, kv, rp, sr, a, wa, h)
            want = ea.edge_attn_csr_plain(q, kv, rp, sr, a, wa, h)
            torch.cuda.synchronize()
            err = max(max_err(g, w_, TOL[dt], f"edge_attn_csr {label} {dt} {n}")
                      for g, w_, n in zip(got, want, ("num", "den", "m")))
            record("edge_attn_csr", f"{label} E={es.num_edges} Nd={nd} Ns={ns}", dt, err,
                   cuda_ms(lambda: ea.edge_attn_csr(q, kv, rp, sr, a, wa, h)),
                   cuda_ms(lambda: ea.edge_attn_csr_plain(q, kv, rp, sr, a, wa, h), iters=5))

    # destinations without edges: m = -1e30, den = 0, num = 0, never NaN
    es = graph[("hidden", "to", "hidden")]
    dst = es.edge_index[1]
    keep = dst % 7 != 3
    rowptr, src = ea.csr_from_edge_index(es.edge_index[:, keep], n_hidden, n_hidden)
    rp, sr = torch.from_numpy(rowptr).to(dev), torch.from_numpy(src).to(dev)
    a = torch.cat([torch.from_numpy(es.attr_tensor(EDGE_ATTRS))[keep],
                   randn(int(keep.sum()), TRAINABLE_EDGES + 1)], dim=-1).to(dev)
    q, kv, wa = randn(n_hidden, c).to(dev), randn(n_hidden, 2 * c).to(dev), randn(a.shape[1], c).to(dev)
    got = ea.edge_attn_csr(q, kv, rp, sr, a, wa, h)
    want = ea.edge_attn_csr_plain(q, kv, rp, sr, a, wa, h)
    torch.cuda.synchronize()
    dead = torch.from_numpy(np.arange(n_hidden) % 7 == 3).to(dev)
    if not (bool((got.m[dead] == -1e30).all()) and bool((got.den[dead] == 0).all())
            and bool((got.num[dead] == 0).all())):
        raise AssertionError("edge_attn_csr: dead destinations break the m-gauge contract")
    err = max(max_err(g, w_, TOL[torch.float32], f"edge_attn_csr dead-destination {n}")
              for g, w_, n in zip(got, want, ("num", "den", "m")))
    rows.append({"kernel": "edge_attn_csr", "shape": f"dead destinations {int(dead.sum())}",
                 "dtype": "float32", "max_abs_err": err})
    return summary, rows


def phase_reduced_model(dev) -> dict:
    """Reduced fp32 model: kernels on the card against plain on the CPU."""
    graph = build_enc_proc_dec_graph(grid_lat=48, mesh_refinements=4, grid="octahedral")
    cfg = model_config(num_channels=64, num_layers=2, num_chunks=1, dtype="float32")
    cpu = interface(graph, cfg, "cpu", seed=1)
    gpu = interface(graph, cfg, "cpu", seed=1).to(dev)
    n_in = len(cpu.data_indices.internal_model.input)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 2, 1, graph["data"].num_nodes, n_in).astype(np.float32))
    t0 = time.perf_counter()
    ref = cpu.forward(x)
    cpu_s = time.perf_counter() - t0
    out = gpu.forward(x.to(dev)).cpu()
    scale = max(1.0, ref.abs().mean().item())
    err = (out - ref).abs().max().item()
    if not torch.isfinite(out).all() or err > 1e-4 * scale:
        raise AssertionError(f"reduced model: GPU kernels vs CPU plain max err {err:.3e} > {1e-4 * scale:.3e}")
    return {"grid": graph["data"].num_nodes, "hidden": graph["hidden"].num_nodes,
            "max_abs_err": err, "bound": 1e-4 * scale, "cpu_forward_s": cpu_s}


def phase_serving(graph, dev) -> dict:
    """Flagship bf16 serving through predict_step; per-request launch counts."""
    cfg = model_config(num_channels=256, num_layers=8, num_chunks=2, dtype="bfloat16")
    iface = interface(graph, cfg, dev, seed=3)
    n_grid = graph["data"].num_nodes
    di = iface.data_indices
    n_in, n_out = len(di.data.input.full), len(di.data.output.full)
    stats = iface.statistics
    in_idx = np.asarray(di.data.input.full)
    requests = []
    for seed in (10, 11, 12, 13):
        rng = np.random.RandomState(seed)
        raw = stats["mean"][in_idx] + stats["stdev"][in_idx] * rng.randn(1, 2, n_grid, n_in)
        requests.append(torch.from_numpy(raw.astype(np.float32)).to(dev))

    iface.predict_step(requests[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in ea.LAUNCHES:
        ea.LAUNCHES[key] = 0
    ms, per_request = [], []
    for batch in requests[1:]:
        before = dict(ea.LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = iface.predict_step(batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        per_request.append({k: ea.LAUNCHES[k] - before[k] for k in ea.LAUNCHES})
        if tuple(y.shape) != (1, 1, n_grid, n_out) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"serving: bad output shape {tuple(y.shape)} or non-finite values")
    launches = dict(ea.LAUNCHES)
    for counts in per_request:
        if counts != {"kv_proj": 10, "edge_attn_csr": 10}:
            raise AssertionError(f"serving: expected 10 launches of each kernel per request, got {counts}")
    return {"request_ms": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "per_request": per_request}


def main() -> None:
    name_power = card()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no card to test")
    dev = torch.device("cuda", 0)
    print(f"card: {name_power}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    load_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print(build_log().strip())

    t0 = time.perf_counter()
    graph = build_enc_proc_dec_graph(grid_lat=96, mesh_refinements=5, grid="octahedral")
    print(f"graph O96 r5: {graph['data'].num_nodes} grid, {graph['hidden'].num_nodes} hidden, "
          f"built in {time.perf_counter() - t0:.1f} s")

    summary, rows = phase_kernels(graph, dev)
    for row in rows:
        print("kernel-vs-plain", json.dumps(row))
    reduced = phase_reduced_model(dev)
    print("reduced-model", json.dumps(reduced))
    serving = phase_serving(graph, dev)
    print("serving", json.dumps(serving))
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": serving["launches"][name], **summary[name]}
        for name in ("kv_proj", "edge_attn_csr")
    ]
    print(name_power)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
