"""Smoke test of the PyTorch port on one CUDA card (H100).

Builds the port's CUDA kernels from ``anemoi_models_tpu_torch/csrc``, then:

1. holds each forward kernel against its plain PyTorch version on the card,
   at the shapes of the O96 / refinement-5 main path (kv_proj on the mesh's
   10,242 nodes and the grid's 40,320, two calls bit-identical, with
   torch.addmm as its library call; edge_attn_csr on the real processor,
   encoder and decoder edge sets, two calls bit-identical; a case with
   destinations that have no edge), fp32 within atol = rtol = 1e-5 (only the
   summation order differs)
   and bf16 within 2e-2, and times both with CUDA events around launches
   queued behind a device sleep (kernel_turns.cuda_ms: device time, not the
   host's issue rate), and each wrapper's host microseconds per call;
2. holds the backward kernel (edge_attn_csr_bwd) against its plain version at
   the same three edge sets and the dead-destination case, in fp32 and bf16:
   ``max |kernel - plain| <= 1e-4 * max(1, max |plain|)`` per output (both
   read the same inputs and sum in fp32, in another order), and two calls
   bit-identical; then both edge-attention kernels at the production width
   (C = 1024, 16 heads: four head groups a row) on the same three edge sets,
   at the same bounds, two calls of each bit-identical, and at C = 256 on
   the processor set with A2 = 8, 17, 24, 32, 33, 48 and 64 edge
   attributes and at C = 1024 with 24 and 32, each timed beside its bound;
   and the two other backward kernels against their plain twins, two calls
   bit-identical: gnn_conv_bwd (the GNN conv's, from the forward's inputs
   and both cotangents) on the three O96 edge sets at C = 256 (three Dense,
   the fused forward's shape) and C = 1024, and at C = 36 (padded to 40),
   fp32 within 1e-4 and bf16 within 2e-2 normwise; flash_attention_bwd at
   (B*H, N, D) = (4, 10,242, 64) with w = 512, causal, dropout 0.1 and a
   rank's rows at offsets, fp32 1e-4 and bf16 2e-2 normwise, from the
   forward's row log-sum-exp, whose output is bit for bit the one without
   it; each timed beside its bound and, for flash, the backward of SDPA
   with the same boolean mask as its library call;
3. runs a reduced model (O48 grid, refinement-4 mesh, C=64, 2 layers; and,
   for the GraphTransformer, the production width C=1024 with 16 heads on a
   16-latitude grid and a refinement-3 mesh) in fp32 through the kernels on
   the card and through the plain versions on the CPU, from the same seeded
   weights: the forward within
   1e-4 * max(1, mean |ref|), every parameter's gradient within
   1e-4 * max(1, max |ref grad|), and a 3-step make_optimizer loss trace
   within rtol 6e-4 (the reference's bound for loss traces);
4. serves the flagship (O96, r5, C=256, 8 layers in 2 chunks, 4 heads, bf16,
   batch 1, two input steps) through ``AnemoiModelInterface.predict_step``:
   three requests on seeded inputs, finite outputs of the right shape, and
   exactly 10 launches of each forward kernel per request;
5. trains the flagship at full width with ``make_train_step`` +
   ``make_optimizer`` (``remat_policy="full"``, bench.py's default): one
   warm-up step and three timed steps on one seeded batch, finite losses,
   the last below the first, launches per step (20 kv_proj, 20 edge_attn_csr:
   10 forward, 8 recomputed processor layers and 2 recomputed mapper blocks,
   and 10 edge_attn_csr_bwd), peak memory; then one step with
   ``remat_policy="none"`` (12 of each forward kernel: the mapper blocks are
   recomputed under every policy; 10 edge_attn_csr_bwd);
6. holds the GNN conv kernel (gnn_conv) against its plain version at the
   three O96 edge sets (the processor's as a self-graph, the mappers'
   bipartite) and the dead-destination set, its per-node pre-pass
   (gnn_prepass) alone against node_products at fp32 1e-5 and timed apart,
   two calls bit-identical: agg
   within 1e-5 of the plain sum of the kernel's own msg; msg and agg
   against plain within fp32 1e-5 (elementwise) and bf16 2e-2 (normwise,
   ``max |kernel - plain| <= 2e-2 * max(1, max |plain|)``: both round at the
   same points from fp32 sums taken in another order, and a bf16 step taken
   before ``+ beta`` or ``+ e`` stays as an absolute error where that sum
   cancels); and the band-masked attention kernel
   (flash_attention) at (B*H, N, D) = (4, 10,242, 64) with w = 512, no
   window, a ragged N and a causal window, fp32 1e-5 and bf16 2e-2, reading
   q, k, v as strided views of one fused projection, as the model does, two
   calls bit-identical; then gnn_conv's layered route (every width and MLP
   depth the fused kernels do not take) at C = 384, 512, 1024 and at C =
   256 with one and two extra hidden Dense layers, on the three edge sets,
   fp32 and bf16, at the same bounds, two calls bit-identical, with each
   call's peak memory and, at C = 1024 in bf16, its device time split by
   launch (pre-pass, row table, Dense 0, hidden Dense, last Dense,
   LayerNorm pass, sum); and at C = 1024 with two samples, with the processor's set cut by
   the chunk inside a destination's row, and with dead destinations;
7. for each of the GNN and Transformer flavors (the other two processor
   families of ``__graft_entry__._build``): the reduced fp32 check of 3.,
   three O96 bf16 ``predict_step`` requests (per request 10 gnn_conv
   launches: 8 processor layers and 2 mappers; or 8 flash_attention, 2
   kv_proj and 2 edge_attn_csr) and four O96 bf16 train steps with
   ``remat_policy="full"`` (finite losses, the last below the first;
   launches per step: 20 gnn_conv and 10 gnn_conv_bwd; or 16
   flash_attention, 8 flash_attention_bwd and 4 of each GraphTransformer
   mapper kernel); no GNN or Transformer train step of any phase reaches
   the plain versions (``no_plain``: they raise for the length of a step);
8. the GraphTransformer at the production width of
   ``anemoi_models_tpu/configs.py`` (C = 1024, 16 heads; O96, r5, 8 layers in
   2 chunks, bf16, batch 1, ``remat_policy="full"``): three ``predict_step``
   requests and three train steps (peak learning rate 1e-5) after a warm-up
   of each, finite outputs, finite losses with the last below the first, the
   flagship's launches per request and step, peak memory; and the GNN at C =
   1024 (the layered route): three requests and two train steps at the same
   learning rate, finite, with launches and peak memory, beside a reduced
   fp32 GNN at C = 512 with ``mlp_extra_layers=1`` against the CPU;
9. the trained flagship saved with ``AnemoiModelInterface.save`` and served
   again through ``from_checkpoint(device="cuda")``: ``predict_step``
   bit-identical, the bytes on disk and the save and load seconds;
10. the flagship's forecast, ``predict_rollout`` over 4 lead times with
    seeded forcings (a warm-up and three timed calls, 40 launches of each
    forward kernel a call, the first lead time ``predict_step``'s bits), and
    its rollout fine-tuning step (``make_rollout_train_step``, 2 lead times,
    remat "full": a warm-up and three steps, finite falling losses, twice a
    train step's launches, peak memory);
11. for each flavor, two models built from one seed and two train steps of
    each on one batch: the losses, every parameter and every AdamW moment
    bit for bit identical;
12. both edge-attention kernels at the head widths of the hierarchical model
    (D = 128 and 256 on the O96 pyramid's r4 / r3 level processors and its
    r5->r4, r4->r3 downscale and r4->r5, r3->r4 upscale edge sets) and at
    head widths that are not powers of two (D = 96 and 48 on the flat
    processor's set), fp32 and bf16, at the flagship's bounds, two calls of
    each bit-identical, timed beside their bounds (the GNN conv's layered
    route also at C = 36, 100 and 260, padded to a multiple of 8, in 6.);
    and a reduced fp32 hierarchical model (a 16-latitude grid, 3 levels on an
    r3 mesh, C = 64 with 1 head, so that D reaches 256 on the coarsest
    level, and with 4 heads) against the CPU as in 3.;
13. bench.py's hierarchical model (``BENCH_MODEL=hierarchical``, built
    through ``configs.hierarchical`` and ``build_hierarchical_graph``): the
    O96 grid and the r5 / r4 / r3 pyramid (10,242 / 2,562 / 642 nodes), C =
    256 / 512 / 1024 with 4 heads, level processors of 2 layers, bf16,
    batch 1, remat "full": three requests and three train steps at lr 1e-5
    after a warm-up of each, finite, falling losses, the launches of
    ``EXPECTED["hierarchical"]``, peak memory, and a profiled request and
    step for the device's busy share;
14. the flagship under the AIFS data path (``aifs_config``: a normalizer, an
    InputImputer on the sst's seeded land points, a log1p Monomapper on
    precipitation and the four boundings in config order): fit_processors,
    three requests with NaN exactly at the imputer's land points and the
    bounded variables within bounds, a 4-lead-time predict_rollout, two
    train steps with the imputer's loss mask, a checkpoint round trip with
    the imputer state served bit for bit, and the same config reduced (fp32)
    on the card against the CPU through the whole pipeline;
15. the training driver (``phase_train_run``): a synthetic O96 record (8
    variables, 2 of them forcings, 32 steps) written as a zarr store by the
    port's writer and read back bit for bit, then ``train_run`` on the
    flagship from it: 2 ensemble members, the fair CRPS, the rollout
    curriculum [(0, 1), (4, 2)], 8 steps, EMA, evals of a 2-lead-time
    rollout on the held-out tail, checkpoints every 4 steps in the
    graph-once layout, the exact launches of the run; then the same run
    boxed at 4 steps and resumed, bit for bit the uninterrupted run's losses,
    evals, parameters, AdamW moments and EMA; ms a step by CUDA events, the
    busy share from a profiled window, the loop's wait on the loader, peak
    memory;
16. attention-weight dropout (``phase_dropout``): flash_attention with p =
    0.1 against the blockwise version under one key at the O96 processor's
    shape, repeats bit-identical, another key another output, p = 0 the
    dropout-free bits, the kernel's keep rate within 5 sigma of 0.9; and
    ``train_run`` of the O96 Transformer flavor with dropout_p = 0.1;
17. the head widths (``phase_head_widths``): both edge-attention kernels at
    D = 320, 512, 1024 (flat processor set, and the hierarchical r3 level
    set at D = 1024) and D = 10 (padded), flash_attention at D = 24, 48, 96,
    256, 512, each against its plain version; reduced fp32 models at C =
    1024 with 2 (GraphTransformer) and 4 (Transformer) heads against the
    CPU, and three bf16 requests and train steps of each;
18. the command line in-process (``phase_cli``): ``train``, ``predict`` and
    ``evaluate`` of the port's CLI on a 16-latitude grid, exit codes 0,
    finite outputs;
19. model parallelism (``phase_parallel``): each flavor's O96 flagship
    (bf16, C = 256, 8 layers in 2 chunks, batch 1) sharded over two gloo
    ranks that share this card (nccl refuses two ranks on one device;
    data = 1, model = 2), spawned after the parent has built the kernels:
    the sharded forward, one train step's loss, reduced gradients and
    updated parameters (AdamW at a constant lr 1e-4) against the unsharded
    run on the same card (bf16 normwise 2e-2), the step again from the same
    state bit for bit, the GraphTransformer's 2-lead-time rollout train
    step's loss, and each rank's launches: the halo processors and the
    destination-sharded mappers run ``kv_proj``, ``edge_attn_csr`` and
    ``edge_attn_csr_bwd`` (GT) and ``gnn_conv`` (GNN), the attention
    ``flash_attention`` on the rank's rows; the same for the Transformer on
    the gathered keys' path (its window with ``attention_impl="chunked"``,
    and no window) and bench.py's hierarchical model (r5 / r4 / r3, C = 256
    / 512 / 1024, lr 1e-5: every level split over the ranks, each level
    processor on its own halo plan, the level mappers destination-sharded);
    call ms of two ranks sharing one card beside the unsharded run's, not a
    speed across cards. A failing rank fails the run. Phase 6's flash checks
    include a rank's rows of that split (``flash_offset_cases``: the halo
    and gathered keys' shapes, and dropout drawn at global positions);
20. the memory policies of a train step (``phase_memory``): the
    GraphTransformer (16 heads) and the GNN (the layered route) at C = 1024
    on O96 / r5, 8 layers in 2 chunks, bf16, batch 1, 3 steps each (the
    first a warm-up) under remat "full", "save_dots", "none" and
    cpu_offload on every unit: step ms, peak memory, the host bytes
    cpu_offload holds, launches a step (the mapper blocks recomputed under
    every remat policy, the chunks under "full" and "save_dots"), and the
    losses, gradients and parameters bit-identical across the four; the
    Transformer at C = 256 with dropout 0.1, one step under "save_dots" and
    one under cpu_offload, bit-identical to "full"'s; the ``remat_policy=
    "auto"`` resolver on the GT step (its estimate beside the measured
    "none" peak, at least 0.85x of it; "none" at the card's budget, "full"
    at 1 KiB) and ``train_run(remat_policy="auto")`` for 2 steps on the O96
    record (2 lead times, 2 members, CRPS, EMA: the variant it estimates);
    and the GT at C = 256 on O320 / r6 (421,120 points) for 2 steps
    under "full" and cpu_offload, with its peak memory;
21. the ``bench`` command's function (``phase_bench``): each flavor's O96
    flagship and the hierarchical model, forward and train, at bench.py's
    defaults (C = 256, 8 layers, bf16, batch 1, remat "full"), 3 windows of
    10 calls by CUDA events, each printing bench.py's JSON line with
    ``mfu_frac`` (in (0, 1.05]), the kernels' calls a call (the FLOP
    count's) equal to the requests' and steps' launches above; the FLOP
    count of a reduced model of each flavor the same on the card and on the
    CPU route; the bench's forward bit for bit ``predict_step``'s model call.

Prints the card's name and power limit, each kernel's registers and spills
from the compiler's report (``ptxas``), per-phase numbers, each wrapper's
host microseconds per call (``host-us``), one JSON line ``{"kernels":
[...]}`` and, last, ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result line, on any failure or when there is no card.

    python3 chip_smoke.py                      # what the checks need
    python3 chip_smoke.py --profile OUT_DIR    # also profile a train step and a request per path
                                               # (the hierarchical path's always, into build/ by default)
    python3 chip_smoke.py --build-times DIR    # also time cold kernel builds
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from anemoi_models_tpu_torch import configs
from anemoi_models_tpu_torch.checkpoint import load_checkpoint
from anemoi_models_tpu_torch.commands import bench
from anemoi_models_tpu_torch.commands.bench import NAME_TO_INDEX
from anemoi_models_tpu_torch.data_indices import IndexCollection
from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph, build_hierarchical_graph
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.ops import cost
from anemoi_models_tpu_torch.ops import edge_attention as ea
from anemoi_models_tpu_torch.ops import flash_attention as fa
from anemoi_models_tpu_torch.ops import gnn_conv as gc
from anemoi_models_tpu_torch.ops import kernels
from anemoi_models_tpu_torch.ops.kernels import build_log, load_kernels
from anemoi_models_tpu_torch.parallel import make_mesh, use_mesh
from anemoi_models_tpu_torch.training import (
    AdamW,
    WeightedMSELoss,
    loss_mask,
    make_optimizer,
    make_rollout_train_step,
    make_train_step,
    weighted_mse,
)
from anemoi_models_tpu_torch.utils import DotDict
from kernel_turns import card, cuda_ms, host_us, kernels_per_call, layered_split

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "kv_proj": ("anemoi_models_tpu_torch/csrc/gemm_sm90.cuh",
                "anemoi_models_tpu/ops/pallas/edge_attention.py:626"),  # _feats_kernel
    "edge_attn_csr": ("anemoi_models_tpu_torch/csrc/edge_attention.cu",
                      "anemoi_models_tpu/ops/pallas/edge_attention.py:626"),  # _feats_kernel
    "edge_attn_csr_bwd": ("anemoi_models_tpu_torch/csrc/edge_attention_bwd.cu",
                          "anemoi_models_tpu/ops/pallas/edge_attention.py:781"),  # _feats_bwd_kernel
    "gnn_conv": ("anemoi_models_tpu_torch/csrc/gnn_conv.cu",
                 "anemoi_models_tpu/ops/pallas/gnn_conv.py:30"),  # _kernel
    "gnn_conv_layered": ("anemoi_models_tpu_torch/csrc/gnn_conv_layered.cu",
                         "anemoi_models_tpu/ops/pallas/gnn_conv.py:30"),  # _kernel, every other width and depth
    "flash_attention": ("anemoi_models_tpu_torch/csrc/flash_attention.cu",
                        "anemoi_models_tpu/ops/pallas/flash_attention.py:38"),  # _flash_kernel
    # the two backward kernels: the gradients of the TPU kernels the JAX package differentiates through their
    # jnp twins (ops/slot_gnn.py:conv_bwd, ops/pallas/flash_attention.py:_bwd)
    "gnn_conv_bwd": ("anemoi_models_tpu_torch/csrc/gnn_conv_bwd.cu",
                     "anemoi_models_tpu/ops/pallas/gnn_conv.py:30"),  # _kernel's gradient
    "flash_attention_bwd": ("anemoi_models_tpu_torch/csrc/flash_attention_bwd.cu",
                            "anemoi_models_tpu/ops/pallas/flash_attention.py:38"),  # _flash_kernel's gradient
}
LAUNCH_TABLES = (ea.LAUNCHES, gc.LAUNCHES, fa.LAUNCHES)
FLAVOR_KERNEL = {"graphtransformer": "edge_attn_csr", "gnn": "gnn_conv", "transformer": "flash_attention"}
# launches per request and per train step (remat "full") of each flavor's O96 flagship: a step
# recomputes the processor's 8 layers and, under every policy, the 2 mapper blocks, and runs one backward
# kernel a layer; the GNN at C = 1024 ("gnn production") runs the same count on the layered route
EXPECTED = {
    "graphtransformer": ({"kv_proj": 10, "edge_attn_csr": 10},
                         {"kv_proj": 20, "edge_attn_csr": 20, "edge_attn_csr_bwd": 10}),
    "gnn": ({"gnn_conv": 10}, {"gnn_conv": 20, "gnn_conv_bwd": 10}),
    "transformer": ({"flash_attention": 8, "kv_proj": 2, "edge_attn_csr": 2},
                    {"flash_attention": 16, "flash_attention_bwd": 8, "kv_proj": 4, "edge_attn_csr": 4,
                     "edge_attn_csr_bwd": 2}),
    "gnn production": ({"gnn_conv_layered": 10}, {"gnn_conv_layered": 20, "gnn_conv_bwd": 10}),
    # the 3-level hierarchical model: 16 attention convs a request (encoder, 3 + 2 level processors of 2
    # layers, 2 downscale and 2 upscale mappers, decoder); a train step recomputes the level processors'
    # 10 layers (remat "full") and the 6 mapper blocks, and runs 16 backward
    "hierarchical": ({"kv_proj": 16, "edge_attn_csr": 16},
                     {"kv_proj": 32, "edge_attn_csr": 32, "edge_attn_csr_bwd": 16}),
}
# the AIFS data path: an sst over the sea only (imputed), cloud cover, precipitation and its convective part
AIFS_NAME_TO_INDEX = {"lsm": 0, "z_500": 1, "t_850": 2, "sst": 3, "tcc": 4, "t2m": 5, "tp": 6, "cp": 7}
AIFS_BOUNDING = [  # all four, in config order
    {"_target_": "anemoi.models.layers.bounding.ReluBounding", "variables": ["tp"]},
    {"_target_": "anemoi.models.layers.bounding.HardtanhBounding", "variables": ["tcc"], "min_val": 0.0,
     "max_val": 1.0},
    {"_target_": "anemoi.models.layers.bounding.FractionBounding", "variables": ["cp"], "min_val": 0.0,
     "max_val": 1.0, "total_var": "tp"},
    {"_target_": "anemoi.models.layers.bounding.LeakyReluBounding", "variables": ["z_500"]},
]
# (label, (source, destination) node sets, C, heads): the O96 hierarchical model's edge sets at the widths
# its modules run them (hidden_dims 256 / 512 / 1024 with 4 heads: D = 128 on r4, 256 on r3)
HIER_ATTN = (
    ("r4 level processor", ("hidden_2", "hidden_2"), 512, 4),
    ("r3 level processor", ("hidden_3", "hidden_3"), 1024, 4),
    ("r5->r4 downscale", ("hidden_1", "hidden_2"), 512, 4),
    ("r4->r3 downscale", ("hidden_2", "hidden_3"), 1024, 4),
    ("r4->r5 upscale", ("hidden_2", "hidden_1"), 512, 4),
    ("r3->r4 upscale", ("hidden_3", "hidden_2"), 1024, 4),
)
# and the flat processor's set at head widths that are not powers of two (the lanes pad each head)
FLAT_ATTN = (("processor D=96", ("hidden", "hidden"), 384, 4), ("processor D=48", ("hidden", "hidden"), 192, 4))
# the flat graph's three sets at the production width (C = 1024, 16 heads: four head groups a row)
WIDE_ATTN = tuple((label, names, 1024, 16) for label, names in (
    ("processor", ("hidden", "hidden")), ("encoder", ("data", "hidden")), ("decoder", ("hidden", "data"))))
# edge attribute counts (A2 with the ones column; the static edge_length and edge_dirs are 3): the
# flagship's processor set at A2 = 8 to 64, and the production width at A2 = 24 and 32 (in fp32 the
# backward of the first design refused them)
A2_ATTN = tuple(("processor", ("hidden", "hidden"), 256, 4, a2 - 4) for a2 in (8, 17, 24, 32, 33, 48, 64)) + \
    tuple(("processor", ("hidden", "hidden"), 1024, 16, a2 - 4) for a2 in (24, 32))
ROLLOUT_STEPS = 4  # lead times of the rollout phase
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = 1e-4
EDGE_ATTRS = ["edge_length", "edge_dirs"]
TRAINABLE_EDGES = 4
# device kernels of a profiled step, grouped by what they do (first match)
PROFILE_KINDS = [
    ("edge_attn_csr_bwd (4 phases)", ("bwd_dst_kernel", "bwd_src_kernel", "dw_parts_kernel", "dw_reduce_kernel")),
    ("gnn_conv_bwd fused chain", ("gnn_bwd_chain_kernel",)),
    ("gnn_conv_bwd products", ("ZPairs", "DaPairs", "mn_gemm_kernel", "gnn_bwd_f32_kernel")),
    ("gnn_conv_bwd LayerNorm, transposes, sums",
     ("gnn_ln_bwd", "gnn_transpose_kernel", "gnn_dst_sum_kernel", "gnn_src_sum_kernel", "gnn_sum_segs")),
    ("flash_attention_bwd", ("flash_bwd_",)),
    ("gnn_conv layered row table", ("gnn_rows_kernel",)),
    ("gnn_conv layered Dense 0", ("gnn_dense0_tag",)),
    ("gnn_conv layered hidden Dense", ("gnn_dense_tag",)),
    ("gnn_conv layered last Dense", ("gnn_dense_last_tag",)),
    ("gnn_conv layered LayerNorm pass", ("gnn_ln_kernel",)),
    ("gnn_conv pre-pass", ("gnn_prepass_tag",)),
    ("gnn_conv fused message", ("gnn_msg_",)),
    ("gnn_conv sum", ("gnn_agg_kernel",)),
    ("flash_attention", ("flash_attn_bf16_kernel", "flash_attn_f32_kernel")),
    ("kv_proj", ("kv_proj_tag",)),
    ("edge_attn_csr", ("edge_attn_csr_kernel",)),
    ("optimizer (multi-tensor)", ("multi_tensor", "lpnorm")),
    ("LayerNorm forward + backward", ("layer_norm", "GammaBeta")),
    ("GEMM (cuBLAS, CUTLASS)", ("gemm", "nvjet", "cutlass")),
    ("copies and dtype casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("GELU forward + backward", ("Gelu",)),
]


def bound(nbytes: float, flops: float, peak: str) -> dict:
    """The least time the card could take: max(bytes / HBM rate, operations
    / peak rate for their type), in ms, and which of the two binds."""
    by_bytes, by_ops = nbytes / cost.HBM_BPS * 1e3, flops / cost.PEAK_FLOPS[peak] * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops, "peak": peak}


def build_times(out_dir: str, repeats: int = 2) -> dict:
    """Wall seconds of a cold build of the kernel library two ways, into
    ``out_dir``, alternated: the package's build (one nvcc per source, all
    started together, then a link) and one nvcc call over every source."""
    os.makedirs(out_dir, exist_ok=True)
    cu = [p for p in kernels._sources() if p.endswith(".cu")]
    one_call = [kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared", "-o", os.path.join(out_dir, "one_call.so"), *cu]
    times: dict[str, list] = {"parallel_s": [], "one_call_s": []}
    for _ in range(repeats):
        t0 = time.perf_counter()
        kernels._build(os.path.join(out_dir, "parallel.so"))
        times["parallel_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        subprocess.run(one_call, check=True, capture_output=True, timeout=900)
        times["one_call_s"].append(time.perf_counter() - t0)
    return {"sources": len(cu), **times}


def ptxas_summary(log: str) -> list[dict]:
    """Registers, spills and stack per kernel from nvcc's ``-Xptxas -v``
    report, each kernel's mangled name cut to its template-id."""
    rows, name = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            mangled = found.group(1)
            short = re.search(r"\d+((?:bwd|dw|flash|edge|gnn|proj)_\w*?kernel\w*?)E+(?=v|P)", mangled)
            name = short.group(1) if short else mangled[:80]
            bn = re.search(r"ws_gemm_kernelILi(\d+)E", mangled)
            tag = re.search(r"\d+(gnn_\w+?_tag)", mangled)
            if bn and tag:  # the warp-specialised GEMM, named by its N tile and its epilogue's tag
                name = f"ws_gemm_kernel<{bn.group(1)}, {tag.group(1)}>"
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            rows.append({"kernel": name, "stack": int(spill.group(1)), "spill_stores": int(spill.group(2)),
                         "spill_loads": int(spill.group(3))})
        used = re.search(r"Used (\d+) registers", line)
        if used and rows and rows[-1]["kernel"] == name and "registers" not in rows[-1]:
            rows[-1]["registers"] = int(used.group(1))
    return rows


@contextlib.contextmanager
def no_plain():
    """The GNN conv's and the band-masked attention's plain versions (and
    so any autograd over them) raise while this is open: a card train step
    inside runs the kernels alone."""
    names = ((gc, "gnn_conv_plain"), (gc, "gnn_conv_bwd_plain"), (fa, "blockwise_attention"),
             (fa, "flash_attention_bwd_plain"))
    saved = [getattr(mod, name) for mod, name in names]

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"a card train step reached the plain version {name}")
        return call

    for mod, name in names:
        setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


def reset_launches() -> None:
    for table in LAUNCH_TABLES:
        for key in table:
            table[key] = 0


def launches() -> dict:
    """Every kernel wrapper's launch count."""
    return {k: v for table in LAUNCH_TABLES for k, v in table.items()}


def expect(counts: dict, nonzero: dict) -> dict:
    """``nonzero`` with every other kernel at 0."""
    return {k: nonzero.get(k, 0) for k in counts}


def max_err(got, want, tol: float, what: str) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        bad = (got - want).abs() - tol * want.abs()
        raise AssertionError(f"{what}: kernel disagrees with plain (worst excess {bad.max().item():.3e}, tol {tol})")
    return (got - want).abs().max().item()


def normwise_err(got, want, what: str, tol: float = BWD_TOL) -> float:
    """max |got - want| / max(1, max |want|), checked against ``tol``."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    if err > tol:
        raise AssertionError(f"{what}: normwise error {err:.3e} > {tol}")
    return err


def statistics(seed: int, n: int = len(NAME_TO_INDEX)) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "mean": rng.rand(n) * 10,
        "stdev": rng.rand(n) + 0.5,
        "minimum": np.zeros(n),
        "maximum": np.ones(n) * 20,
    }


def interface(graph, cfg: DotDict, device, seed: int, name_to_index: dict | None = None,
              stats: dict | None = None) -> AnemoiModelInterface:
    """Interface with seeded flax-style weights; trainable tensors (zero at
    init) get seeded noise so the edge- and node-attribute paths carry signal."""
    name_to_index = name_to_index or NAME_TO_INDEX
    iface = AnemoiModelInterface(
        config=cfg, graph_data=graph, statistics=stats or statistics(seed, len(name_to_index)),
        data_indices=IndexCollection(cfg, name_to_index), device=device,
    )
    gen = torch.Generator().manual_seed(seed)
    iface.init_params(gen)
    with torch.no_grad():
        for p in iface.model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen).to(p.device))
    return iface


def train_batch(iface: AnemoiModelInterface, num_grid: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A seeded (x, y) pair at the model's internal widths, on the CPU."""
    rng = np.random.RandomState(seed)
    n_in = len(iface.data_indices.internal_model.input)
    n_out = len(iface.data_indices.internal_model.output)
    x = rng.randn(1, 2, 1, num_grid, n_in).astype(np.float32)
    y = rng.randn(1, 1, num_grid, n_out).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def edge_case(graph, label: str, dev, gen, c: int = 256, keep=None, h: int = 4, names=None,
              trainable: int = TRAINABLE_EDGES) -> dict:
    """One real edge set of the main path on the card, with seeded inputs:
    the flat graph's processor, encoder or decoder set, or the set between
    the node sets ``names`` (source, destination), with ``trainable``
    trainable edge features beside the static ones."""
    s_name, d_name = names or {"processor": ("hidden", "hidden"), "encoder": ("data", "hidden"),
                               "decoder": ("hidden", "data")}[label]
    es = graph[(s_name, "to", d_name)]
    ns, nd = graph[s_name].num_nodes, graph[d_name].num_nodes
    edge_index = es.edge_index if keep is None else es.edge_index[:, keep]
    rowptr, src = ea.csr_from_edge_index(edge_index, ns, nd)
    num_edges = edge_index.shape[1]
    static = torch.from_numpy(es.attr_tensor(EDGE_ATTRS))
    if keep is not None:
        static = static[torch.from_numpy(keep)]
    a = torch.cat([static, torch.randn(num_edges, trainable, generator=gen) * 0.1,
                   torch.ones(num_edges, 1)], dim=-1)
    return {
        "ns": ns, "nd": nd, "num_edges": num_edges, "a": a,
        "rowptr": torch.from_numpy(rowptr).to(dev), "src": torch.from_numpy(src).to(dev),
        "csr_t": ea.CSRTranspose(*(torch.from_numpy(t).to(dev) for t in ea.csr_transpose(rowptr, src, ns))),
        "q": torch.randn(nd, c, generator=gen), "kv": torch.randn(ns, 2 * c, generator=gen),
        "w_aug": torch.randn(a.shape[1], c, generator=gen) * 0.3,
        "g_num": torch.randn(nd, c, generator=gen), "g_den": torch.randn(nd, h, generator=gen),
    }


def attn_bounds(case: dict, c: int, h: int, dtype: torch.dtype) -> tuple[dict, dict]:
    """Bounds of edge_attn_csr and edge_attn_csr_bwd on one edge set (batch
    1): each input read once, each output written once, and the fewest
    operations the function needs, priced at the peak for the operands' type.
    The edge term e = a.w_aug factors through per-destination products with
    w_aug (2 A2 C each) and per-edge sums over the A2 attributes (2 A2 H
    each), so per edge the forward needs the logit and the weighted sum of v
    (4C) and two A2 H terms, per destination two A2 C products; the backward
    needs the logit, <g_num, v>, dq, dk and dv (10C) and six A2 H terms per
    edge (the two logit terms, da, the two sums dq and dw_aug read), and
    five A2 C products per destination (P, G, dq's e-term, dw_aug's two)."""
    nd, ns, e = case["nd"], case["ns"], case["num_edges"]
    a2 = case["a"].shape[1]
    itemsize = torch.finfo(dtype).bits // 8
    peak = "bf16 tensor" if dtype == torch.bfloat16 else "fp32"
    fwd_in = (nd * c + ns * 2 * c + e * a2 + a2 * c) * itemsize + (nd + 1 + e) * 4
    fwd = bound(fwd_in + (nd * c + 2 * nd * h) * 4, cost.edge_attn_flops(1, e, nd, c, h, a2), peak)
    bwd_in = fwd_in + (nd * h + nd * c + nd * h) * 4 + (e + ns + 1 + e) * 4
    bwd_out = (nd * c + ns * 2 * c + e * a2 + a2 * c) * 4
    bwd = bound(bwd_in + bwd_out, cost.edge_attn_bwd_flops(1, e, nd, c, h, a2), peak)
    return fwd, bwd


def phase_kernels(graph, dev) -> tuple[dict, list]:
    """Forward kernels against plain at main-path shapes; returns the
    per-kernel summary (bf16, the model's dtype; the processor's shapes) and
    a row per case."""
    gen = torch.Generator().manual_seed(0)
    c, h = 256, 4
    n_hidden = graph["hidden"].num_nodes
    rows, summary = [], {"kv_proj": {}, "edge_attn_csr": {}}

    def record(name, shape, dtype, err, ms, plain_ms, extra=None):
        rows.append({"kernel": name, "shape": shape, "dtype": str(dtype).split(".")[-1],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **(extra or {})})
        if dtype == torch.bfloat16:
            s = summary[name]
            s["max_abs_err"] = max(s.get("max_abs_err", 0.0), err)
            if shape.startswith("processor"):
                s.update({"ms": ms, "plain_ms": plain_ms, **(extra or {})})

    # kv_proj at both main-path shapes: the processor's and decoder's source (the mesh) and the
    # encoder's (the grid), K = 256, N = 512; two calls bit-identical; torch.addmm as library_ms
    w32 = torch.randn(2 * c, c, generator=gen) * c ** -0.5
    b32 = torch.randn(2 * c, generator=gen) * 0.1
    for label, m in (("processor", n_hidden), ("encoder", graph["data"].num_nodes)):
        f32 = torch.randn(m, c, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            f, w, b = f32.to(dev, dt), w32.to(dev, dt), b32.to(dev)
            got, again, want = ea.kv_proj(f, w, b), ea.kv_proj(f, w, b), ea.kv_proj_plain(f, w, b)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"kv_proj {label} {dt}: two calls differ (not run-to-run deterministic)")
            err = max_err(got, want, TOL[dt], f"kv_proj {label} {dt}")
            nbytes = (f.numel() + w.numel() + got.numel()) * f.element_size() + b.numel() * 4
            peak = "bf16 tensor" if dt == torch.bfloat16 else "fp32"
            b_dt = b.to(dt)
            extra = {**bound(nbytes, cost.kv_proj_flops(m, c, 2 * c), peak), "bit_identical": True,
                     "library_ms": cuda_ms(lambda: torch.addmm(b_dt, f, w.t())),
                     "host_us": host_us(lambda: ea.kv_proj(f, w, b))}
            record("kv_proj", f"{label} {m}x{c} . {c}x{2 * c}", dt, err,
                   cuda_ms(lambda: ea.kv_proj(f, w, b)), cuda_ms(lambda: ea.kv_proj_plain(f, w, b)), extra)

    for label in ("processor", "encoder", "decoder"):
        case = edge_case(graph, label, dev, gen, c)
        rp, sr = case["rowptr"], case["src"]
        for dt in (torch.float32, torch.bfloat16):
            q, kv, a, wa = (case[k].to(dev, dt) for k in ("q", "kv", "a", "w_aug"))
            got, again = ea.edge_attn_csr(q, kv, rp, sr, a, wa, h), ea.edge_attn_csr(q, kv, rp, sr, a, wa, h)
            want = ea.edge_attn_csr_plain(q, kv, rp, sr, a, wa, h)
            torch.cuda.synchronize()
            if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
                raise AssertionError(f"edge_attn_csr {label} {dt}: two calls differ (not run-to-run deterministic)")
            err = max(max_err(g, w_, TOL[dt], f"edge_attn_csr {label} {dt} {n}")
                      for g, w_, n in zip(got, want, ("num", "den", "m")))
            extra = {**attn_bounds(case, c, h, dt)[0], "library_ms": None, "bit_identical": True,
                     "host_us": host_us(lambda: ea.edge_attn_csr(q, kv, rp, sr, a, wa, h))}
            record("edge_attn_csr", f"{label} E={case['num_edges']} Nd={case['nd']} Ns={case['ns']}", dt, err,
                   cuda_ms(lambda: ea.edge_attn_csr(q, kv, rp, sr, a, wa, h)),
                   cuda_ms(lambda: ea.edge_attn_csr_plain(q, kv, rp, sr, a, wa, h), iters=5), extra)

    # destinations without edges: m = -1e30, den = 0, num = 0, never NaN
    keep = graph[("hidden", "to", "hidden")].edge_index[1] % 7 != 3
    case = edge_case(graph, "processor", dev, gen, c, keep)
    q, kv, a, wa = (case[k].to(dev) for k in ("q", "kv", "a", "w_aug"))
    got = ea.edge_attn_csr(q, kv, case["rowptr"], case["src"], a, wa, h)
    want = ea.edge_attn_csr_plain(q, kv, case["rowptr"], case["src"], a, wa, h)
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


def phase_backward_kernels(graph, dev) -> tuple[dict, list]:
    """The backward kernels against their plain versions, two calls
    bit-identical: edge_attn_csr_bwd at the three edge sets (and with dead
    destinations), fp32 and bf16, then :func:`gnn_backward_cases` and
    :func:`flash_backward_cases`. Returns each kernel's summary (bf16, the
    processor's or the flagship attention's shape) and a row per case."""
    gen = torch.Generator().manual_seed(1)
    c, h = 256, 4
    rows, summary, bf16_err = [], {}, 0.0
    cases = [(label, None) for label in ("processor", "encoder", "decoder")]
    cases.append(("processor", graph[("hidden", "to", "hidden")].edge_index[1] % 7 != 3))
    for label, keep in cases:
        case = edge_case(graph, label, dev, gen, c, keep)
        rp, sr, csr_t = case["rowptr"], case["src"], case["csr_t"]
        g_num, g_den = case["g_num"].to(dev), case["g_den"].to(dev)
        shape = f"{label}{' dead' if keep is not None else ''} E={case['num_edges']} Nd={case['nd']} Ns={case['ns']}"
        for dt in (torch.float32, torch.bfloat16):
            q, kv, a, wa = (case[k].to(dev, dt) for k in ("q", "kv", "a", "w_aug"))
            m = ea.edge_attn_csr(q, kv, rp, sr, a, wa, h).m
            args = (q, kv, rp, sr, a, wa, m, g_num, g_den, h)
            got, again = ea.edge_attn_csr_bwd(*args, csr_t), ea.edge_attn_csr_bwd(*args, csr_t)
            want = ea.edge_attn_csr_bwd_plain(*args)
            torch.cuda.synchronize()
            what = f"edge_attn_csr_bwd {shape} {dt}"
            for name, g, g2 in zip(("dq", "dkv", "da", "dw_aug"), got, again):
                if not torch.equal(g, g2):
                    raise AssertionError(f"{what} {name}: two calls differ (not run-to-run deterministic)")
            err = max(normwise_err(g, w_, f"{what} {n}") for g, w_, n in zip(got, want, ("dq", "dkv", "da", "dw_aug")))
            abs_err = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
            row = {"kernel": "edge_attn_csr_bwd", "shape": shape, "dtype": str(dt).split(".")[-1],
                   "normwise_err": err, "max_abs_err": abs_err, "bit_identical": True}
            if keep is None:
                row.update({
                    "ms": cuda_ms(lambda: ea.edge_attn_csr_bwd(*args, csr_t)),
                    "host_us": host_us(lambda: ea.edge_attn_csr_bwd(*args, csr_t), iters=20),
                    "plain_ms": cuda_ms(lambda: ea.edge_attn_csr_bwd_plain(*args), iters=3, warmup=1),
                    **attn_bounds(case, c, h, dt)[1], "library_ms": None,
                })
            if dt == torch.bfloat16:
                bf16_err = max(bf16_err, abs_err)
                if label == "processor" and keep is None:
                    summary = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us")}
            rows.append(row)
    gnn_summary, gnn_rows = gnn_backward_cases(graph, dev)
    flash_summary, flash_rows = flash_backward_cases(dev)
    return ({"edge_attn_csr_bwd": {**summary, "max_abs_err": bf16_err}, "gnn_conv_bwd": gnn_summary,
             "flash_attention_bwd": flash_summary}, rows + gnn_rows + flash_rows)


# (edge set, C): the flagship's width (three Dense, the fused forward's shape) and the production width on the
# three O96 edge sets, and a width the wrapper pads (36 -> 40)
GNN_BWD_CASES = tuple((label, c) for c in (256, 1024) for label in ("processor", "encoder", "decoder")) + \
    (("processor", 36),)


def gnn_bwd_bound(case: dict, c: int, dtype: torch.dtype) -> dict:
    """The least time of one gnn_conv_bwd call: the forward's inputs (x_dst,
    x_src once on a self-graph, e, the MLP), g_msg and the fp32 g_agg read
    once, dx_dst, dx_src, de and every parameter's gradient written once in
    fp32, the CSR and its transpose read once; the operations of
    ``cost.gnn_conv_bwd_flops`` (three times the forward's)."""
    b, nd, ns, e = case.get("batch", 1), case["nd"], case["ns"], case["num_edges"]
    n_dense = (len(case["ops"]) - 2) // 2
    itemsize = torch.finfo(dtype).bits // 8
    rows = nd + (0 if case["self_graph"] else ns)
    params = (n_dense + 2) * c * c + (n_dense + 2) * c
    nbytes = (b * rows * c + 2 * b * e * c + params) * itemsize + b * nd * c * 4 \
        + (b * rows * c + b * e * c + params) * 4 + (nd + ns + 2 + 2 * e) * 4
    return bound(nbytes, cost.gnn_conv_bwd_flops(b, e, nd, ns, c, n_dense),
                 "bf16 tensor" if dtype == torch.bfloat16 else "fp32")


def gnn_backward_cases(graph, dev) -> tuple[dict, list]:
    """gnn_conv_bwd against gnn_conv_bwd_plain (SiLU, cotangents on agg and
    msg) at :data:`GNN_BWD_CASES`, fp32 (not at C = 1024) within 1e-4 and
    bf16 within 2e-2 normwise (both round at the same points from fp32 sums
    taken in another order), two calls bit-identical, each bf16 case timed
    beside its bound and the plain version. The summary is bf16 at C = 256
    on the processor's set."""
    gen = torch.Generator().manual_seed(11)
    rows, summary, bf16_err = [], {}, 0.0
    for label, c in GNN_BWD_CASES:
        case = gnn_case(graph, label, dev, gen, c)
        rp, sr = case["rowptr"], case["src"]
        csr_t = ea.CSRTranspose(*(torch.from_numpy(a).to(dev)
                                  for a in ea.csr_transpose(rp.cpu(), sr.cpu(), case["ns"])))
        g_agg = torch.randn(1, case["nd"], c, generator=gen).to(dev)
        g_msg32 = torch.randn(1, case["num_edges"], c, generator=gen).to(dev)
        shape = f"{label} C={c} E={case['num_edges']} Nd={case['nd']} Ns={case['ns']}"
        for dt in (torch.bfloat16,) if c == 1024 else (torch.float32, torch.bfloat16):
            xd, xs, e = (case[k].to(dt) for k in ("x_dst", "x_src", "e"))
            if case["self_graph"]:
                xs = xd
            args = (xd, xs, e, rp, sr, [t.to(dt) for t in case["ops"]], "SiLU", g_agg, g_msg32.to(dt))
            got, again = gc.gnn_conv_bwd(*args, csr_t), gc.gnn_conv_bwd(*args, csr_t)
            want = gc.gnn_conv_bwd_plain(*args)
            torch.cuda.synchronize()
            what = f"gnn_conv_bwd {shape} {dt}"
            names = ["dx_dst", "dx_src", "de"] + [f"d op {i}" for i in range(len(want[3]))]
            got, again, want = ([*t[:3], *t[3]] for t in (got, again, want))
            for name, g, g2 in zip(names, got, again):
                if not torch.equal(g, g2):
                    raise AssertionError(f"{what} {name}: two calls differ (not run-to-run deterministic)")
            tol = TOL[dt] if dt == torch.bfloat16 else BWD_TOL
            err = max(normwise_err(g, w_, f"{what} {n}", tol) for g, w_, n in zip(got, want, names))
            abs_err = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
            row = {"kernel": "gnn_conv_bwd", "shape": shape, "dtype": str(dt).split(".")[-1], "normwise_err": err,
                   "max_abs_err": abs_err, "bit_identical": True}
            if dt == torch.bfloat16:  # the device kernels of a call, by name: no transposed copy of a chunk
                names = kernels_per_call(lambda: gc.gnn_conv_bwd(*args, csr_t))
                row.update({"route": gc._bwd_route(c, len(case["ops"]) // 2 - 1, dt),
                            "device_kernels": round(sum(names.values()), 2),
                            "transposes": round(sum(k for name, k in names.items() if "transpose" in name), 2)})
                if row["transposes"]:
                    raise AssertionError(f"{what}: a bf16 call transposed a chunk ({names})")
            if dt == torch.bfloat16 and c != 36:
                row.update({"ms": cuda_ms(lambda: gc.gnn_conv_bwd(*args, csr_t), iters=10),
                            "forward_ms": cuda_ms(lambda: gc.gnn_conv(*args[:7]), iters=10),
                            "plain_ms": cuda_ms(lambda: gc.gnn_conv_bwd_plain(*args), iters=2, warmup=1),
                            **gnn_bwd_bound(case, c, dt), "library_ms": None,
                            "host_us": host_us(lambda: gc.gnn_conv_bwd(*args, csr_t), iters=10)})
                bf16_err = max(bf16_err, abs_err)
                if label == "processor" and c == 256:
                    summary = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us",
                                                   "device_kernels")}
            rows.append(row)
            del got, again, want
    return {**summary, "max_abs_err": bf16_err}, rows


def flash_backward_cases(dev, n0: int = 10242, w0: int = 512) -> tuple[dict, list]:
    """flash_attention_bwd against flash_attention_bwd_plain at the O96
    processor's shape (B = 1, H = 4, N = 10,242, D = 64, q, k and v strided
    views of one fused projection): w = 512, causal w = 512, dropout 0.1
    and rank 1's rows of a two-rank split against its halo-extended keys,
    fp32 within 1e-4 and bf16 within 2e-2 normwise, two calls bit-identical,
    both from the forward kernel's row log-sum-exp (held to the plain
    version's within 1e-4, the same rows infinite), whose output is bit for
    bit the call's without it; timed beside the bound, the plain version
    and (without dropout: SDPA draws its own mask) the backward of SDPA
    with the same boolean mask. The summary is bf16 at w = 512."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(13)
    h, d, half = 4, 64, n0 - n0 // 2
    qkv32 = torch.randn(1, n0, 3, h, d, generator=gen)
    g32 = torch.randn(1, h, n0, d, generator=gen)
    key = fa.fold_key(19, 2, 1)
    cases = (  # label, query rows, key rows, window, causal, dropout
        ("w=512", (0, n0), (0, n0), w0, False, 0.0),
        ("causal w=512", (0, n0), (0, n0), w0, True, 0.0),
        ("w=512 dropout 0.1", (0, n0), (0, n0), w0, False, 0.1),
        ("halo rank 1 w=512", (half, n0), (half - w0, n0), w0, False, 0.0),
    )
    rows, summary, bf16_err = [], {}, 0.0
    for label, (q0, q1), (k0, k1), window, causal, rate in cases:
        for dt in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dev, dt)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            q, k, v = q[:, :, q0:q1], k[:, :, k0:k1], v[:, :, k0:k1]
            g = g32[:, :, q0:q1].to(dev, dt)
            kw = dict(window_size=window, is_causal=causal, dropout_rate=rate, dropout_key=key if rate else None,
                      q_offset=q0, k_offset=k0, n_valid=n0)
            shape = f"{label}: {q1 - q0} query rows at {q0}, {k1 - k0} keys at {k0}, B*H={h} D={d}"
            what = f"flash_attention_bwd {shape} {dt}"
            out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
            if not torch.equal(out, fa.flash_attention(q, k, v, **kw)):
                raise AssertionError(f"{what}: the row statistics changed the forward's bits")
            lse_want = fa.blockwise_attention(q, k, v, **kw, return_lse=True)[1]
            finite = torch.isfinite(lse_want)
            if not torch.equal(torch.isfinite(lse), finite):
                raise AssertionError(f"{what}: the rows that see no key differ")
            lse_err = max_err(lse[finite], lse_want[finite], BWD_TOL, f"{what} lse")
            got, again = fa.flash_attention_bwd(q, k, v, out, g, lse, **kw), fa.flash_attention_bwd(q, k, v, out, g,
                                                                                                     lse, **kw)
            want = fa.flash_attention_bwd_plain(q, k, v, out, g, lse, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv"), got, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"{what} {name}: two calls differ (not run-to-run deterministic)")
            tol = TOL[dt] if dt == torch.bfloat16 else BWD_TOL
            err = max(normwise_err(a, b, f"{what} {n}", tol) for a, b, n in zip(got, want, ("dq", "dk", "dv")))
            abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
            pairs = fa.live_pairs(q1 - q0, window, causal, k1 - k0, q0, k0, n0)
            nbytes = (3 * (q1 - q0) + 2 * (k1 - k0)) * h * d * qkv.element_size() + (q1 - q0) * h * 4 \
                + ((q1 - q0) + 2 * (k1 - k0)) * h * d * 4
            row = {"kernel": "flash_attention_bwd", "shape": shape, "dtype": str(dt).split(".")[-1],
                   "normwise_err": err, "max_abs_err": abs_err, "lse_err": lse_err, "bit_identical": True,
                   "forward_bits_with_lse": True,
                   "ms": cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, g, lse, **kw), iters=10),
                   "forward_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, **kw, return_lse=True), iters=10),
                   "plain_ms": cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, g, lse, **kw), iters=2,
                                       warmup=1),
                   **bound(nbytes, cost.flash_bwd_flops(h, pairs, d), "bf16 tensor" if dt == torch.bfloat16 else "fp32"),
                   "library_ms": None}
            if not rate:
                qpos = torch.arange(q0, q1, device=dev)[:, None]
                kpos = torch.arange(k0, k1, device=dev)[None, :]
                mask = (qpos - kpos).abs() <= window
                if causal:
                    mask &= qpos >= kpos
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
                row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(sdpa, leaves, g, retain_graph=True), iters=5,
                                            warmup=1)
                del sdpa, leaves, mask
            if dt == torch.bfloat16:
                bf16_err = max(bf16_err, abs_err)
                if label == "w=512":
                    row["host_us"] = host_us(lambda: fa.flash_attention_bwd(q, k, v, out, g, lse, **kw), iters=10)
                    summary = {k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us")}
            rows.append(row)
    return {**summary, "max_abs_err": bf16_err}, rows


def gnn_case(graph, label: str, dev, gen, c: int = 256, keep=None, extra: int = 0, batch: int = 1) -> dict:
    """One real edge set with seeded GNN conv inputs on the card (fp32) for
    ``batch`` samples, the edge MLP with ``extra`` hidden Dense layers more
    than three; the processor's is a self-graph (x_src is x_dst)."""
    s_name, d_name = {"processor": ("hidden", "hidden"), "encoder": ("data", "hidden"),
                      "decoder": ("hidden", "data")}[label]
    ei = graph[(s_name, "to", d_name)].edge_index
    ei = ei if keep is None else ei[:, keep]
    ns, nd = graph[s_name].num_nodes, graph[d_name].num_nodes
    rowptr, src = (torch.from_numpy(t).to(dev) for t in ea.csr_from_edge_index(ei, ns, nd))
    x_dst = torch.randn(batch, nd, c, generator=gen)
    x_src = x_dst if label == "processor" else torch.randn(batch, ns, c, generator=gen)
    dense = [(torch.randn(c, k, generator=gen) * k ** -0.5, torch.randn(c, generator=gen) * 0.1)
             for k in (3 * c,) + (c,) * (2 + extra)]
    norm = (1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
    return {"ns": ns, "nd": nd, "num_edges": ei.shape[1], "self_graph": label == "processor", "batch": batch,
            "rowptr": rowptr, "src": src, "x_dst": x_dst.to(dev), "x_src": x_src.to(dev),
            "e": torch.randn(batch, ei.shape[1], c, generator=gen).to(dev),
            "ops": gc.mlp_operands([(w.to(dev), b.to(dev)) for w, b in dense], tuple(t.to(dev) for t in norm),
                                   torch.float32)}


def gnn_bound(case: dict, c: int, dtype: torch.dtype) -> dict:
    """The least time of one GNN conv call: x_dst, x_src (once on a
    self-graph), e and the MLP read once, msg and the fp32 agg written once;
    the fewest operations factor x_i . W0[0:C] and x_j . W0[C:2C] once per
    node (2 C^2 each) and leave 2 C^2 per edge for each Dense (e . W0[2C:3C],
    then each C x C layer); nodes and edges of every sample of the batch."""
    b = case.get("batch", 1)
    nd, ns, e = case["nd"], case["ns"], case["num_edges"]
    n_dense = (len(case["ops"]) - 2) // 2
    itemsize = torch.finfo(dtype).bits // 8
    rows = nd + (0 if case["self_graph"] else ns)
    nbytes = (b * rows * c + 2 * b * e * c + (n_dense + 2) * c * c + (n_dense + 2) * c) * itemsize \
        + b * nd * c * 4 + (nd + 1 + e) * 4
    return bound(nbytes, cost.gnn_conv_flops(b, e, nd, ns, c, n_dense), "bf16 tensor" if dtype == torch.bfloat16 else "fp32")


def gnn_check(case: dict, dt: torch.dtype, what: str) -> tuple[tuple, tuple, dict]:
    """gnn_conv on one case against plain: two calls bit-identical, agg the
    fp32 sum of the kernel's own msg (1e-5), msg and agg against plain within
    fp32 1e-5 elementwise or bf16 2e-2 normwise (both sides round at the same
    points from fp32 sums taken in another order, so a value can land one
    bf16 step apart, and a step taken before "+ beta" or "+ e" stays as an
    absolute error where that sum cancels). Returns (args, outputs, row)."""
    xd, xs, e = (case[k].to(dt) for k in ("x_dst", "x_src", "e"))
    if case["self_graph"]:
        xs = xd
    ops = [t.to(dt) for t in case["ops"]]
    args = (xd, xs, e, case["rowptr"], case["src"], ops, "SiLU")
    got, again = gc.gnn_conv(*args), gc.gnn_conv(*args)
    want = gc.gnn_conv_plain(*args)
    torch.cuda.synchronize()
    for name, g, g2 in zip(("agg", "msg"), got, again):
        if not torch.equal(g, g2):
            raise AssertionError(f"{what} {name}: two calls differ (not run-to-run deterministic)")
    max_err(got[0], gc.aggregate(got[1], case["rowptr"]), TOL[torch.float32], f"{what} agg of msg")
    for g, w_, n in zip(got, want, ("agg", "msg")):
        if dt == torch.float32:
            max_err(g, w_, TOL[dt], f"{what} {n}")
        else:
            normwise_err(g, w_, f"{what} {n}", TOL[dt])
    row = {"dtype": str(dt).split(".")[-1],
           "max_abs_err": max((g.float() - w_.float()).abs().max().item() for g, w_ in zip(got, want)),
           "normwise_err": max(normwise_err(g, w_, what, 1.0) for g, w_ in zip(got, want)), "bit_identical": True}
    return args, got, row


def phase_gnn_kernels(graph, dev) -> tuple[dict, list]:
    """gnn_conv against plain at the three O96 edge sets and with dead
    destinations, fp32 and bf16, two calls bit-identical; the summary is
    bf16 on the processor's edges."""
    gen = torch.Generator().manual_seed(2)
    c = 256
    rows, summary, bf16_err = [], {}, 0.0
    cases = [(label, None) for label in ("processor", "encoder", "decoder")]
    cases.append(("processor", graph[("hidden", "to", "hidden")].edge_index[1] % 7 != 3))
    for label, keep in cases:
        case = gnn_case(graph, label, dev, gen, c, keep)
        shape = f"{label}{' dead' if keep is not None else ''} E={case['num_edges']} Nd={case['nd']} Ns={case['ns']}"
        for dt in (torch.float32, torch.bfloat16):
            what = f"gnn_conv {shape} {dt}"
            args, got, check = gnn_check(case, dt, what)
            xd, xs, ops = args[0], args[1], args[5]
            err = check["max_abs_err"]
            row = {"kernel": "gnn_conv", "shape": shape, **check}
            if keep is not None:
                dead = torch.from_numpy(np.arange(case["nd"]) % 7 == 3).to(dev)
                if not bool((got[0][0, dead] == 0).all()):
                    raise AssertionError(f"{what}: dead destinations aggregate non-zero")
                row["dead_destinations"] = int(dead.sum())
            else:
                # the per-node pre-pass alone (gnn_conv launches it first), against its plain version
                pre = gc.gnn_prepass(xd, xs, ops[0], ops[1])
                pre_want = gc.node_products(xd, xs, ops[0], ops[1])
                torch.cuda.synchronize()
                for g, w_, n in zip(pre, pre_want, ("P_dst", "P_src")):
                    max_err(g, w_, TOL[torch.float32], f"{what} pre-pass {n}")
                row.update({"ms": cuda_ms(lambda: gc.gnn_conv(*args)),
                            "plain_ms": cuda_ms(lambda: gc.gnn_conv_plain(*args), iters=3, warmup=1),
                            **gnn_bound(case, c, dt), "library_ms": None,
                            "host_us": host_us(lambda: gc.gnn_conv(*args), iters=20),
                            "prepass_ms": cuda_ms(lambda: gc.gnn_prepass(xd, xs, ops[0], ops[1])),
                            "prepass_plain_ms": cuda_ms(lambda: gc.node_products(xd, xs, ops[0], ops[1]))})
            if dt == torch.bfloat16:
                bf16_err = max(bf16_err, err)
                if label == "processor" and keep is None:
                    summary = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us",
                                                  "prepass_ms")}
            rows.append(row)
    return {**summary, "max_abs_err": bf16_err}, rows


# (C, mlp_extra_layers): the layered route; C = 36, 100 and 260 padded to a multiple of 8
GNN_WIDTHS = ((384, 0), (512, 0), (1024, 0), (256, 1), (256, 2), (36, 0), (100, 0), (260, 0))
# the layered route's edge cases at the production width (C = 1024, three Dense): (name, edge set, batch,
# kept edges): two samples (a chunk crosses the batch boundary), the processor's set cut by the chunk
# inside a destination's row, and destinations left with no edge
GNN_LAYERED_CASES = (("batch 2", "processor", 2, None), ("chunk mid-destination", "processor", 1, None),
                     ("dead destinations", "processor", 1, "dead"))


def layered_check(case: dict, c: int, extra: int, dt: torch.dtype, shape: str) -> tuple[tuple, dict]:
    """gnn_check on the layered route, with its launches counted and its
    peak device memory over the inputs."""
    if gc._gnn_route(c, 3 + extra) != "layered":
        raise AssertionError(f"gnn_conv {shape}: not on the layered route")
    before = gc.LAUNCHES["gnn_conv_layered"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    args, got, check = gnn_check(case, dt, f"gnn_conv {shape} {dt}")
    if gc.LAUNCHES["gnn_conv_layered"] != before + 2:
        raise AssertionError(f"gnn_conv {shape}: the layered kernels were not launched")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return args, got, {"kernel": "gnn_conv_layered", "shape": shape, **check, "peak_gib_over_inputs": peak,
                       "ms": cuda_ms(lambda: gc.gnn_conv(*args), iters=10),
                       "plain_ms": cuda_ms(lambda: gc.gnn_conv_plain(*args), iters=3, warmup=1),
                       **gnn_bound(case, c, dt), "library_ms": None,
                       "host_us": host_us(lambda: gc.gnn_conv(*args), iters=10)}


def phase_gnn_widths(graph, dev) -> tuple[dict, list]:
    """gnn_conv's layered route against plain at the three O96 edge sets for
    every (C, mlp_extra_layers) of GNN_WIDTHS, fp32 and bf16, at the bounds
    of the fused route, two calls bit-identical; each case timed with its
    bound and its peak device memory, and at C = 1024 in bf16 its device ms
    split by launch (kernel_turns.layered_split). Then GNN_LAYERED_CASES at
    C = 1024, both dtypes, at the same bounds. The summary is bf16 at C =
    1024 on the processor's edges (the production width's)."""
    gen = torch.Generator().manual_seed(6)
    rows, summary, bf16_err = [], {}, 0.0
    for c, extra in GNN_WIDTHS:
        for label in ("processor", "encoder", "decoder"):
            case = gnn_case(graph, label, dev, gen, c, extra=extra)
            shape = f"C={c} extra={extra} {label} E={case['num_edges']} Nd={case['nd']} Ns={case['ns']}"
            for dt in (torch.float32, torch.bfloat16):
                args, _, row = layered_check(case, c, extra, dt, shape)
                if dt == torch.bfloat16:
                    bf16_err = max(bf16_err, row["max_abs_err"])
                    if (c, extra) == (1024, 0):
                        row["split"] = layered_split(lambda: gc.gnn_conv(*args))
                    if (c, extra, label) == (1024, 0, "processor"):
                        summary = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                      "host_us", "split")}
                rows.append(row)
            del case, args
    c = 1024
    for name, label, batch, keep in GNN_LAYERED_CASES:
        ei = graph[("hidden", "to", "hidden")].edge_index
        kept = ei[1] % 7 != 3 if keep == "dead" else None
        case = gnn_case(graph, label, dev, gen, c, keep=kept, batch=batch)
        rowptr = case["rowptr"].cpu()
        if name == "chunk mid-destination":
            cut = gc.LAYERED_CHUNK
            inside = bool(((rowptr[:-1] < cut) & (rowptr[1:] > cut)).any())
            if not (case["num_edges"] > cut and inside):
                raise AssertionError(f"gnn_conv {name}: the chunk boundary at row {cut} is not inside a destination")
        shape = f"C={c} {name} {label} B={batch} E={case['num_edges']} Nd={case['nd']}"
        for dt in (torch.float32, torch.bfloat16):
            args, got, row = layered_check(case, c, 0, dt, shape)
            if keep == "dead":
                dead = torch.from_numpy(np.arange(case["nd"]) % 7 == 3).to(dev)
                if not bool((got[0][:, dead] == 0).all()):
                    raise AssertionError(f"gnn_conv {shape} {dt}: dead destinations aggregate non-zero")
                row["dead_destinations"] = int(dead.sum())
            if dt == torch.bfloat16:
                bf16_err = max(bf16_err, row["max_abs_err"])
            rows.append(row)
        del case, args, got
    return {**summary, "max_abs_err": bf16_err}, rows


def phase_flash_kernels(dev, n0: int = 10242, w0: int = 512) -> tuple[dict, list]:
    """flash_attention against plain at the O96 processor's shape (B = 1,
    H = 4, N = 10,242, D = 64): w = 512, no window, a ragged N (4,098) and a
    causal window, fp32 and bf16, with q, k, v strided views of one fused
    projection; library_ms is SDPA with the same boolean mask. The summary
    is bf16 with w = 512."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(3)
    h, d = 4, 64
    rows, summary, bf16_err = [], {}, 0.0
    for n, window, causal in ((n0, w0, False), (n0, None, False), (2 * n0 // 5 + 2, w0, False), (n0, w0, True)):
        qkv32 = torch.randn(1, n, 3, h, d, generator=gen)
        pos = torch.arange(n, device=dev)
        mask = torch.ones(n, n, dtype=torch.bool, device=dev)
        if window is not None:
            mask &= (pos[:, None] - pos[None, :]).abs() <= window
        if causal:
            mask &= pos[:, None] >= pos[None, :]
        shape = f"B*H={h} N={n} D={d} w={window}{' causal' if causal else ''}"
        for dt in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dev, dt)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            got, again = fa.flash_attention(q, k, v, window, causal), fa.flash_attention(q, k, v, window, causal)
            want = fa.blockwise_attention(q, k, v, window_size=window, is_causal=causal)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash_attention {shape} {dt}: two calls differ (not run-to-run deterministic)")
            err = max_err(got, want, TOL[dt], f"flash_attention {shape} {dt}")
            flops = cost.flash_flops(h, fa.live_pairs(n, window, causal), d)
            nbytes = 4 * h * n * d * qkv.element_size()
            row = {"kernel": "flash_attention", "shape": shape, "dtype": str(dt).split(".")[-1], "max_abs_err": err,
                   "bit_identical": True,
                   "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, window, causal)),
                   "plain_ms": cuda_ms(lambda: fa.blockwise_attention(q, k, v, window_size=window,
                                                                      is_causal=causal), iters=3, warmup=1),
                   **bound(nbytes, flops, "bf16 tensor" if dt == torch.bfloat16 else "fp32"),
                   "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                                         iters=5, warmup=1)}
            if dt == torch.bfloat16:
                bf16_err = max(bf16_err, err)
                if n == n0 and window == w0 and not causal:
                    row["host_us"] = host_us(lambda: fa.flash_attention(q, k, v, window, causal))
                    summary = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us")}
            rows.append(row)
    offset_rows = flash_offset_cases(dev, n0, w0)
    bf16_err = max([bf16_err] + [r["max_abs_err"] for r in offset_rows if r["dtype"] == "bfloat16"])
    return {**summary, "max_abs_err": bf16_err}, rows + offset_rows


def flash_offset_cases(dev, n0: int = 10242, w0: int = 512) -> list:
    """flash_attention on a rank's rows of the O96 processor's sequence split
    over two ranks (phase_parallel's shapes; B = 1, H = 4, D = 64), against
    blockwise_attention with the same offsets, fp32 and bf16, two calls
    bit-identical: the halo window path (each rank's 5,121 query rows against
    [left | own | right] keys with w = 512 halos: rank 0's left halo and
    rank 1's right halo lie outside [0, N) and are masked), the gathered
    keys' path (rank 1's rows against every key, causal and with no window),
    and rank 1's halo rows with dropout 0.1, whose output is also held to the
    unsharded call's rows (the pairs are drawn at global positions).
    library_ms is SDPA with the same boolean mask."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(5)
    h, d, half = 4, 64, n0 - n0 // 2  # rank 0 holds [0, half), rank 1 [half, n0)
    qkv32 = torch.randn(1, n0, 3, h, d, generator=gen)
    cases = (  # label, query rows, key rows (None: zero rows), q_offset, k_offset, window, causal, dropout
        ("halo rank 0", (0, half), [(n0 - w0, n0), (0, half + w0)], 0, -w0, w0, False, 0.0),
        ("halo rank 1", (half, n0), [(half - w0, n0), None], half, half - w0, w0, False, 0.0),
        ("gathered causal rank 1", (half, n0), [(0, n0)], half, 0, None, True, 0.0),
        ("gathered no window rank 1", (half, n0), [(0, n0)], half, 0, None, False, 0.0),
        ("halo rank 1 dropout 0.1", (half, n0), [(half - w0, n0), None], half, half - w0, w0, False, 0.1),
    )
    key = fa.fold_key(77, 1)
    rows = []
    for label, (q0, q1), parts, q_off, k_off, window, causal, rate in cases:
        for dt in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dev, dt)
            q, k_all, v_all = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            q = q[:, :, q0:q1]  # a strided view of the fused projection, as the layer passes it
            # k and v in one buffer, as the halo and gathered paths build them
            k, v = torch.stack([torch.cat([t[:, :, p[0]:p[1]] if p else t.new_zeros(1, h, w0, d) for p in parts],
                                          dim=2) for t in (k_all, v_all)])
            kw = dict(window_size=window, is_causal=causal, dropout_rate=rate, dropout_key=key if rate else None,
                      q_offset=q_off, k_offset=k_off, n_valid=n0)
            args = (window, causal, rate, key if rate else None, q_off, k_off, n0)
            got, again = fa.flash_attention(q, k, v, *args), fa.flash_attention(q, k, v, *args)
            want = fa.blockwise_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            shape = f"{label}: {q1 - q0} query rows at {q_off}, {k.shape[2]} keys at {k_off}, N={n0} w={window}"
            if not torch.equal(got, again):
                raise AssertionError(f"flash_attention {shape} {dt}: two calls differ")
            err = max_err(got, want, TOL[dt], f"flash_attention {shape} {dt}")
            row = {"kernel": "flash_attention", "shape": shape, "dtype": str(dt).split(".")[-1], "max_abs_err": err,
                   "bit_identical": True}
            if rate:  # the sharded rows against the unsharded call's, both on the kernel
                whole = fa.flash_attention(qkv[:, :, 0].transpose(1, 2), k_all, v_all, window, causal, rate, key)
                row["vs_unsharded_err"] = max_err(got, whole[:, :, q0:q1], TOL[dt],
                                                  f"flash_attention {shape} {dt} against the unsharded rows")
            qpos = torch.arange(q_off, q_off + q1 - q0, device=dev)[:, None]
            kpos = torch.arange(k_off, k_off + k.shape[2], device=dev)[None, :]
            mask = (kpos >= 0) & (kpos < n0) & (qpos >= 0)  # (rows, keys)
            if window is not None:
                mask &= (qpos - kpos).abs() <= window
            if causal:
                mask &= qpos >= kpos
            pairs = fa.live_pairs(q1 - q0, window, causal, k.shape[2], q_off, k_off, n0)
            nbytes = (2 * (q1 - q0) + 2 * k.shape[2]) * h * d * qkv.element_size()
            row.update(ms=cuda_ms(lambda: fa.flash_attention(q, k, v, *args)),
                       plain_ms=cuda_ms(lambda: fa.blockwise_attention(q, k, v, **kw), iters=3, warmup=1),
                       **bound(nbytes, cost.flash_flops(h, pairs, d), "bf16 tensor" if dt == torch.bfloat16 else "fp32"),
                       library_ms=None if rate else cuda_ms(lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask), iters=5, warmup=1))
            rows.append(row)
    return rows


def phase_reduced_model(graph, dev, flavor: str = "graphtransformer", channels: int = 64, heads: int = 4,
                        kernel: str | None = None, mlp_extra_layers: int = 0, cfg: DotDict | None = None,
                        name_to_index: dict | None = None, stats: dict | None = None,
                        pipeline_batch: torch.Tensor | None = None) -> dict:
    """Reduced fp32 model: kernels on the card against plain on the CPU, in
    the forward, the gradients and a 3-step train trace; ``kernel`` must
    launch (the flavor's own by default). ``cfg`` (fp32) replaces the
    flavor's config, with its variables and statistics; with
    ``pipeline_batch`` the processors are fitted on it on both devices and
    ``predict_step`` through the whole pipeline is compared too (the same
    NaN positions, the values at the forward's bound)."""
    cfg = cfg or configs.flagship(num_channels=channels, num_layers=2, num_chunks=1, dtype="float32", flavor=flavor,
                              num_heads=heads, mlp_extra_layers=mlp_extra_layers)
    kernel = kernel or FLAVOR_KERNEL[flavor]
    cpu = interface(graph, cfg, "cpu", seed=1, name_to_index=name_to_index, stats=stats)
    gpu = interface(graph, cfg, "cpu", seed=1, name_to_index=name_to_index, stats=stats).to(dev)
    n_grid = graph["data"].num_nodes
    x, y = train_batch(cpu, n_grid, seed=2)
    t0 = time.perf_counter()
    ref = cpu.forward(x)
    cpu_s = time.perf_counter() - t0
    reset_launches()
    out = gpu.forward(x.to(dev)).cpu()
    if launches()[kernel] == 0:
        raise AssertionError(f"reduced {flavor} model: {kernel} was not launched")
    scale = max(1.0, ref.abs().mean().item())
    err = (out - ref).abs().max().item()
    if not torch.isfinite(out).all() or err > 1e-4 * scale:
        raise AssertionError(f"reduced model: GPU kernels vs CPU plain max err {err:.3e} > {1e-4 * scale:.3e}")

    weighted_mse(cpu.model(x), y).backward()
    weighted_mse(gpu.model(x.to(dev)), y.to(dev)).backward()
    gpu_params = dict(gpu.model.named_parameters())
    grad_err = max(normwise_err(gpu_params[n].grad.cpu(), p.grad, f"reduced model gradient {n}")
                   for n, p in cpu.model.named_parameters())

    traces = []
    for iface, xx, yy in ((cpu, x, y), (gpu, x.to(dev), y.to(dev))):
        step = make_train_step(iface.model, make_optimizer(iface.model.parameters(), 1e-3, warmup_steps=1,
                                                           total_steps=10))
        traces.append([step(xx, yy).item() for _ in range(3)])
    trace_err = float(np.max(np.abs(np.subtract(traces[1], traces[0])) / np.abs(traces[0])))
    if not np.all(np.isfinite(traces[1])) or trace_err > 6e-4:
        raise AssertionError(f"reduced train trace: GPU {traces[1]} vs CPU {traces[0]} (rel err {trace_err:.3e})")
    hidden = {name: ns.num_nodes for name, ns in graph.node_items() if name != "data"}
    out = {"grid": n_grid, "hidden": hidden, "max_abs_err": err, "bound": 1e-4 * scale,
           "cpu_forward_s": cpu_s, "grad_normwise_err": grad_err, "loss_trace_cpu": traces[0],
           "loss_trace_gpu": traces[1], "loss_trace_rel_err": trace_err}
    if pipeline_batch is not None:
        cpu.fit_processors(pipeline_batch)
        gpu.fit_processors(pipeline_batch.to(dev))
        want, got = cpu.predict_step(pipeline_batch), gpu.predict_step(pipeline_batch.to(dev)).cpu()
        finite = ~torch.isnan(want)
        scale = max(1.0, want[finite].abs().mean().item())
        pred_err = (got[finite] - want[finite]).abs().max().item()
        if not torch.equal(torch.isnan(got), torch.isnan(want)) or pred_err > 1e-4 * scale:
            raise AssertionError(f"reduced pipeline: predict_step GPU vs CPU max err {pred_err:.3e} "
                                 f"(bound {1e-4 * scale:.3e}) or NaN positions differ")
        out.update({"predict_step_max_abs_err": pred_err, "predict_step_nan": int((~finite).sum())})
    return out


def phase_serving(graph, dev, flavor: str = "graphtransformer", profile_dir: str | None = None,
                  channels: int = 256, heads: int = 4, expected: dict | None = None,
                  cfg: DotDict | None = None) -> dict:
    """Flagship bf16 serving through predict_step (or the same model at
    another width, or ``cfg``'s model: ``flavor`` then labels it); per-request
    launch counts (``expected``: the flavor's EXPECTED by default)."""
    cfg = cfg or configs.flagship(num_channels=channels, num_layers=8, num_chunks=2, dtype="bfloat16", flavor=flavor,
                              num_heads=heads)
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
    reset_launches()
    ms, per_request = [], []
    for batch in requests[1:]:
        before = launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = iface.predict_step(batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        per_request.append({k: v - before[k] for k, v in launches().items()})
        if tuple(y.shape) != (1, 1, n_grid, n_out) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"serving {flavor}: bad output shape {tuple(y.shape)} or non-finite values")
    counts = launches()
    expected = expect(counts, expected or EXPECTED[flavor][0])
    if any(c != expected for c in per_request):
        raise AssertionError(f"serving {flavor}: expected {expected} launches per request, got {per_request}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = (phase_profile(lambda: iface.predict_step(requests[1]), profile_dir, f"request_{flavor}_C{channels}")
               if profile_dir else None)
    return {"request_ms": ms, "peak_mem_gib": peak, "launches": counts, "per_request": per_request,
            "profile": profile}


def timed_steps(step, x, y, n: int) -> tuple[list, list, list]:
    """Losses, CUDA-event ms and kernel launches of ``n`` train steps."""
    losses, ms, per_step = [], [], []
    for _ in range(n):
        before = launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with no_plain():
            loss = step(x, y)
        end.record()
        torch.cuda.synchronize()
        losses.append(loss.item())
        ms.append(start.elapsed_time(end))
        per_step.append({k: v - before[k] for k, v in launches().items()})
    return losses, ms, per_step


def phase_train(graph, dev, profile_dir: str | None, flavor: str = "graphtransformer",
                remat_none: bool = True, channels: int = 256, heads: int = 4, lr: float = 1e-3,
                expected: dict | None = None, steps: int = 4,
                must_fall: bool = True, cfg: DotDict | None = None) -> tuple[dict, AnemoiModelInterface]:
    """Flagship bf16 train steps at full width (remat "full", then, with
    ``remat_none``, "none"), or the same model at another width (or
    ``cfg``'s model, ``flavor`` then labelling it), at peak learning rate
    ``lr``. Losses must be finite and the last below the first (with
    ``must_fall``); ``steps`` includes the warm-up; launches per step as
    ``expected`` (the flavor's EXPECTED by default). Returns the numbers and
    the trained interface."""
    cfg = cfg or configs.flagship(num_channels=channels, num_layers=8, num_chunks=2, dtype="bfloat16",
                              remat_policy="full", flavor=flavor, num_heads=heads)
    iface = interface(graph, cfg, dev, seed=4)
    model = iface.model
    x, y = (t.to(dev) for t in train_batch(iface, graph["data"].num_nodes, seed=20))
    step = make_train_step(model, make_optimizer(model.parameters(), lr, warmup_steps=1, total_steps=100))

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, per_step = timed_steps(step, x, y, steps)  # the first is the warm-up, at lr 0
    counts = launches()
    peak_full = torch.cuda.max_memory_allocated() / 2**30
    if not np.all(np.isfinite(losses)) or (must_fall and not losses[-1] < losses[0]):
        raise AssertionError(f"train {flavor} C={channels}: losses {losses} are not finite or do not fall")
    expected = expect(counts, expected or EXPECTED[flavor][1])
    if any(c != expected for c in per_step):
        raise AssertionError(f"train {flavor} (remat full): expected {expected} launches per step, got {per_step}")
    out = {"losses": losses, "step_ms": ms[1:], "warmup_step_ms": ms[0], "peak_mem_gib": peak_full,
           "launches": counts, "per_step": per_step[1]}
    out["profile"] = (phase_profile(lambda: step(x, y), profile_dir, f"train_step_{flavor}_C{channels}")
                      if profile_dir else None)
    if not remat_none:
        return out, iface

    for chunk in model.processor.proc:
        chunk.remat_policy = "none"
    torch.cuda.reset_peak_memory_stats()
    losses_none, ms_none, per_step_none = timed_steps(step, x, y, 2)
    peak_none = torch.cuda.max_memory_allocated() / 2**30
    expected = expect(counts, {"kv_proj": 12, "edge_attn_csr": 12, "edge_attn_csr_bwd": 10})
    if any(c != expected for c in per_step_none) or not np.all(np.isfinite(losses_none)):
        raise AssertionError(f"train (remat none): expected {expected} launches per step, got {per_step_none}")
    out["remat_none"] = {"losses": losses_none, "step_ms": ms_none[1:], "peak_mem_gib": peak_none,
                         "per_step": per_step_none[1]}
    for chunk in model.processor.proc:
        chunk.remat_policy = "full"
    return out, iface


def phase_rollout(graph, dev, profile_dir: str | None = None) -> dict:
    """The flagship GraphTransformer's multi-step forecast through
    ``predict_rollout``: ROLLOUT_STEPS lead times with seeded pre-processed
    forcings, one warm-up and three timed calls; ROLLOUT_STEPS times the
    request's launches per call, finite outputs, and the first lead time
    equal to ``predict_step`` on the same batch bit for bit."""
    cfg = configs.flagship(num_channels=256, num_layers=8, num_chunks=2, dtype="bfloat16")
    iface = interface(graph, cfg, dev, seed=3)
    di, stats = iface.data_indices, iface.statistics
    n_grid, n_out = graph["data"].num_nodes, len(di.data.output.full)
    in_idx = np.asarray(di.data.input.full)
    rng = np.random.RandomState(30)
    raw = stats["mean"][in_idx] + stats["stdev"][in_idx] * rng.randn(1, 2, n_grid, len(in_idx))
    batch = torch.from_numpy(raw.astype(np.float32)).to(dev)
    n_forcing = len(di.internal_model.input.forcing)
    forcings = torch.from_numpy(rng.randn(ROLLOUT_STEPS, 1, 1, n_grid, n_forcing).astype(np.float32)).to(dev)
    iface.predict_rollout(batch, ROLLOUT_STEPS, forcings)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms, per_call = [], []
    for _ in range(3):
        before = launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = iface.predict_rollout(batch, ROLLOUT_STEPS, forcings)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        per_call.append({k: v - before[k] for k, v in launches().items()})
        if tuple(y.shape) != (ROLLOUT_STEPS, 1, 1, n_grid, n_out) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"rollout: bad output shape {tuple(y.shape)} or non-finite values")
    counts = launches()
    expected = expect(counts, {k: ROLLOUT_STEPS * v for k, v in EXPECTED["graphtransformer"][0].items()})
    if any(c != expected for c in per_call):
        raise AssertionError(f"rollout: expected {expected} launches per call, got {per_call}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    first = iface.predict_step(batch)
    if not torch.equal(y[0], first):
        raise AssertionError(f"rollout: the first lead time differs from predict_step "
                             f"(max {(y[0].float() - first.float()).abs().max().item():.3e})")
    profile = (phase_profile(lambda: iface.predict_rollout(batch, ROLLOUT_STEPS, forcings), profile_dir, "rollout")
               if profile_dir else None)
    return {"lead_times": ROLLOUT_STEPS, "call_ms": ms, "ms_per_lead_time": [m / ROLLOUT_STEPS for m in ms],
            "peak_mem_gib": peak, "launches": counts, "per_call": per_call[-1], "first_equals_predict_step": True,
            "profile": profile}


def phase_rollout_train(graph, dev, profile_dir: str | None = None, n_steps: int = 2) -> dict:
    """The flagship GraphTransformer's rollout fine-tuning step
    (``make_rollout_train_step``, ``n_steps`` lead times, remat "full"): one
    warm-up and three steps on one seeded batch; finite losses, the last
    below the first, ``n_steps`` times a train step's launches per step."""
    cfg = configs.flagship(num_channels=256, num_layers=8, num_chunks=2, dtype="bfloat16", remat_policy="full")
    iface = interface(graph, cfg, dev, seed=4)
    di, model = iface.data_indices, iface.model
    n_grid = graph["data"].num_nodes
    n_in, n_out = len(di.internal_model.input), len(di.internal_model.output)
    rng = np.random.RandomState(31)
    x0, truth, targets = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev) for shape in (
        (1, 2, 1, n_grid, n_in), (n_steps, 1, 1, n_grid, n_in), (n_steps, 1, 1, n_grid, n_out)))
    step = make_rollout_train_step(model, di, make_optimizer(model.parameters(), 1e-3, warmup_steps=1,
                                                             total_steps=100), n_steps)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, per_step = timed_steps(lambda _x, _y: step(x0, truth, targets), None, None, 4)
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"rollout train: losses {losses} are not finite or do not fall")
    expected = expect(counts, {k: n_steps * v for k, v in EXPECTED["graphtransformer"][1].items()})
    if any(c != expected for c in per_step):
        raise AssertionError(f"rollout train: expected {expected} launches per step, got {per_step}")
    profile = (phase_profile(lambda: step(x0, truth, targets), profile_dir, "rollout_train_step")
               if profile_dir else None)
    return {"lead_times": n_steps, "losses": losses, "step_ms": ms[1:], "warmup_step_ms": ms[0],
            "peak_mem_gib": peak, "launches": counts, "per_step": per_step[1], "profile": profile}


def phase_checkpoint(iface: AnemoiModelInterface, graph, dev) -> dict:
    """The trained flagship saved (graph included) and served again through
    ``from_checkpoint(device="cuda")``: predict_step bit-identical to the
    source interface's; bytes on disk, save and load seconds. The directory
    lives under the checkout's build/ and is removed after."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    iface.model.eval()
    di, stats = iface.data_indices, iface.statistics
    in_idx = np.asarray(di.data.input.full)
    raw = stats["mean"][in_idx] + stats["stdev"][in_idx] * np.random.RandomState(32).randn(
        1, 2, graph["data"].num_nodes, len(in_idx))
    batch = torch.from_numpy(raw.astype(np.float32)).to(dev)
    want = iface.predict_step(batch)
    try:
        t0 = time.perf_counter()
        iface.save(path, step=4)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = time.perf_counter()
        back = AnemoiModelInterface.from_checkpoint(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = back.predict_step(batch)
        step = load_checkpoint(path)["step"]
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if not torch.equal(got, want):
        raise AssertionError(f"checkpoint round trip: predict_step differs "
                             f"(max {(got.float() - want.float()).abs().max().item():.3e})")
    if back.id != iface.id or step != 4:
        raise AssertionError("checkpoint round trip: run id or step not restored")
    return {"bytes_on_disk": nbytes, "save_s": save_s, "load_s": load_s, "predict_step_bit_identical": True}


def phase_determinism(graph, dev, flavor: str) -> dict:
    """Two models of one flavor's O96 flagship (bf16, remat "full") built
    from the same seed, two train steps each on the same batch: the losses
    and every parameter and AdamW moment compared bit for bit. Returns
    whether all are identical, the first leaf that differs and the largest
    difference."""
    cfg = configs.flagship(num_channels=256, num_layers=8, num_chunks=2, dtype="bfloat16", remat_policy="full",
                       flavor=flavor)
    runs = []
    for _ in range(2):
        iface = interface(graph, cfg, dev, seed=7)
        model = iface.model
        x, y = (t.to(dev) for t in train_batch(iface, graph["data"].num_nodes, seed=21))
        opt = make_optimizer(model.parameters(), 1e-3, warmup_steps=1, total_steps=100)
        step = make_train_step(model, opt)
        losses = [step(x, y) for _ in range(2)]
        leaves = {"losses": torch.stack(losses)}
        for name, p in model.named_parameters():
            leaves[f"param {name}"] = p.detach().clone()
            leaves[f"mu {name}"] = opt.state[p]["mu"].clone()
            leaves[f"nu {name}"] = opt.state[p]["nu"].clone()
        runs.append(leaves)
        del iface, model, opt, step
        torch.cuda.synchronize()
    first, largest = None, 0.0
    for name, a in runs[0].items():
        b = runs[1][name]
        if not torch.equal(a, b):
            first = first or name
            largest = max(largest, (a.float() - b.float()).abs().max().item())
    return {"bit_identical": first is None, "first_differing_leaf": first, "largest_difference": largest,
            "leaves": len(runs[0]), "losses": runs[0]["losses"].tolist()}


def phase_attn_widths(graph, dev, cases) -> list:
    """edge_attn_csr and edge_attn_csr_bwd on ``graph``'s edge sets at the
    widths of ``cases`` ((label, (source, destination), C, heads) and, where
    given, the count of trainable edge features: WIDE_ATTN, HIER_ATTN,
    FLAT_ATTN, A2_ATTN), fp32 and bf16, batch 1, against their plain
    versions at the flagship's bounds (forward elementwise, backward
    normwise), two calls of each bit-identical; each timed beside its bound
    and its plain version, with the backward's count of dw_aug parts."""
    gen = torch.Generator().manual_seed(8)
    rows = []
    for label, names, c, h, *trainable in cases:
        case = edge_case(graph, label, dev, gen, c, h=h, names=names, trainable=(trainable or [TRAINABLE_EDGES])[0])
        rp, sr, csr_t = case["rowptr"], case["src"], case["csr_t"]
        g_num, g_den = case["g_num"].to(dev), case["g_den"].to(dev)
        shape = (f"{label} C={c} H={h} D={c // h} A2={case['a'].shape[1]} E={case['num_edges']} Nd={case['nd']} "
                 f"Ns={case['ns']}")
        for dt in (torch.float32, torch.bfloat16):
            q, kv, a, wa = (case[k].to(dev, dt) for k in ("q", "kv", "a", "w_aug"))
            fwd = (q, kv, rp, sr, a, wa, h)
            got, again, want = ea.edge_attn_csr(*fwd), ea.edge_attn_csr(*fwd), ea.edge_attn_csr_plain(*fwd)
            torch.cuda.synchronize()
            what = f"edge_attn_csr {shape} {dt}"
            if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
                raise AssertionError(f"{what}: two calls differ (not run-to-run deterministic)")
            fwd_err = max(max_err(g, w_, TOL[dt], f"{what} {n}") for g, w_, n in zip(got, want, ("num", "den", "m")))
            args = (q, kv, rp, sr, a, wa, got.m, g_num, g_den, h)
            bgot, bagain = ea.edge_attn_csr_bwd(*args, csr_t), ea.edge_attn_csr_bwd(*args, csr_t)
            bwant = ea.edge_attn_csr_bwd_plain(*args)
            torch.cuda.synchronize()
            what = f"edge_attn_csr_bwd {shape} {dt}"
            for name, g, g2 in zip(("dq", "dkv", "da", "dw_aug"), bgot, bagain):
                if not torch.equal(g, g2):
                    raise AssertionError(f"{what} {name}: two calls differ (not run-to-run deterministic)")
            bwd_err = max(normwise_err(g, w_, f"{what} {n}") for g, w_, n in zip(bgot, bwant, ("dq", "dkv", "da", "dw_aug")))
            fb, bb = attn_bounds(case, c, h, dt)
            rows.append({"shape": shape, "dtype": str(dt).split(".")[-1], "bit_identical": True,
                         "fwd_max_abs_err": fwd_err, "bwd_normwise_err": bwd_err,
                         "fwd_ms": cuda_ms(lambda: ea.edge_attn_csr(*fwd)), "fwd_bound_ms": fb["bound_ms"],
                         "fwd_plain_ms": cuda_ms(lambda: ea.edge_attn_csr_plain(*fwd), iters=3, warmup=1),
                         "bwd_ms": cuda_ms(lambda: ea.edge_attn_csr_bwd(*args, csr_t)), "bwd_bound_ms": bb["bound_ms"],
                         "bwd_plain_ms": cuda_ms(lambda: ea.edge_attn_csr_bwd_plain(*args), iters=3, warmup=1),
                         "bwd_parts": ea._bwd_parts(case["nd"], h * ea._kernel_head(c, h), case["a"].shape[1])})
            del want, bwant
    return rows


def busy_share(profile: dict, call_ms: list) -> list:
    """The device's busy share of each timed call: the profiled call's
    device busy ms over the call's ms by CUDA events, without the profiler."""
    return [profile["device_busy_ms"] / ms for ms in call_ms]


def phase_hierarchical(hgraph, names: list, dev, profile_dir: str) -> tuple[dict, dict]:
    """bench.py's hierarchical model at full width on the O96 grid and the
    r5 / r4 / r3 pyramid (C = 256 / 512 / 1024, 4 heads: D = 64 / 128 / 256),
    bf16, batch 1: three predict_step requests and three train steps (AdamW
    at peak learning rate 1e-5, as the C = 1024 phases train; remat "full")
    after a warm-up of each, finite outputs and losses, falling losses,
    EXPECTED["hierarchical"] launches per request and step, peak memory, and
    a profiled request and step for the busy share."""
    cfg = configs.flagship_hierarchical(names)
    serving = phase_serving(hgraph, dev, "hierarchical", cfg=cfg, expected=EXPECTED["hierarchical"][0])
    train, trained = phase_train(hgraph, dev, None, "hierarchical", remat_none=False, lr=1e-5,
                                 expected=EXPECTED["hierarchical"][1], cfg=cfg)
    di, stats = trained.data_indices, trained.statistics
    in_idx = np.asarray(di.data.input.full)
    raw = stats["mean"][in_idx] + stats["stdev"][in_idx] * np.random.RandomState(33).randn(
        1, 2, hgraph["data"].num_nodes, len(in_idx))
    batch = torch.from_numpy(raw.astype(np.float32)).to(dev)
    serving["profile"] = phase_profile(lambda: trained.predict_step(batch), profile_dir, "request_hierarchical")
    serving["busy_share"] = busy_share(serving["profile"], serving["request_ms"])
    x, y = (t.to(dev) for t in train_batch(trained, hgraph["data"].num_nodes, seed=22))
    step = make_train_step(trained.model, make_optimizer(trained.model.parameters(), 1e-5, warmup_steps=1,
                                                         total_steps=100))
    train["profile"] = phase_profile(lambda: step(x, y), profile_dir, "train_step_hierarchical")
    train["busy_share"] = busy_share(train["profile"], train["step_ms"])
    train["levels"] = {name: {"nodes": hgraph[name].num_nodes, "channels": trained.model.hidden_dims[name]}
                       for name in names}
    return serving, train


def aifs_config(channels: int = 256, num_layers: int = 8, num_chunks: int = 2, dtype: str = "bfloat16") -> DotDict:
    """The GraphTransformer flagship under the AIFS data path: a normalizer
    (std for precipitation, none for cloud cover), an InputImputer filling
    the sst's land points with its mean, a Remapper (Monomapper: log1p on tp
    and cp, as the JAX package's tests/preprocessing configure it) and the
    four boundings in config order."""
    cfg = configs.flagship(num_channels=channels, num_layers=num_layers, num_chunks=num_chunks, dtype=dtype)
    cfg.data.diagnostic = ["t2m"]
    cfg.data.processors = {
        "normalizer": {"_target_": "anemoi.models.preprocessing.normalizer.InputNormalizer",
                       "config": {"default": "mean-std", "std": ["tp", "cp"], "none": ["tcc"]}},
        "imputer": {"_target_": "anemoi.models.preprocessing.imputer.InputImputer",
                    "config": {"default": "none", "mean": ["sst"]}},
        "remapper": {"_target_": "anemoi.models.preprocessing.remapper.Remapper",
                     "config": {"log1p": ["tp", "cp"]}},
    }
    cfg.model.bounding = AIFS_BOUNDING
    return cfg


def aifs_statistics() -> dict:
    """Seeded statistics, tp and cp with one stdev (so cp <= tp holds in
    physical units once it holds in the model's)."""
    stats = statistics(40, len(AIFS_NAME_TO_INDEX))
    stats["stdev"][AIFS_NAME_TO_INDEX["cp"]] = stats["stdev"][AIFS_NAME_TO_INDEX["tp"]]
    return stats


def aifs_batch(n_grid: int, seed: int, land: np.ndarray, stats: dict, steps: int = 2) -> torch.Tensor:
    """(1, steps, grid, input vars) physical values at the model's input
    width: precipitation from a gamma law with its convective part below
    it, cloud cover in [0, 1], the land-sea mask and the sst NaN on land."""
    rng = np.random.RandomState(seed)
    v = AIFS_NAME_TO_INDEX
    x = stats["mean"] + stats["stdev"] * rng.randn(1, steps, n_grid, len(v))
    x[..., v["tp"]] = rng.gamma(1.0, 1.0, (1, steps, n_grid))
    x[..., v["cp"]] = x[..., v["tp"]] * rng.rand(1, steps, n_grid)
    x[..., v["tcc"]] = rng.rand(1, steps, n_grid)
    x[..., v["lsm"]] = land
    x[:, :, land, v["sst"]] = np.nan
    return torch.from_numpy(np.delete(x, v["t2m"], axis=-1).astype(np.float32))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit alike, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0))


def check_aifs_output(y: torch.Tensor, di, land: np.ndarray, what: str) -> None:
    """NaN exactly at the imputed sst's land points and nowhere else; tp >= 0,
    0 <= tcc <= 1, 0 <= cp <= tp."""
    n2i = di.model.output.name_to_index
    nan = torch.isnan(y).cpu()
    sst = nan[..., n2i["sst"]]
    if not bool((sst == torch.from_numpy(land)).all()) or int(nan.sum()) != int(sst.sum()):
        raise AssertionError(f"{what}: NaN not exactly at the imputer's {int(land.sum())} land points "
                             f"({int(sst.sum())} sst NaN, {int(nan.sum())} in all)")
    tp, cp, tcc = (y[..., n2i[k]] for k in ("tp", "cp", "tcc"))
    if not (bool((tp >= 0).all()) and bool((tcc >= 0).all()) and bool((tcc <= 1).all())
            and bool((cp >= 0).all()) and bool((cp <= tp).all())):
        raise AssertionError(f"{what}: a bounded variable left its bounds (tp {tp.min().item():.3g}, "
                             f"tcc [{tcc.min().item():.3g}, {tcc.max().item():.3g}], cp - tp {(cp - tp).max().item():.3g})")


def phase_aifs_data(graph, dev, small_graph, profile_dir: str) -> tuple[dict, dict]:
    """The flagship (O96, r5, C = 256, 8 layers, 4 heads, bf16) under the AIFS
    data path (aifs_config): fit_processors, then three predict_step
    requests with NaN exactly at the imputer's land mask and the bounded
    variables within bounds, the flagship's launches a request; a 4-lead-time
    predict_rollout; two train steps with the imputer's loss mask (finite
    losses, the flagship's launches a step); a checkpoint round trip that
    carries the imputer state and serves bit for bit; and the same config
    reduced (fp32, C = 64, 2 layers, a 16-latitude grid and an r3 mesh) on
    the card against the CPU, through the model and the whole pipeline. A
    request and a train step are profiled for the busy share."""
    stats = aifs_statistics()
    n_grid = graph["data"].num_nodes
    land = np.random.RandomState(41).rand(n_grid) < 0.3
    iface = interface(graph, aifs_config(), dev, seed=5, name_to_index=AIFS_NAME_TO_INDEX, stats=stats)
    di = iface.data_indices
    iface.fit_processors(aifs_batch(n_grid, 50, land, stats).to(dev))
    requests = [aifs_batch(n_grid, seed, land, stats).to(dev) for seed in (51, 52, 53, 54)]
    iface.predict_step(requests[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms, per_request = [], []
    for batch in requests[1:]:
        before = launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = iface.predict_step(batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        per_request.append({k: v - before[k] for k, v in launches().items()})
        check_aifs_output(y, di, land, "aifs-data predict_step")
    counts = launches()
    expected = expect(counts, EXPECTED["graphtransformer"][0])
    if any(c != expected for c in per_request):
        raise AssertionError(f"aifs-data serving: expected {expected} launches per request, got {per_request}")
    serving = {"request_ms": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
               "per_request": per_request[-1], "land_points": int(land.sum())}
    serving["profile"] = phase_profile(lambda: iface.predict_step(requests[1]), profile_dir, "request_aifs_data")
    serving["busy_share"] = busy_share(serving["profile"], ms)

    # a 4-lead-time forecast, forcings pre-processed (the land-sea mask, normalized)
    n_forcing = len(di.internal_model.input.forcing)
    forcings = torch.from_numpy(np.random.RandomState(55).randn(ROLLOUT_STEPS, 1, 1, n_grid, n_forcing)
                                .astype(np.float32)).to(dev)
    reset_launches()
    preds = iface.predict_rollout(requests[1], ROLLOUT_STEPS, forcings)
    serving["rollout_launches"] = launches()
    expected = expect(counts, {k: ROLLOUT_STEPS * v for k, v in EXPECTED["graphtransformer"][0].items()})
    if serving["rollout_launches"] != expected:
        raise AssertionError(f"aifs-data rollout: expected {expected} launches, got {serving['rollout_launches']}")
    for t in range(ROLLOUT_STEPS):
        check_aifs_output(preds[t], di, land, f"aifs-data rollout lead time {t}")
    if not same_bits(preds[0], iface.predict_step(requests[1])):
        raise AssertionError("aifs-data rollout: the first lead time differs from predict_step")

    # two train steps with the imputer's loss mask, on the pre-processed batch
    mask = loss_mask(iface.pre_processors)
    if mask is None or not bool((mask == 0).any()):
        raise AssertionError("aifs-data: the imputer gave no loss mask with masked points")
    with torch.no_grad():
        x = iface.pre_processors(requests[1])[:, :2, None]
    y_t = torch.from_numpy(np.random.RandomState(56).randn(1, 1, n_grid, len(di.internal_model.output))
                           .astype(np.float32)).to(dev)
    model = iface.model
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-3, warmup_steps=1, total_steps=100),
                           WeightedMSELoss(loss_mask=mask))
    reset_launches()
    losses, step_ms, per_step = timed_steps(step, x, y_t, 2)
    expected = expect(launches(), EXPECTED["graphtransformer"][1])
    if not np.all(np.isfinite(losses)) or any(c != expected for c in per_step):
        raise AssertionError(f"aifs-data train: losses {losses}, launches {per_step} (expected {expected})")
    train = {"losses": losses, "step_ms": step_ms, "launches": launches(), "per_step": per_step[-1],
             "masked_points": int((mask == 0).sum())}
    train["profile"] = phase_profile(lambda: step(x, y_t), profile_dir, "train_step_aifs_data")
    train["busy_share"] = busy_share(train["profile"], step_ms[1:])

    # the checkpoint carries the imputer state and serves bit for bit
    model.eval()
    want = iface.predict_step(requests[2])
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_aifs_checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    try:
        iface.save(path)
        back = AnemoiModelInterface.from_checkpoint(path, device="cuda")
        got = back.predict_step(requests[2])
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if not torch.equal(back.pre_processors.processors["imputer"].nan_locations,
                       iface.pre_processors.processors["imputer"].nan_locations) or not same_bits(got, want):
        raise AssertionError("aifs-data checkpoint round trip: the imputer state or predict_step differs")
    serving["checkpoint_bit_identical"] = True

    # the same data path reduced, fp32, on the card against the CPU
    n_small = small_graph["data"].num_nodes
    small_land = np.random.RandomState(42).rand(n_small) < 0.3
    reduced = phase_reduced_model(small_graph, dev, cfg=aifs_config(64, 2, 1, "float32"),
                                  name_to_index=AIFS_NAME_TO_INDEX, stats=stats,
                                  pipeline_batch=aifs_batch(n_small, 57, small_land, stats))
    return {**serving, "reduced": reduced}, train


TRAIN_RUN_VARS = 8  # the synthetic O96 record of phase_train_run: 8 variables, 2 of them forcings
TRAIN_RUN_STEPS = 32
TRAIN_RUN_FORCING = ("var_0", "var_1")
# the GraphTransformer flagship as bench.py builds it, through the port's configs.enc_proc_dec
FLAGSHIP_KWARGS = dict(num_channels=256, num_layers=8, num_chunks=2, num_heads=4, trainable_hidden=8,
                       trainable_edges=4, remat_policy="full", compute_dtype="bfloat16")
# (label, (source, destination), C, heads): heads wider than 256 (16 or 32 channels a lane) and a head
# width the wrapper pads with zero channels (D = 10 -> 16), on the flat processor's set
HEAD_WIDTH_ATTN = (("processor D=320", ("hidden", "hidden"), 640, 2),
                   ("processor D=512", ("hidden", "hidden"), 1024, 2),
                   ("processor D=1024", ("hidden", "hidden"), 1024, 1),
                   ("processor D=10", ("hidden", "hidden"), 40, 4))
# and the hierarchical model's r3 level set at one head of 1024
HIER_WIDE_ATTN = (("r3 level processor D=1024", ("hidden_3", "hidden_3"), 1024, 1),)
FLASH_WIDTHS = (24, 48, 96, 256, 512)  # flash_attention's head widths off the parent's four


def o96_record(graph):
    """The synthetic O96 record of phase_train_run and phase_dropout
    (TRAIN_RUN_VARS variables over TRAIN_RUN_STEPS steps on the O96 grid's
    coordinates, about 41 MB in fp32), written as an anemoi-layout zarr
    store by the port's writer and read back bit for bit: the zarr source."""
    from anemoi_models_tpu_torch.training import SyntheticSource, open_dataset, save_zarr_dataset

    coords = np.asarray(graph["data"].coords, np.float64)
    synthetic = SyntheticSource(coords, TRAIN_RUN_VARS, num_steps=TRAIN_RUN_STEPS, seed=5)
    record = np.stack([synthetic.window(t, 1)[0] for t in range(TRAIN_RUN_STEPS)])
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_o96.zarr")
    shutil.rmtree(path, ignore_errors=True)
    save_zarr_dataset(path, record, synthetic.variables, synthetic.coords, synthetic.statistics)
    source = open_dataset(path)
    if not np.array_equal(source.window(0, TRAIN_RUN_STEPS), record):
        raise AssertionError("the zarr store the port wrote does not read back bit for bit")
    return source


class FirstSteps:
    """The first ``n`` steps of a data source: with ``n`` the training
    window, every batch of a run is the same one."""

    def __init__(self, source, n: int) -> None:
        self.source, self.n = source, n
        self.variables, self.coords, self.statistics = source.variables, source.coords, source.statistics
        self.name_to_index = source.name_to_index

    def __len__(self) -> int:
        return self.n

    def window(self, start: int, length: int) -> np.ndarray:
        if start < 0 or start + length > self.n:
            raise IndexError(f"window [{start}, {start + length}) outside {self.n} steps")
        return self.source.window(start, length)


def trace_busy_ms(trace_path: str) -> float:
    """The device's busy ms in a torch.profiler chrome trace: the union of
    its kernel, copy and set intervals."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, None
    for s, t in spans:
        if end is None or s > end:
            busy, end = busy + t - s, t
        elif t > end:
            busy, end = busy + t - end, t
    return busy / 1e3


def _state(run: dict) -> dict:
    """Parameters, AdamW moments and count, and EMA of a train_run result."""
    model, opt = run["model"], run["optimizer"]
    out = {f"param {n}": p.detach() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        out[f"mu {n}"], out[f"nu {n}"] = opt.state[p]["mu"], opt.state[p]["nu"]
    out.update({f"ema {n}": t for n, t in (run["ema"] or {}).items()})
    return out


def phase_train_run(source, dev) -> dict:
    """The training driver at full width: ``train_run`` on the O96
    GraphTransformer flagship (bench.py's config, batch 1) from the zarr
    store of :func:`o96_record`, with 2 ensemble members and the fair CRPS
    through the rollout curriculum [(0, 1), (4, 2)], 8 steps, EMA 0.999, an
    eval of a 2-lead-time rollout on the held-out tail at steps 4 and 8 and a
    checkpoint every 4 steps; then the same run boxed at 4 steps and resumed
    to 8, which must give the uninterrupted run's losses, evals, parameters,
    AdamW moments and EMA bit for bit. Launches: 3 steps of one lead time and
    5 of two, each a train step's (EXPECTED), and two 2-lead-time evals of a
    request's each, in total exactly."""
    from anemoi_models_tpu_torch.training import train_run

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_train_run")
    shutil.rmtree(root, ignore_errors=True)
    common = dict(forcing=TRAIN_RUN_FORCING, mesh_refinements=5, model_kwargs=FLAGSHIP_KWARGS, steps=8,
                  batch_size=1, ensemble=2, loss="crps", rollout_schedule=[(0, 1), (4, 2)], ema_decay=0.999,
                  eval_every=4, eval_rollout=2, save_every=4, seed=0, log_every=1, log=lambda s: None,
                  device=dev, handle_signals=False)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = train_run(source, checkpoint_dir=os.path.join(root, "a"), profile_dir=os.path.join(root, "profile"),
                     profile_steps=(5, 7), **common)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    one, two = EXPECTED["graphtransformer"][1], {k: 2 * v for k, v in EXPECTED["graphtransformer"][1].items()}
    evals = {k: 2 * 2 * v for k, v in EXPECTED["graphtransformer"][0].items()}  # 2 evals of 2 lead times
    # the curriculum's length at step s is the longest whose start is at most s: steps 1-3 one, 4-8 two
    expected = expect(counts, {k: 3 * one.get(k, 0) + 5 * two.get(k, 0) + evals.get(k, 0) for k in counts})
    if counts != expected:
        raise AssertionError(f"train_run: expected {expected} launches in all, got {counts}")
    losses = full["losses"]
    if len(losses) != 8 or not np.all(np.isfinite(losses)) or len(full["eval"]) != 2:
        raise AssertionError(f"train_run: losses {losses} or evals {full['eval']} incomplete or not finite")
    if not all(np.all(np.isfinite(e["rmse"])) for e in full["eval"]):
        raise AssertionError(f"train_run: non-finite eval scores {full['eval']}")
    if not os.path.exists(os.path.join(root, "a", "graph.npz")) or load_checkpoint(
            os.path.join(root, "a", "latest"))["step"] != 8:
        raise AssertionError("train_run: the graph-once checkpoint layout is missing")
    busy = trace_busy_ms(os.path.join(root, "profile", "train_run_trace.json")) / 2  # steps 6 and 7
    step_ms = full["step_ms"]
    resumed_part = train_run(source, checkpoint_dir=os.path.join(root, "b"), max_steps_this_run=4, **common)
    rest = train_run(source, checkpoint_dir=os.path.join(root, "b"), resume=True, **common)
    want, got = _state(full), _state(rest)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    if resumed_part["losses"] + rest["losses"] != losses or differ or \
            [e["rmse"] for e in resumed_part["eval"] + rest["eval"]] != [e["rmse"] for e in full["eval"]]:
        raise AssertionError(f"train_run resume: not bit for bit ({len(differ)} tensors differ, e.g. {differ[:3]}; "
                             f"losses {resumed_part['losses'] + rest['losses']} vs {losses})")
    shutil.rmtree(root, ignore_errors=True)
    return {"losses": losses, "eval": [{k: e[k] for k in ("step", "rmse_mean", "skill_mean")} for e in full["eval"]],
            "step_ms": step_ms, "steps_per_s_by_events": [1e3 / ms for ms in step_ms],
            "run_wall_s": wall_s, "loader_wait_ms": full["loader_wait_s"] * 1e3,
            "busy_share_rollout2": busy / float(np.median(step_ms[3:])), "device_busy_ms_per_step": busy,
            "peak_mem_gib": peak, "launches": counts,
            "per_step": {"rollout 1": expect(counts, one), "rollout 2": expect(counts, two)},
            "resume_bit_identical": True, "tensors_compared": len(want)}


MEMORY_POLICIES = ("full", "save_dots", "none", "cpu_offload")
MEMORY_STEPS = 3  # train steps of each policy's run, the first a warm-up (lr 0)
O320_GRAPH = dict(grid_lat=320, mesh_refinements=6, grid="octahedral")


def memory_config(flavor: str, channels: int, heads: int) -> DotDict:
    """The O96 flagship config of ``flavor`` at ``channels``."""
    return configs.flagship(num_channels=channels, num_layers=8, num_chunks=2, dtype="bfloat16", flavor=flavor,
                        num_heads=heads)


def set_memory_policy(model: torch.nn.Module, policy: str) -> None:
    """Every remat unit of ``model`` under ``policy``: the processor's chunks
    under that ``remat_policy``, or every unit (the chunks, both mapper
    blocks) under ``cpu_offload``, as a config that sets it builds them."""
    for module in model.modules():
        if hasattr(module, "cpu_offload"):
            module.cpu_offload = policy == "cpu_offload"
        if hasattr(module, "remat_policy"):
            module.remat_policy = "full" if policy == "cpu_offload" else policy


def policy_launches(flavor: str, policy: str) -> dict:
    """Launches of a flagship train step under ``policy``: the forward's,
    the processor's 8 layers again under "full" and "save_dots" (the kernels
    are not 2-D products, so "save_dots" recomputes them), the 2 mapper
    blocks again under every remat policy, nothing again under
    cpu_offload."""
    proc = 8 if policy in ("full", "save_dots") else 0
    maps = 0 if policy == "cpu_offload" else 2
    if flavor == "graphtransformer":
        return {"kv_proj": 10 + proc + maps, "edge_attn_csr": 10 + proc + maps, "edge_attn_csr_bwd": 10}
    if flavor == "gnn":
        return {"gnn_conv_layered": 10 + proc + maps, "gnn_conv_bwd": 10}
    return {"flash_attention": 8 + proc, "flash_attention_bwd": 8, "kv_proj": 2 + maps, "edge_attn_csr": 2 + maps,
            "edge_attn_csr_bwd": 2}


def _free_device_memory() -> int:
    import gc as collector

    collector.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def policy_runs(graph, dev, cfg: DotDict, flavor: str, policies: tuple, steps: int, lr: float,
                dropout: bool = False) -> tuple[dict, AnemoiModelInterface]:
    """``cfg``'s model (seed 4) trained from the same parameters under each
    of ``policies`` (:func:`set_memory_policy`), ``steps`` steps on one
    batch with a fresh optimizer each: step ms after the first, the peak
    GiB of the steps after the first (or of the one step), the host bytes
    cpu_offload held in the last step, launches a step against
    :func:`policy_launches`; the losses, every parameter and every gradient
    after the last step bit-identical to the first policy's. Returns the
    numbers and the interface."""
    from anemoi_models_tpu_torch.layers import remat
    from anemoi_models_tpu_torch.training import dropout_twin

    t0 = time.perf_counter()
    iface = interface(graph, cfg, dev, seed=4)
    model = iface.model
    runs: dict = {"build_s": time.perf_counter() - t0}
    initial = {name: p.detach().cpu() for name, p in model.named_parameters()}
    x, y = (t.to(dev) for t in train_batch(iface, graph["data"].num_nodes, seed=20))
    ref = None
    for policy in policies:
        t0 = time.perf_counter()
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(initial[name])
                p.grad = None
        set_memory_policy(model, policy)
        step = make_train_step(dropout_twin(model) if dropout else model,
                               make_optimizer(model.parameters(), lr, warmup_steps=1, total_steps=100),
                               dropout_seed=3)
        resident = _free_device_memory()
        losses, ms, per_step = [], [], []
        reset_launches()
        for i in range(steps):
            if i == min(1, steps - 1):
                torch.cuda.reset_peak_memory_stats()
            remat.OFFLOADED.update(tensors=0, bytes=0)
            loss, t, counts = timed_steps(step, x, y, 1)
            losses, ms, per_step = losses + loss, ms + t, per_step + counts
        peak = torch.cuda.max_memory_allocated()
        want = expect(per_step[0], policy_launches(flavor, policy))
        if any(c != want for c in per_step) or not np.all(np.isfinite(losses)):
            raise AssertionError(f"memory {flavor} {policy}: expected {want} launches a step, got {per_step}; "
                                 f"losses {losses}")
        state = {"losses": torch.tensor(losses)}
        for name, p in model.named_parameters():
            state[f"param {name}"], state[f"grad {name}"] = p.detach().cpu(), p.grad.cpu()
        if ref is None:
            ref = state
        differ = [k for k in ref if not torch.equal(ref[k], state[k])]
        if differ:
            raise AssertionError(f"memory {flavor} {policy}: not bit-identical to {policies[0]} "
                                 f"({len(differ)} tensors differ, e.g. {differ[:3]})")
        runs[policy] = {"losses": losses, "step_ms": ms[1:] if steps > 1 else ms, "peak_gib": peak / 2**30,
                        "peak_bytes": peak, "resident_gib": resident / 2**30,
                        "offloaded_host_bytes": remat.OFFLOADED["bytes"],
                        "offloaded_tensors": remat.OFFLOADED["tensors"], "per_step": per_step[-1],
                        "bit_identical_to": policies[0], "wall_s": time.perf_counter() - t0}
        del step, state
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(initial[name])
            p.grad = None
    return runs, iface


def phase_memory(graph, source, dev) -> dict:
    """The memory policies of a train step (item 20 of the module's list)."""
    from anemoi_models_tpu_torch.training import estimate_step_bytes, resolve_remat_policy, train_run

    out: dict = {}
    timing = {}
    t0 = time.perf_counter()
    gt, gt_iface = policy_runs(graph, dev, memory_config("graphtransformer", 1024, 16), "graphtransformer",
                               MEMORY_POLICIES, MEMORY_STEPS, 1e-5)
    out["graphtransformer C=1024 H=16"] = gt
    timing["graphtransformer"] = time.perf_counter() - t0
    if not (gt["save_dots"]["peak_bytes"] < gt["none"]["peak_bytes"]
            and gt["cpu_offload"]["peak_bytes"] < gt["none"]["peak_bytes"]):
        raise AssertionError(f"GT C=1024 peaks: save_dots {gt['save_dots']['peak_gib']:.3f}, cpu_offload "
                             f"{gt['cpu_offload']['peak_gib']:.3f} GiB not below none {gt['none']['peak_gib']:.3f}")

    # remat_policy="auto" on the same GT step: the estimate against the "none" run's measured peak
    t0 = time.perf_counter()
    model = gt_iface.model
    set_memory_policy(model, "none")
    opt = make_optimizer(model.parameters(), 1e-5, warmup_steps=1, total_steps=100)
    n_grid, di = graph["data"].num_nodes, gt_iface.data_indices
    shapes = ((1, 2, 1, n_grid, len(di.internal_model.input)), (1, 1, n_grid, len(di.internal_model.output)))
    resident = _free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    estimate = estimate_step_bytes(model, opt, *shapes)
    counting_peak = torch.cuda.max_memory_allocated()
    msgs: list = []
    at_card = resolve_remat_policy(model, opt, *shapes, log=msgs.append)
    at_1kib = resolve_remat_policy(model, opt, *shapes, limit_bytes=1 << 10, log=msgs.append)
    measured = gt["none"]["peak_bytes"]
    auto = {"estimate_bytes": estimate, "estimate_gib": estimate / 2**30, "none_peak_gib": measured / 2**30,
            "estimate_over_none_peak": estimate / measured, "counting_forward_peak_gib": counting_peak / 2**30,
            "resident_gib": resident / 2**30, "card_budget_gib": torch.cuda.mem_get_info(dev)[1] / 2**30,
            "at_card_budget": at_card, "at_1_KiB": at_1kib, "log": msgs}
    del gt_iface, model, opt
    if at_card != "none" or at_1kib != "full":
        raise AssertionError(f"remat auto: {at_card!r} at the card's budget, {at_1kib!r} at 1 KiB ({msgs})")
    if estimate < 0.85 * measured:
        raise AssertionError(f"remat auto: estimate {estimate / 2**30:.3f} GiB is under 0.85x the measured "
                             f"'none' peak {measured / 2**30:.3f} GiB")
    _free_device_memory()
    run_log: list = []
    # the variant phase_train_run trains: the curriculum's 2 lead times, 2 members, CRPS, EMA
    run = train_run(source, forcing=TRAIN_RUN_FORCING, mesh_refinements=5,
                    model_kwargs=dict(FLAGSHIP_KWARGS, remat_policy="auto"), steps=2, batch_size=1, seed=0,
                    rollout_schedule=[(0, 1), (1, 2)], ensemble=2, loss="crps", ema_decay=0.999, log_every=1,
                    log=run_log.append, device=dev, handle_signals=False)
    said = [m for m in run_log if m.startswith("remat auto:")]
    kept = sorted({chunk.remat_policy for chunk in run["model"].processor.proc})
    if len(said) != 1 or not said[0].endswith("-> none") or kept != ["none"] or \
            len(run["losses"]) != 2 or not np.all(np.isfinite(run["losses"])):
        raise AssertionError(f"train_run(remat_policy='auto'): {said}, chunks {kept}, losses {run['losses']}")
    auto["train_run"] = {"log": said, "chunks": kept, "losses": run["losses"], "step_ms": run["step_ms"]}
    del run
    out["auto"] = auto
    timing["auto"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["gnn C=1024"], _ = policy_runs(graph, dev, memory_config("gnn", 1024, 4), "gnn", MEMORY_POLICIES,
                                       MEMORY_STEPS, 1e-5)
    timing["gnn"] = time.perf_counter() - t0
    # the Transformer with attention dropout: the recompute and the host copies give the masks of "full"
    t0 = time.perf_counter()
    cfg = memory_config("transformer", 256, 4)
    cfg.model.processor.dropout_p = 0.1
    out["transformer C=256 dropout 0.1"], _ = policy_runs(graph, dev, cfg, "transformer",
                                                          ("full", "save_dots", "cpu_offload"), 1, 1e-5, dropout=True)
    timing["transformer dropout"] = time.perf_counter() - t0
    # the flagship GT at O320 / r6 under "full" and cpu_offload
    t0 = time.perf_counter()
    o320 = build_enc_proc_dec_graph(**O320_GRAPH)
    graph_s = time.perf_counter() - t0
    runs, _ = policy_runs(o320, dev, memory_config("graphtransformer", 256, 4), "graphtransformer",
                          ("full", "cpu_offload"), 2, 1e-5)
    out["graphtransformer O320 C=256"] = {"graph_s": graph_s, "grid": o320["data"].num_nodes,
                                          "hidden": o320["hidden"].num_nodes, **runs}
    del o320
    timing["o320"] = time.perf_counter() - t0
    _free_device_memory()
    out["phase_s"] = timing
    return out


def phase_dropout(source, dev) -> tuple[dict, dict]:
    """Attention-weight dropout. Kernel: flash_attention with p = 0.1
    against the plain blockwise version under the same key at the O96
    processor's shape (4 heads, N = 10,242, D = 64, w = 512), fp32 1e-5 and
    bf16 2e-2; repeats bit-identical, the next step's key another output, p
    = 0 the dropout-free kernel's bits; the kernel's keep rate (q = k = 0,
    v = 1: each output is the kept share of its band over 1 - p) within 5
    sigma of 0.9. Model: 3 steps of ``train_run`` on the O96 Transformer
    flavor (4 heads, w = 512) with dropout_p = 0.1, on one window of the
    record (so the losses compare like with like), at peak learning rate
    1e-5: the first update has lr 0, and Adam's next moves every weight by
    about the learning rate, which from the flax initialisation raised this
    model's loss at 1e-3 and 3e-4 on an H100, as the production width's
    seeded loss rises at the flagship's rate; finite, falling."""
    from anemoi_models_tpu_torch.training import train_run

    gen = torch.Generator().manual_seed(9)
    n, h, d, w, p = 10242, 4, 64, 512, 0.1
    qkv32 = torch.randn(1, n, 3, h, d, generator=gen)
    key = fa.fold_key(17, 3, 1)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        qkv = qkv32.to(dev, dt)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        got, again = fa.flash_attention(q, k, v, w, False, p, key), fa.flash_attention(q, k, v, w, False, p, key)
        want = fa.blockwise_attention(q, k, v, window_size=w, dropout_rate=p, dropout_key=key)
        other = fa.flash_attention(q, k, v, w, False, p, fa.fold_key(17, 4, 1))
        torch.cuda.synchronize()
        err = max_err(got, want, TOL[dt], f"flash_attention dropout {dt}")
        if not torch.equal(got, again) or torch.equal(got, other):
            raise AssertionError(f"flash_attention dropout {dt}: repeats differ or another key gives the same output")
        if not torch.equal(fa.flash_attention(q, k, v, w, False, 0.0, key), fa.flash_attention(q, k, v, w)):
            raise AssertionError(f"flash_attention {dt}: p = 0 does not keep the dropout-free bits")
        flops = cost.flash_flops(h, fa.live_pairs(n, w, False), d)
        rows.append({"kernel": "flash_attention", "shape": f"B*H={h} N={n} D={d} w={w} dropout={p}",
                     "dtype": str(dt).split(".")[-1], "max_abs_err": err, "bit_identical": True,
                     "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, w, False, p, key)),
                     "no_dropout_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, w)),
                     "plain_ms": cuda_ms(lambda: fa.blockwise_attention(q, k, v, window_size=w, dropout_rate=p,
                                                                        dropout_key=key), iters=3, warmup=1),
                     **bound(4 * h * n * d * qkv.element_size(), flops,
                             "bf16 tensor" if dt == torch.bfloat16 else "fp32"), "library_ms": None})
    zeros, ones = torch.zeros(1, h, n, d, device=dev), torch.ones(1, h, n, d, device=dev)
    share = fa.flash_attention(zeros, zeros, ones, w, False, p, key)[..., 0] * (1 - p)  # kept share of each band
    band = torch.tensor([min(n - 1, i + w) - max(0, i - w) + 1 for i in range(n)], device=dev, dtype=torch.float64)
    kept = float((share.double() * band).sum())
    pairs = float(band.sum()) * h
    sigma = (pairs * 0.9 * 0.1) ** 0.5
    if abs(kept - 0.9 * pairs) > 5 * sigma:
        raise AssertionError(f"flash_attention dropout keep rate {kept / pairs:.6f} off 0.9 by more than 5 sigma")
    model_kwargs = dict(FLAGSHIP_KWARGS, num_heads=4, window_size=512, dropout_p=0.1)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with no_plain():
        run = train_run(FirstSteps(source, 3), forcing=TRAIN_RUN_FORCING, flavor="transformer", mesh_refinements=5,
                        model_kwargs=model_kwargs, steps=3, batch_size=1, peak_lr=1e-5, warmup_steps=1, seed=0,
                        log_every=1, log=lambda s: None, device=dev, handle_signals=False)
    counts = launches()
    losses = run["losses"]
    if len(losses) != 3 or not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"dropout train_run: losses {losses} are not finite or do not fall")
    expected = expect(counts, {kk: 3 * vv for kk, vv in EXPECTED["transformer"][1].items()})
    if counts != expected:
        raise AssertionError(f"dropout train_run: expected {expected} launches, got {counts}")
    train = {"losses": losses, "step_ms": run["step_ms"], "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "launches": counts, "per_step": expect(counts, EXPECTED["transformer"][1])}
    return {"rows": rows, "keep_rate": kept / pairs, "keep_sigma": sigma / pairs}, train


def phase_head_widths(graph, hgraph, small_graph, dev) -> tuple[list, list, dict, dict]:
    """The two faults this PR repairs. Both edge-attention kernels at heads
    wider than 256 (D = 320, 512, 1024 on the flat processor's set; D = 1024
    on the hierarchical r3 level set) and at a head width the wrapper pads
    (D = 10), against the plain versions at the flagship's bounds, two calls
    bit-identical (:func:`phase_attn_widths`); flash_attention at D = 24, 48,
    96, 256, 512 (O96 processor shape, w = 512) against the blockwise
    version, fp32 and bf16, two calls bit-identical; and a reduced
    GraphTransformer at C = 1024 with 2 heads and a reduced Transformer at C
    = 1024 with 4 heads (D = 512, 256), fp32 against the CPU
    (:func:`phase_reduced_model`), then in bf16 three requests and three
    train steps each on the 16-latitude graph."""
    attn = phase_attn_widths(graph, dev, HEAD_WIDTH_ATTN) + phase_attn_widths(hgraph, dev, HIER_WIDE_ATTN)
    gen = torch.Generator().manual_seed(12)
    n, h, w = 10242, 4, 512
    flash = []
    for d in FLASH_WIDTHS:
        qkv32 = torch.randn(1, n, 3, h, d, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dev, dt)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            got, again = fa.flash_attention(q, k, v, w), fa.flash_attention(q, k, v, w)
            want = fa.blockwise_attention(q, k, v, window_size=w)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash_attention D={d} {dt}: two calls differ")
            err = max_err(got, want, TOL[dt], f"flash_attention D={d} {dt}")
            route = ("row kernel" if d > fa._TILE_DIMS[dt][-1] else
                     "tile kernel" + ("" if fa._tile_width(d, dt) == d else f", padded to {fa._tile_width(d, dt)}"))
            flash.append({"kernel": "flash_attention", "shape": f"B*H={h} N={n} D={d} w={w}", "route": route,
                          "dtype": str(dt).split(".")[-1], "max_abs_err": err, "bit_identical": True,
                          "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, w)),
                          "plain_ms": cuda_ms(lambda: fa.blockwise_attention(q, k, v, window_size=w), iters=3, warmup=1),
                          **bound(4 * h * n * d * qkv.element_size(), cost.flash_flops(h, fa.live_pairs(n, w, False), d),
                                  "bf16 tensor" if dt == torch.bfloat16 else "fp32")})
            del want
    reduced = {
        "graphtransformer C=1024 H=2": phase_reduced_model(small_graph, dev, "graphtransformer", channels=1024, heads=2),
        "transformer C=1024 H=4": phase_reduced_model(small_graph, dev, "transformer", channels=1024, heads=4),
    }
    serving, train = {}, {}
    for flavor, heads in (("graphtransformer", 2), ("transformer", 4)):
        cfg = configs.flagship(num_channels=1024, num_layers=8, num_chunks=2, dtype="bfloat16", flavor=flavor,
                           num_heads=heads)
        serving[flavor] = phase_serving(small_graph, dev, flavor, cfg=cfg)
        train[flavor], _ = phase_train(small_graph, dev, None, flavor, remat_none=False, lr=1e-5, cfg=cfg,
                                       must_fall=False)
    return attn + flash, reduced, serving, train


def phase_cli(dev) -> dict:
    """The port's command line in-process, at a reduced width on a
    16-latitude grid: ``train --synthetic ... --checkpoint-dir`` (C = 64, 2
    heads, 4 steps, 2 members with CRPS), then ``predict`` and ``evaluate``
    of that checkpoint against a zarr store of the same synthetic record
    that the port's writer made; every exit code 0, the forecast and the
    scores finite, the kernels launched."""
    from anemoi_models_tpu_torch.commands import main as cli
    from anemoi_models_tpu_torch.graphs.build import latlon_grid_nodes
    from anemoi_models_tpu_torch.training import SyntheticSource, save_zarr_dataset

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    ck, store, fc = (os.path.join(root, n) for n in ("ck", "record.zarr", "forecast.npz"))
    reset_launches()
    rc = {"train": cli(["train", "--synthetic", "--grid-lat", "16", "--num-vars", "5", "--num-steps", "40",
                        "--steps", "4", "--channels", "64", "--layers", "2", "--heads", "2", "--mesh-refinements",
                        "3", "--forcing", "var_0", "--ensemble", "2", "--checkpoint-dir", ck, "--device", str(dev),
                        "--seed", "1"])}
    synthetic = SyntheticSource(latlon_grid_nodes(16).coords, 5, num_steps=40, seed=1)
    save_zarr_dataset(store, np.stack([synthetic.window(t, 1)[0] for t in range(40)]), synthetic.variables,
                      synthetic.coords, synthetic.statistics)
    rc["predict"] = cli(["predict", os.path.join(ck, "latest"), store, "--steps", "3", "--output", fc,
                         "--ensemble", "2", "--device", str(dev)])
    forecast = np.load(fc)["forecast"]
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc["evaluate"] = cli(["evaluate", os.path.join(ck, "latest"), store, "--rollout", "3", "--device", str(dev),
                              "--json"])
    scores = json.loads(out.getvalue().strip().splitlines()[-1])
    counts = launches()
    shutil.rmtree(root, ignore_errors=True)
    if any(rc.values()) or not np.isfinite(forecast).all() or not np.all(np.isfinite(scores["rmse"])):
        raise AssertionError(f"cli: exit codes {rc}, or non-finite forecast or scores")
    if counts["edge_attn_csr"] == 0 or counts["edge_attn_csr_bwd"] == 0:
        raise AssertionError(f"cli: the kernels were not launched ({counts})")
    return {"exit_codes": rc, "forecast_shape": list(forecast.shape),
            "eval_rmse_mean": float(np.mean(scores["rmse"])), "launches": counts}


BENCH_ITERS = 10  # calls a timed window of the bench, as its command's default
BENCH_RUNS = tuple((flavor, mode) for flavor in (*FLAVOR_KERNEL, "hierarchical") for mode in ("forward", "train"))


def phase_bench(dev, name_power: str) -> tuple[dict, dict]:
    """The port's ``bench`` command's function (``commands/bench.py:run_bench``)
    at full width, as ``python -m anemoi_models_tpu_torch bench`` runs it:
    O96 / r5, C = 256, 8 layers, bf16, batch 1, remat "full", 3 windows of
    BENCH_ITERS calls, for each flavor and the hierarchical model (r5 / r4 /
    r3), forward and train. Each run prints bench.py's JSON line on a line
    of its own. Checks: each call's kernel calls (the FLOP count's) are
    EXPECTED's (the counts phase_serving and phase_train hold a request and
    a step to), the run's launches are those times the calls it made,
    ``mfu_frac`` lies in (0, 1.05]; a reduced model of each flavor (grid_lat
    16, r3) counts the same FLOPs a call on the card and on the CPU route,
    forward and train; and the model's output under the bench's call (no
    grad, and inside the FLOP counter) is bit for bit the output of
    ``predict_step``'s model call. Returns the launches of each run, by
    path, for serving and train."""
    serving, train = {}, {}
    for flavor, mode in BENCH_RUNS:
        t0 = time.perf_counter()
        reset_launches()
        which = {"model": "hierarchical"} if flavor == "hierarchical" else {"flavor": flavor}
        with no_plain():
            line, details = bench.run_bench(iters=BENCH_ITERS, mode=mode, device=dev, **which)
        counts = launches()
        print(f"card: {name_power} bench {flavor} {mode} ({time.perf_counter() - t0:.1f} s)", json.dumps(details))
        print(json.dumps(line))
        per_call = expect(counts, EXPECTED[flavor][mode == "train"])
        counted = expect(counts, {k: n for k, (n, _) in details["flops"]["kernels"].items()})
        if counted != per_call or counts != {k: n * details["calls"] for k, n in per_call.items()}:
            raise AssertionError(f"bench {flavor} {mode}: expected {per_call} launches a call over "
                                 f"{details['calls']} calls, counted {counted}, launched {counts}")
        if not 0.0 < line.get("mfu_frac", 0.0) <= bench.MFU_LIMIT:
            raise AssertionError(f"bench {flavor} {mode}: mfu_frac {line.get('mfu_frac')} not in (0, 1.05]")
        (train if mode == "train" else serving)[f"bench {flavor}"] = {"launches": counts}
    flops = {}
    for flavor in FLAVOR_KERNEL:
        for mode in ("forward", "train"):
            both = []
            for device in (dev, torch.device("cpu")):
                setup = bench.build(flavor=flavor, mode=mode, grid_lat=16, refinements=3, device=device)
                count = bench.flop_count(bench.make_call(setup, mode), setup.x)
                both.append({"aten": count.aten, "kernels": count.kernels})
            if both[0] != both[1]:
                raise AssertionError(f"bench {flavor} {mode}: FLOP count on the card {both[0]} != CPU route {both[1]}")
            flops[f"{flavor} {mode}"] = both[0]
    print("bench-flops card = cpu (grid_lat 16, r3)", json.dumps(flops))
    small = build_enc_proc_dec_graph(grid_lat=16, mesh_refinements=3)
    iface = interface(small, configs.flagship(256, 8, 2, "bfloat16"), dev, seed=3)
    seen = {}
    hook = iface.model.register_forward_hook(lambda _m, inp, out: seen.update(x=inp[0].clone(), y=out.clone()))
    gen = torch.Generator(device=dev).manual_seed(7)
    n_in = len(iface.data_indices.data.input.full)
    iface.predict_step(torch.randn(1, 2, small["data"].num_nodes, n_in, generator=gen, device=dev))
    hook.remove()
    x = seen["x"].clone()  # out of inference mode
    with torch.no_grad():
        plain_call = iface.model(x)
        with cost.FlopCount():
            counted_call = iface.model(x)
    if not (torch.equal(plain_call, seen["y"]) and torch.equal(counted_call, seen["y"])):
        raise AssertionError("bench: the model's output under the bench's call differs from predict_step's")
    return serving, train


O96_GRAPH = dict(grid_lat=96, mesh_refinements=5, grid="octahedral")
PARALLEL_WORLD = 2  # ranks of phase_parallel, data = 1, model = 2, sharing cuda:0
PARALLEL_LR = 1e-4  # a constant learning rate, so the one step's update is not zero
PARALLEL_STEPS = 2  # rollout lead times of the GraphTransformer's sharded rollout train step
# the sharded cells: name -> (graph, model, the Transformer processor's overrides, learning rate). Each flavor's
# flagship on the O96 graph; the Transformer on its halo window path (w = 512, "auto"), on the gathered keys'
# path with its window ("chunked") and with no window (the JAX Transformer processor takes no causal mask);
# bench.py's hierarchical model on the O96 pyramid at the C = 1024 phases' learning rate
PARALLEL_CELLS = {
    "graphtransformer": ("flat", "graphtransformer", {}, PARALLEL_LR),
    "gnn": ("flat", "gnn", {}, PARALLEL_LR),
    "transformer": ("flat", "transformer", {}, PARALLEL_LR),
    "transformer gathered": ("flat", "transformer", {"attention_impl": "chunked"}, PARALLEL_LR),
    "transformer no window": ("flat", "transformer", {"window_size": None}, PARALLEL_LR),
    "hierarchical": ("hierarchical", "hierarchical", {}, 1e-5),
}
# launches of each rank's sharded forward and train step (remat "full"): the unsharded model's, every conv and
# attention layer one launch a rank
PARALLEL_EXPECTED = {cell: EXPECTED[model] for cell, (_, model, _, _) in PARALLEL_CELLS.items()}


def _parallel_setup(graphs: dict, dev, cell: str):
    """The model of one cell (bf16, remat "full"; the flat flavors at C =
    256, 8 layers in 2 chunks) from its seed, its seeded batch and rollout
    inputs on the CPU, and an AdamW at the cell's learning rate."""
    kind, model, overrides, lr = PARALLEL_CELLS[cell]
    graph = graphs[kind]
    if model == "hierarchical":
        cfg = configs.flagship_hierarchical([n for n in graph.nodes if n != "data"])
    else:
        cfg = configs.flagship(num_channels=256, num_layers=8, num_chunks=2, dtype="bfloat16", remat_policy="full",
                           flavor=model)
        cfg.model.processor.update(overrides)
    iface = interface(graph, cfg, dev, seed=4)
    x, y = train_batch(iface, graph["data"].num_nodes, seed=20)
    rng = np.random.RandomState(22)
    di = iface.data_indices
    shape = (PARALLEL_STEPS, 1, 1, graph["data"].num_nodes)
    truth = torch.from_numpy(rng.randn(*shape, len(di.internal_model.input)).astype(np.float32))
    targets = torch.from_numpy(0.1 * rng.randn(*shape, len(di.internal_model.output)).astype(np.float32))

    def optimizer():
        return AdamW(iface.model.parameters(), lambda count: lr, clip_norm=32.0)

    return iface, (x, y, truth, targets), optimizer


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _parallel_reference(graphs: dict, dev, cell: str) -> dict:
    """The unsharded run on the card that the ranks are held to: the
    forward, one train step's loss, gradients and parameters, the rollout
    train step's loss (GraphTransformer), and the call ms."""
    iface, (x, y, truth, targets), optimizer = _parallel_setup(graphs, dev, cell)
    model = iface.model
    state = {k: v.clone() for k, v in model.state_dict().items()}
    x, y = x.to(dev), y.to(dev)
    with torch.no_grad():
        out = model(x)
        forward_ms = [_event_ms(lambda: model(x)) for _ in range(3)]
    step = make_train_step(model, optimizer())
    loss = float(step(x, y))
    ref = {"forward": out.float().cpu(), "loss": loss, "forward_ms": forward_ms,
           "grads": {k: p.grad.float().cpu() for k, p in model.named_parameters()},
           "params": {k: p.detach().float().cpu() for k, p in model.named_parameters()}}
    ref["step_ms"] = [_event_ms(lambda: step(x, y)) for _ in range(2)]
    if cell == "graphtransformer":
        model.load_state_dict(state)
        rstep = make_rollout_train_step(model, iface.data_indices, optimizer(), n_steps=PARALLEL_STEPS)
        ref["rollout_loss"] = float(rstep(x, truth.to(dev), targets.to(dev)))
    return ref


def _parallel_cell(graphs: dict, dev, mesh, cell: str, ref: dict) -> dict:
    """One rank's sharded forward, train step (twice from the same state:
    bit for bit) and, for the GraphTransformer, rollout train step, held to
    the unsharded ``ref``; launches by path; call ms."""
    graph = graphs[PARALLEL_CELLS[cell][0]]
    iface, (x, y, truth, targets), optimizer = _parallel_setup(graphs, dev, cell)
    model = iface.model
    state = {k: v.clone() for k, v in model.state_dict().items()}
    lo, hi = mesh.rows(graph["data"].num_nodes)
    x, y = x[..., lo:hi, :].to(dev), y[..., lo:hi, :].to(dev)
    truth, targets = truth[..., lo:hi, :].to(dev), targets[..., lo:hi, :].to(dev)
    out = {"rows": [lo, hi]}
    with use_mesh(mesh):
        with torch.no_grad():
            model(x)  # the first call plans the rank's parts of the edge sets
            reset_launches()
            fwd = model(x)
            out["forward_launches"] = launches()
            out["forward_ms"] = [_event_ms(lambda: model(x)) for _ in range(3)]
        if tuple(fwd.shape) != tuple(ref["forward"][..., lo:hi, :].shape) or not bool(torch.isfinite(fwd).all()):
            raise AssertionError(f"parallel {cell}: sharded forward of shape {tuple(fwd.shape)} or not finite")
        out["forward_err"] = normwise_err(fwd, ref["forward"][..., lo:hi, :].to(dev), f"parallel {cell} forward",
                                          TOL[torch.bfloat16])
        steps = []
        for _ in range(2):  # the same step from the same state: bit for bit
            model.load_state_dict(state)
            step = make_train_step(model, optimizer())
            reset_launches()
            with no_plain():
                loss = step(x, y)
            counts = launches()
            steps.append({"loss": loss, "counts": counts,
                          "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                          "params": {k: p.detach().clone() for k, p in model.named_parameters()}})
        first, again = steps
        differ = [f"{kind} {k}" for kind in ("grads", "params") for k in first[kind]
                  if not torch.equal(first[kind][k], again[kind][k])]
        if not torch.equal(first["loss"], again["loss"]) or differ:
            raise AssertionError(f"parallel {cell}: two sharded steps from one state differ: losses "
                                 f"{float(first['loss'])}, {float(again['loss'])}; {len(differ)} leaves, {differ[:4]}")
        out["step_launches"] = first["counts"]
        out["loss"] = float(first["loss"])
        out["loss_err"] = normwise_err(first["loss"], torch.tensor(ref["loss"], device=dev),
                                       f"parallel {cell} loss", TOL[torch.bfloat16])
        out["grad_err"] = max(normwise_err(g, ref["grads"][k].to(dev), f"parallel {cell} grad {k}",
                                           TOL[torch.bfloat16]) for k, g in first["grads"].items())
        out["param_err"] = max(normwise_err(p, ref["params"][k].to(dev), f"parallel {cell} param {k}",
                                            TOL[torch.bfloat16]) for k, p in first["params"].items())
        out["step_ms"] = [_event_ms(lambda: step(x, y)) for _ in range(2)]
        if cell == "graphtransformer":
            model.load_state_dict(state)
            rstep = make_rollout_train_step(model, iface.data_indices, optimizer(), n_steps=PARALLEL_STEPS)
            reset_launches()
            rloss = rstep(x, truth, targets)
            out["rollout_launches"] = launches()
            out["rollout_loss"] = float(rloss)
            out["rollout_loss_err"] = normwise_err(rloss, torch.tensor(ref["rollout_loss"], device=dev),
                                                   "parallel rollout loss", TOL[torch.bfloat16])
    fwd_want, step_want = PARALLEL_EXPECTED[cell]
    for what, counts, want in (("forward", out["forward_launches"], fwd_want),
                               ("train step", out["step_launches"], step_want)):
        if counts != expect(counts, want):
            raise AssertionError(f"parallel {cell} {what}: expected {expect(counts, want)} launches, got {counts}")
    return out


def parallel_rank(rank: int, world: int, port: int, graph_kwargs: dict, hgraph, dev: torch.device, ref_path: str,
                  out_dir: str) -> None:
    """A rank of phase_parallel: a gloo process group on localhost, a
    (1, world) mesh on ``dev`` (the parent's card), the flat graph of
    ``graph_kwargs`` and the parent's hierarchical graph ``hgraph``, each
    cell's sharded run against the unsharded references in ``ref_path``;
    its numbers saved to ``out_dir``."""
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        load_kernels()  # built by the parent: loaded, not compiled
        mesh = make_mesh(1, world, backend="gloo", device=dev)
        graphs = {"flat": build_enc_proc_dec_graph(**graph_kwargs), "hierarchical": hgraph}
        refs = torch.load(ref_path, weights_only=False)
        out = {cell: _parallel_cell(graphs, dev, mesh, cell, refs[cell]) for cell in refs}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_parallel(graph_kwargs: dict, hgraph, dev) -> dict:
    """Each cell of PARALLEL_CELLS sharded over PARALLEL_WORLD gloo ranks
    that share cuda:0 (nccl refuses two ranks on one device), data = 1 and
    model = 2, against the unsharded run on the same card: the forward, one
    train step's loss, gradients and parameters (bf16 normwise 2e-2), the
    step again bit for bit, and the GraphTransformer's 2-step rollout train
    step's loss. Every rank's launches are checked; a failing rank fails the
    phase (``mp.spawn`` raises). The ms are two ranks sharing one card, not
    a speed across cards."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parallel")
    os.makedirs(out_dir, exist_ok=True)
    # each rank builds its own flat graph (1 s at O96) and is handed the hierarchical one
    graphs = {"flat": build_enc_proc_dec_graph(**graph_kwargs), "hierarchical": hgraph}
    refs = {cell: _parallel_reference(graphs, dev, cell) for cell in PARALLEL_CELLS}
    ref_path = os.path.join(out_dir, "unsharded.pt")
    torch.save(refs, ref_path)
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(parallel_rank, args=(PARALLEL_WORLD, port, graph_kwargs, hgraph, dev, ref_path, out_dir),
             nprocs=PARALLEL_WORLD, join=True)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(PARALLEL_WORLD)]
    out = {"ranks_s": time.perf_counter() - t0}
    for cell, ref in refs.items():
        graph = graphs[PARALLEL_CELLS[cell][0]]
        per_rank = [r[cell] for r in ranks]
        rows = [r["rows"] for r in per_rank]
        if rows[0][0] != 0 or rows[-1][1] != graph["data"].num_nodes or any(
                a[1] != b[0] for a, b in zip(rows, rows[1:])):
            raise AssertionError(f"parallel {cell}: the ranks' grid rows {rows} do not tile the grid")
        if len({r["loss"] for r in per_rank}) != 1:
            raise AssertionError(f"parallel {cell}: the ranks report different losses")
        out[cell] = {
            "unsharded_forward_ms": ref["forward_ms"], "unsharded_step_ms": ref["step_ms"],
            "sharded_forward_ms": [r["forward_ms"] for r in per_rank],
            "sharded_step_ms": [r["step_ms"] for r in per_rank],
            "launches": {k: sum(r["step_launches"][k] for r in per_rank) for k in per_rank[0]["step_launches"]},
            **{k: max(r[k] for r in per_rank) for k in ("forward_err", "loss_err", "grad_err", "param_err")},
            "per_rank_forward_launches": per_rank[0]["forward_launches"],
            "per_rank_step_launches": per_rank[0]["step_launches"],
        }
        if cell == "graphtransformer":
            out[cell]["rollout_loss_err"] = max(r["rollout_loss_err"] for r in per_rank)
            out[cell]["rollout_launches"] = per_rank[0]["rollout_launches"]
    return out


FSDP_WORLD = 2  # ranks of phase_fsdp, data = 2, model = 1, sharing cuda:0
FSDP_STEPS = 4
FSDP_MODES = ("zero1", "fsdp")


def _fsdp_args(dev) -> dict:
    """train_run's arguments of phase_fsdp: the flagship, batch 2 (one row
    a rank), 4 steps, lr 1e-4 after a one-step warm-up, no EMA and no eval."""
    return dict(forcing=TRAIN_RUN_FORCING, mesh_refinements=5, model_kwargs=FLAGSHIP_KWARGS, steps=FSDP_STEPS,
                batch_size=2, peak_lr=1e-4, warmup_steps=1, seed=0, log_every=1, log=lambda s: None, device=dev,
                handle_signals=False)


def _fsdp_whole(run: dict) -> dict:
    """A run's parameters whole, on the CPU (gathered under a shard plan)."""
    plan = run["plan"]
    ctx = plan.gathered(run["optimizer"]) if plan is not None else contextlib.nullcontext()
    with ctx:
        return {n: p.detach().float().cpu() for n, p in run["model"].named_parameters()}


def _fsdp_bytes(run: dict) -> dict:
    """This rank's bytes of parameters and AdamW moments, and its peak memory."""
    opt = run["optimizer"]
    params = [p for group in opt.param_groups for p in group["params"]]
    moments = [t for p in params for k, t in opt.state[p].items() if k in ("mu", "nu")]
    return {"param_bytes": sum(p.numel() * p.element_size() for p in params),
            "moment_bytes": sum(t.numel() * t.element_size() for t in moments),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def fsdp_rank(rank: int, world: int, port: int, dev: torch.device, path: str, out_dir: str) -> None:
    """A rank of phase_fsdp: a gloo process group on localhost, a (world, 1)
    mesh on the parent's card, the flagship's train_run under each of
    zero1 and fsdp: its launches, bytes and peak memory, its losses and
    whole parameters, and the run again saved at step 2 and resumed, bit for
    bit against the uninterrupted one."""
    from anemoi_models_tpu_torch.training import open_dataset, train_run

    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        load_kernels()  # built by the parent: loaded, not compiled
        mesh = make_mesh(world, 1, backend="gloo", device=dev)
        source = open_dataset(path)
        args = _fsdp_args(dev)
        out = {}
        for mode in FSDP_MODES:
            root = os.path.join(out_dir, mode)
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            full = train_run(source, mesh=mesh, param_sharding=mode, checkpoint_dir=os.path.join(root, "a"), **args)
            torch.cuda.synchronize()
            res = {"launches": launches(), "run_s": time.perf_counter() - t0, **_fsdp_bytes(full),
                   "losses": full["losses"], "step_ms": full["step_ms"], "whole": _fsdp_whole(full)}
            train_run(source, mesh=mesh, param_sharding=mode, checkpoint_dir=os.path.join(root, "b"),
                      max_steps_this_run=2, save_every=2, **args)
            rest = train_run(source, mesh=mesh, param_sharding=mode, checkpoint_dir=os.path.join(root, "b"),
                             resume=True, **args)
            want, got = _state(full), _state(rest)
            differ = [k for k in want if not torch.equal(want[k], got[k])]
            res["resume_bit_identical"] = not differ and rest["losses"] == full["losses"][2:]
            res["resume_differ"] = differ[:4]
            out[mode] = res
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_fsdp(source, dev) -> dict:
    """ZeRO-1 and FSDP: the flagship's train_run (O96, C = 256, 8 layers, bf16,
    remat "full"), 4 steps at batch 2, in FSDP_WORLD gloo ranks sharing cuda:0
    (data = 2, model = 1: a row of the batch a rank), under zero1 and fsdp,
    against the unsharded train_run on the same card: the losses and the
    final parameters within bf16 normwise 2e-2, each rank's launches of the
    edge-attention kernels equal to the unsharded run's per step, a save at
    step 2 and a resume bit for bit against the uninterrupted sharded run,
    and each rank's parameter and moment bytes and peak memory beside the
    unsharded run's."""
    from anemoi_models_tpu_torch.training import train_run

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "fsdp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = source.path
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ref = train_run(source, **_fsdp_args(dev))
    torch.cuda.synchronize()
    ref_counts = launches()
    per_step = {k: FSDP_STEPS * v for k, v in EXPECTED["graphtransformer"][1].items()}
    if ref_counts != expect(ref_counts, per_step):
        raise AssertionError(f"fsdp reference: expected {expect(ref_counts, per_step)} launches, got {ref_counts}")
    ref_bytes, ref_whole, ref_losses = _fsdp_bytes(ref), _fsdp_whole(ref), ref["losses"]
    del ref
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(fsdp_rank, args=(FSDP_WORLD, port, dev, path, out_dir), nprocs=FSDP_WORLD, join=True)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(FSDP_WORLD)]
    out = {"ranks_s": time.perf_counter() - t0, "unsharded": {**ref_bytes, "losses": ref_losses,
                                                              "launches": ref_counts}}
    for mode in FSDP_MODES:
        per_rank = [r[mode] for r in ranks]
        for r, res in enumerate(per_rank):
            if res["launches"] != expect(res["launches"], per_step):
                raise AssertionError(f"fsdp {mode} rank {r}: expected {expect(res['launches'], per_step)} "
                                     f"launches, got {res['launches']}")
            if not res["resume_bit_identical"]:
                raise AssertionError(f"fsdp {mode} rank {r}: the resumed run differs ({res['resume_differ']})")
        if any(res["losses"] != per_rank[0]["losses"] for res in per_rank):
            raise AssertionError(f"fsdp {mode}: the ranks report different losses")
        loss_err = normwise_err(torch.tensor(per_rank[0]["losses"]), torch.tensor(ref_losses), f"fsdp {mode} losses",
                                TOL[torch.bfloat16])
        param_err = max(normwise_err(per_rank[0]["whole"][k], v, f"fsdp {mode} param {k}", TOL[torch.bfloat16])
                        for k, v in ref_whole.items())
        out[mode] = {"losses": per_rank[0]["losses"], "loss_err": loss_err, "param_err": param_err,
                     "launches": per_rank[0]["launches"], "resume_bit_identical": True,
                     **{k: [res[k] for res in per_rank] for k in ("param_bytes", "moment_bytes", "peak_mem_gib",
                                                                  "run_s", "step_ms")}}
    shutil.rmtree(out_dir, ignore_errors=True)
    return out


def phase_profile(run, out_dir: str, label: str) -> dict:
    """One call of ``run`` under torch.profiler: device time by kernel, and
    the device's busy share (union of kernel intervals over the span)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as fh:
        fh.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, f"profile_{label}.json"))
    kernels = [e for e in prof.events()  # device kernels and copies, not the annotations that span them
               if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    by_name: dict[str, list] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for s, t in spans:
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    first, last = (spans[0][0], max(t for _, t in spans)) if spans else (0, 0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    by_kind: dict[str, list] = {}
    for name, (count, ms) in by_name.items():
        kind = next((k for k, marks in PROFILE_KINDS if any(m in name for m in marks)), "other elementwise")
        entry = by_kind.setdefault(kind, [0, 0.0])
        entry[0] += count
        entry[1] += ms
    return {"wall_ms_under_profiler": wall_ms, "device_kernels": len(kernels),
            "device_busy_ms": busy / 1e3, "device_span_ms": (last - first) / 1e3,
            "by_kind": [{"kind": k, "count": c, "ms": ms}
                        for k, (c, ms) in sorted(by_kind.items(), key=lambda kv: -kv[1][1])],
            "top_kernels": [{"name": n[:90], "count": c, "ms": ms} for n, (c, ms) in top]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT_DIR",
                        help="also profile one train step and one request per flavor into OUT_DIR")
    parser.add_argument("--build-times", metavar="OUT_DIR",
                        help="also time cold kernel builds, parallel against one nvcc call, in OUT_DIR")
    args = parser.parse_args()
    name_power = card()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no card to test")
    dev = torch.device("cuda", 0)
    print(f"card: {name_power}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    load_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for row in ptxas_summary(build_log()):  # registers and spills of every kernel (nvcc -Xptxas -v)
        print("ptxas", json.dumps(row))
    if args.build_times:
        print("build-times", json.dumps(build_times(args.build_times)))

    t0 = time.perf_counter()
    graph = build_enc_proc_dec_graph(**O96_GRAPH)
    print(f"graph O96 r5: {graph['data'].num_nodes} grid, {graph['hidden'].num_nodes} hidden, "
          f"built in {time.perf_counter() - t0:.1f} s")

    summary, rows = phase_kernels(graph, dev)
    bwd_summary, bwd_rows = phase_backward_kernels(graph, dev)
    summary.update(bwd_summary)
    summary["gnn_conv"], gnn_rows = phase_gnn_kernels(graph, dev)
    summary["gnn_conv_layered"], width_rows = phase_gnn_widths(graph, dev)
    summary["flash_attention"], flash_rows = phase_flash_kernels(dev)
    for row in rows + bwd_rows + gnn_rows + width_rows + flash_rows:
        print("kernel-vs-plain", json.dumps(row))
    for row in width_rows:  # the layered route at C = 1024, bf16: device ms per call by launch
        if "split" in row:
            print(f"card: {name_power} gnn-layered-split", json.dumps({k: row[k] for k in ("shape", "ms", "split")}))
    for row in phase_attn_widths(graph, dev, WIDE_ATTN):
        print("attn-width-vs-plain", json.dumps(row))
    for row in phase_attn_widths(graph, dev, A2_ATTN):
        print(f"card: {name_power} attn-a2-vs-plain", json.dumps(row))
    reduced_graph = build_enc_proc_dec_graph(grid_lat=48, mesh_refinements=4, grid="octahedral")
    for flavor in FLAVOR_KERNEL:
        print(f"reduced-model {flavor}", json.dumps(phase_reduced_model(reduced_graph, dev, flavor)))
    # the production widths through the whole model, on a smaller graph: the GraphTransformer with four
    # head groups a row, and the GNN on the layered route (C = 512, one extra hidden Dense in every MLP)
    small_graph = build_enc_proc_dec_graph(grid_lat=16, mesh_refinements=3)
    print("reduced-model graphtransformer C=1024 H=16",
          json.dumps(phase_reduced_model(small_graph, dev, "graphtransformer", channels=1024, heads=16)))
    print("reduced-model gnn C=512 mlp_extra_layers=1",
          json.dumps(phase_reduced_model(small_graph, dev, "gnn", channels=512, kernel="gnn_conv_layered",
                                         mlp_extra_layers=1)))
    serving, train = {}, {}
    for flavor in FLAVOR_KERNEL:  # each path: counts reset just before it, read just after
        serving[flavor] = phase_serving(graph, dev, flavor, args.profile)
        print(f"serving {flavor}", json.dumps(serving[flavor]))
        train[flavor], trained = phase_train(graph, dev, args.profile, flavor,
                                             remat_none=flavor == "graphtransformer")
        print(f"train {flavor}", json.dumps(train[flavor]))
        if flavor == "graphtransformer":  # the trained flagship, saved and served again
            print(f"card: {name_power} checkpoint", json.dumps(phase_checkpoint(trained, graph, dev)))
        del trained
    # the flagship's forecast (ROLLOUT_STEPS lead times) and its rollout fine-tuning step
    serving["rollout"] = phase_rollout(graph, dev, args.profile)
    print(f"card: {name_power} rollout", json.dumps(serving["rollout"]))
    train["rollout"] = phase_rollout_train(graph, dev, args.profile)
    print(f"card: {name_power} rollout-train", json.dumps(train["rollout"]))
    # the GraphTransformer at the production width (C = 1024, 16 heads): serving, then training
    serving["production"] = phase_serving(graph, dev, "graphtransformer", args.profile, channels=1024, heads=16)
    print("serving production C=1024 H=16", json.dumps(serving["production"]))
    # Adam's first steps move every weight by about the learning rate, and a unit of the wide layers
    # sums 1024 to 4096 of them: this seeded model's loss rises 36-fold after the first step at the
    # flagship's 1e-3 and 9-fold at 1e-4, so the production width trains at 1e-5
    train["production"], _ = phase_train(graph, dev, args.profile, "graphtransformer", remat_none=False,
                                         channels=1024, heads=16, lr=1e-5)
    print("train production C=1024 H=16", json.dumps(train["production"]))
    # the GNN at the production width (C = 1024: the layered route), three requests and two train steps
    # at the production width's learning rate; finite losses are the check
    serving["gnn production"] = phase_serving(graph, dev, "gnn", args.profile, channels=1024,
                                              expected=EXPECTED["gnn production"][0])
    print(f"card: {name_power} serving gnn production C=1024", json.dumps(serving["gnn production"]))
    train["gnn production"], _ = phase_train(graph, dev, args.profile, "gnn", remat_none=False, channels=1024,
                                             lr=1e-5, expected=EXPECTED["gnn production"][1], steps=3,
                                             must_fall=False)
    print(f"card: {name_power} train gnn production C=1024", json.dumps(train["gnn production"]))
    # two train steps of two models built from one seed, per flavor: bit for bit alike (every backward kernel
    # sums in a fixed order), or the first leaf that differs
    for flavor in FLAVOR_KERNEL:
        det = phase_determinism(graph, dev, flavor)
        print(f"card: {name_power} determinism {flavor}", json.dumps(det))
        if not det["bit_identical"]:
            raise AssertionError(f"two {flavor} train steps differ: {det}")
    # the hierarchical model: its O96 pyramid (r5 / r4 / r3), both edge-attention kernels at its head widths
    # (D = 128, 256) and at head widths the lanes pad (D = 96, 48), a reduced fp32 model against the CPU
    # (1 head at C = 64, so that D reaches 256 on the coarsest level, and 4 heads), then bench.py's model
    t0 = time.perf_counter()
    hgraph, hnames = build_hierarchical_graph(grid_lat=96, grid="octahedral", mesh_refinements=5, num_levels=3)
    print(f"graph O96 hierarchical: {json.dumps({n: hgraph[n].num_nodes for n in hgraph.nodes})}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    for row in phase_attn_widths(hgraph, dev, HIER_ATTN) + phase_attn_widths(graph, dev, FLAT_ATTN):
        print("attn-width-vs-plain", json.dumps(row))
    small_hgraph, small_hnames = build_hierarchical_graph(grid_lat=16, mesh_refinements=3, num_levels=3)
    for heads in (1, 4):
        print(f"reduced-model hierarchical C=64 H={heads}",
              json.dumps(phase_reduced_model(small_hgraph, dev, cfg=configs.flagship_hierarchical(small_hnames, 64, heads, "float32"))))
    profile_dir = args.profile or os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_profile")
    serving["hierarchical"], train["hierarchical"] = phase_hierarchical(hgraph, hnames, dev, profile_dir)
    print(f"card: {name_power} serving hierarchical", json.dumps(serving["hierarchical"]))
    print(f"card: {name_power} train hierarchical", json.dumps(train["hierarchical"]))
    # the AIFS data path: imputer, remapper and boundings around the flagship
    serving["aifs-data"], train["aifs-data"] = phase_aifs_data(graph, dev, small_graph, profile_dir)
    print(f"card: {name_power} serving aifs-data", json.dumps(serving["aifs-data"]))
    print(f"card: {name_power} train aifs-data", json.dumps(train["aifs-data"]))
    # the training driver on the flagship: CRPS over 2 members through the curriculum, evals, checkpoints
    # and a resume bit for bit, from a zarr store of a synthetic O96 record
    t0 = time.perf_counter()
    source = o96_record(graph)
    print(f"O96 record: {TRAIN_RUN_STEPS} steps x {TRAIN_RUN_VARS} variables, zarr written and read back in "
          f"{time.perf_counter() - t0:.1f} s")
    train["train_run"] = phase_train_run(source, dev)
    print(f"card: {name_power} train_run", json.dumps(train["train_run"]))
    # the memory policies: remat "full", "save_dots", "none", cpu_offload and "auto" at the production width
    t0 = time.perf_counter()
    memory = phase_memory(graph, source, dev)
    print(f"card: {name_power} memory ({time.perf_counter() - t0:.1f} s)", json.dumps(memory))
    # ZeRO-1 and FSDP: the flagship's train_run in two gloo ranks on this card against the unsharded run
    fsdp = phase_fsdp(source, dev)
    for mode in FSDP_MODES:
        train[f"train_run {mode}"] = {"launches": fsdp[mode]["launches"]}
    print(f"card: {name_power} fsdp (2 gloo ranks sharing one card, a rank's numbers each)", json.dumps(fsdp))
    # attention dropout: the kernel against plain under one key, its keep rate, the Transformer trained with it
    dropout, train["dropout"] = phase_dropout(source, dev)
    for row in dropout.pop("rows"):
        print("kernel-vs-plain", json.dumps(row))
    print(f"card: {name_power} dropout", json.dumps({**dropout, "train": train["dropout"]}))
    # the head widths the kernels took no more in the parent: edge attention above 256 and padded, flash at
    # every width, and reduced models at C = 1024 with 2 and 4 heads
    width_rows, reduced, wide_serving, wide_train = phase_head_widths(graph, hgraph, small_graph, dev)
    for row in width_rows:
        print("head-width-vs-plain", json.dumps(row))
    for label, row in reduced.items():
        print(f"reduced-model {label}", json.dumps(row))
    for flavor in wide_serving:
        serving[f"head widths {flavor}"], train[f"head widths {flavor}"] = wide_serving[flavor], wide_train[flavor]
        print(f"card: {name_power} head widths {flavor}",
              json.dumps({"serving": wide_serving[flavor], "train": wide_train[flavor]}))
    # the command line in-process: train, predict, evaluate
    train["cli"] = phase_cli(dev)
    print(f"card: {name_power} cli", json.dumps(train["cli"]))
    # the bench command's function at full width: each flavor and the hierarchical model, forward and train
    t0 = time.perf_counter()
    bench_serving, bench_train = phase_bench(dev, name_power)
    serving.update(bench_serving)
    train.update(bench_train)
    print(f"phase_bench {time.perf_counter() - t0:.1f} s")
    # model parallelism: each flavor's flagship sharded over two gloo ranks on this card against unsharded
    parallel = phase_parallel(O96_GRAPH, hgraph, dev)
    for cell in PARALLEL_CELLS:
        train[f"parallel {cell}"] = {"launches": parallel[cell]["launches"]}
    print(f"card: {name_power} parallel (2 gloo ranks sharing one card, not a speed across cards)",
          json.dumps(parallel))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "anemoi_models_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the train path a kernel is counted on
    home = {**{kernel: flavor for flavor, kernel in FLAVOR_KERNEL.items()}, "gnn_conv_layered": "gnn production",
            "gnn_conv_bwd": "gnn", "flash_attention_bwd": "transformer"}
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": train[home.get(name, "graphtransformer")]["launches"][name],
         "launches_by_path": {f"{path} {flavor}": runs[flavor]["launches"][name]
                              for path, runs in (("serving", serving), ("train", train)) for flavor in runs},
         **{k: summary[name][k] for k in keys}}
        for name, (source, replaces) in KERNELS.items()
    ]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on its train path")
    print("host-us", json.dumps({k["name"]: summary[k["name"]]["host_us"] for k in kernels}))
    print(name_power)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
