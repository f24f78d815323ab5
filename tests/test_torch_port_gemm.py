"""PyTorch port on the CPU: the plain versions behind the Hopper GEMM
(``csrc/gemm_sm90.cuh``) and the factored GNN conv.

- ``kv_proj``'s plain version with an fp32 output (the GNN pre-pass's output
  type), against numpy in float64.
- The factored ``gnn_conv_plain`` (the first Dense as per-node products
  gathered per edge, the TPU kernel's three dots) against the unfactored
  ``cat[x_i, x_j, e]`` form, in fp32 within 1e-5, on a self-graph and on a
  bipartite edge set of the port's tiny test graph.
"""

import numpy as np
import pytest
import torch

from helpers_torch import one_torch_thread  # noqa: F401 (autouse)
from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu_torch.layers.utils import get_activation
from anemoi_models_tpu_torch.ops import edge_attention as ea
from anemoi_models_tpu_torch.ops import gnn_conv as gc

C = 16


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_kv_proj_plain_fp32_output_matches_numpy(in_dtype):
    rng = np.random.RandomState(5)
    f, w = rng.randn(37, 24).astype(np.float32), (rng.randn(40, 24) * 0.2).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    ft, wt = torch.from_numpy(f).to(in_dtype), torch.from_numpy(w).to(in_dtype)
    out = ea.kv_proj(ft, wt, torch.from_numpy(b), torch.float32)
    assert out.dtype == torch.float32 and out.shape == (37, 40)
    want = ft.double().numpy() @ wt.double().numpy().T + b.astype(np.float64)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def _cat_form(x_dst, x_src, e, rowptr, src, ops, activation):
    """The unfactored edge MLP: one product over cat[x_i, x_j, e] (E, 3C)."""
    act = get_activation(activation)
    nd = rowptr.numel() - 1
    dst = torch.repeat_interleave(torch.arange(nd), rowptr.long().diff())
    h = torch.cat([x_dst[:, dst], x_src[:, src.long()], e], dim=-1)
    *dense, gamma, beta = ops
    for i in range(0, len(dense), 2):
        h = h @ dense[i].t() + dense[i + 1]
        if i + 2 < len(dense):
            h = act(h)
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    msg = (h - mu) * torch.rsqrt(var + 1e-6) * gamma + beta + e
    return gc.aggregate(msg, rowptr), msg


@pytest.mark.parametrize("edges,extra", [(("hidden", "hidden"), 0), (("data", "hidden"), 0),
                                         (("hidden", "data"), 0), (("hidden", "hidden"), 1)])
def test_factored_gnn_conv_plain_matches_cat_form(graph, edges, extra):
    es = graph[(edges[0], "to", edges[1])]
    ns, nd = graph[edges[0]].num_nodes, graph[edges[1]].num_nodes
    rowptr, src = (torch.from_numpy(t) for t in ea.csr_from_edge_index(es.edge_index, ns, nd))
    gen = torch.Generator().manual_seed(6)
    x_dst = torch.randn(2, nd, C, generator=gen)
    x_src = x_dst if edges[0] == edges[1] else torch.randn(2, ns, C, generator=gen)
    e = torch.randn(2, es.num_edges, C, generator=gen)
    dense = [(torch.randn(C, k, generator=gen) * k ** -0.5, torch.randn(C, generator=gen) * 0.1)
             for k in (3 * C,) + (C,) * (2 + extra)]
    norm = (1 + 0.1 * torch.randn(C, generator=gen), 0.1 * torch.randn(C, generator=gen))
    ops = gc.mlp_operands(dense, norm, torch.float32)
    got = gc.gnn_conv_plain(x_dst, x_src, e, rowptr, src, ops, "SiLU")
    want = _cat_form(x_dst, x_src, e, rowptr, src, ops, "SiLU")
    for name, g, w in zip(("agg", "msg"), got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=name)
