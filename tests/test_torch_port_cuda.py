"""PyTorch port on the card: the CUDA kernels against their plain versions,
the wrappers' checks and launch counts, and a small model forward on the card
against the CPU. Marked ``cuda``; skipped where there is no CUDA card.

On a machine with a card and without jax (the repository's conftest imports
jax), run it as::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

Tolerances: fp32 ``atol = rtol = 1e-5`` (only the summation order differs
from the plain version); bf16 inputs ``2e-2``.
"""

import numpy as np
import pytest
import torch

from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu_torch.ops import edge_attention as ea

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=16, mesh_refinements=3)


def _csr(es, num_src, num_dst, dev, keep=None):
    ei = es.edge_index if keep is None else es.edge_index[:, keep]
    rowptr, src = ea.csr_from_edge_index(ei, num_src, num_dst)
    return torch.from_numpy(rowptr).to(dev), torch.from_numpy(src).to(dev), ei.shape[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1000, 64, 128), (257, 40, 96)])
def test_kv_proj_matches_plain(dev, dtype, shape):
    m, k, n = shape
    gen = torch.Generator().manual_seed(0)
    f = torch.randn(m, k, generator=gen).to(dev, dtype)
    w = (torch.randn(n, k, generator=gen) * k ** -0.5).to(dev, dtype)
    b = torch.randn(n, generator=gen).to(dev)
    before = ea.LAUNCHES["kv_proj"]
    got = ea.kv_proj(f, w, b)
    assert ea.LAUNCHES["kv_proj"] == before + 1
    want = ea.kv_proj_plain(f, w, b)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,heads", [(64, 4), (256, 4), (512, 4), (128, 16)])
@pytest.mark.parametrize("edges", ["hidden-hidden", "data-hidden", "hidden-data", "dead"])
def test_edge_attn_csr_matches_plain(dev, graph, dtype, channels, heads, edges):
    names = {"hidden-hidden": ("hidden", "hidden"), "data-hidden": ("data", "hidden"),
             "hidden-data": ("hidden", "data"), "dead": ("hidden", "hidden")}[edges]
    es = graph[(names[0], "to", names[1])]
    ns, nd = graph[names[0]].num_nodes, graph[names[1]].num_nodes
    keep = es.edge_index[1] % 4 != 1 if edges == "dead" else None
    rowptr, src, num_edges = _csr(es, ns, nd, dev, keep)
    gen = torch.Generator().manual_seed(1)
    batch = 2
    q = torch.randn(batch * nd, channels, generator=gen).to(dev, dtype)
    kv = torch.randn(batch * ns, 2 * channels, generator=gen).to(dev, dtype)
    a = torch.randn(num_edges, 8, generator=gen).to(dev, dtype)
    w_aug = (torch.randn(8, channels, generator=gen) * 0.3).to(dev, dtype)
    got = ea.edge_attn_csr(q, kv, rowptr, src, a, w_aug, heads)
    want = ea.edge_attn_csr_plain(q, kv, rowptr, src, a, w_aug, heads)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])
    if edges == "dead":
        dead = torch.from_numpy(np.tile(np.arange(nd) % 4 == 1, batch)).to(dev)
        assert bool((got.m[dead] == -1e30).all()) and bool((got.den[dead] == 0).all())
        assert bool((got.num[dead] == 0).all())


def test_wrappers_reject_what_the_kernels_do_not_take(dev, graph):
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    rowptr, src, num_edges = _csr(es, n, n, dev)
    q = torch.randn(n, 192, device=dev)  # 4 heads of 48: not a power of two
    kv = torch.randn(n, 384, device=dev)
    a = torch.randn(num_edges, 8, device=dev)
    with pytest.raises(ValueError, match="head widths"):
        ea.edge_attn_csr(q, kv, rowptr, src, a, torch.randn(8, 192, device=dev), 4)
    q, kv = torch.randn(n, 64, device=dev), torch.randn(n, 128, device=dev)
    with pytest.raises(ValueError, match="share one dtype"):
        ea.edge_attn_csr(q, kv.bfloat16(), rowptr, src, a, torch.randn(8, 64, device=dev), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ea.edge_attn_csr(q, kv, rowptr, src, a, torch.randn(64, 8, device=dev).t(), 4)
    with pytest.raises(ValueError, match="several devices"):
        ea.kv_proj(torch.randn(4, 8, device=dev), torch.randn(6, 8), torch.randn(6))
    with pytest.raises(ValueError, match="fp32"):
        ea.kv_proj(torch.randn(4, 8, device=dev), torch.randn(6, 8, device=dev), torch.randn(6, device=dev).bfloat16())


def test_model_forward_on_card_matches_cpu(dev, graph):
    from anemoi_models_tpu_torch.data_indices import IndexCollection
    from anemoi_models_tpu_torch.interface import AnemoiModelInterface
    from anemoi_models_tpu_torch.utils import DotDict

    mapper = {"trainable_size": 4, "num_heads": 4, "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
    cfg = DotDict({
        "data": {"forcing": ["lsm"], "diagnostic": ["tp"], "processors": {}},
        "graph": {"data": "data", "hidden": "hidden"},
        "training": {"multistep_input": 2},
        "model": {
            "num_channels": 64, "trainable_parameters": {"hidden": 8},
            "model": {"_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"},
            "encoder": {"_target_": "anemoi.models.layers.mapper.GraphTransformerForwardMapper", **mapper},
            "processor": {"_target_": "anemoi.models.layers.processor.GraphTransformerProcessor",
                          "num_layers": 2, "num_chunks": 2, **mapper},
            "decoder": {"_target_": "anemoi.models.layers.mapper.GraphTransformerBackwardMapper", **mapper},
        },
    })
    n2i = {"lsm": 0, "z_500": 1, "t_850": 2, "t2m": 3, "tp": 4}
    di = IndexCollection(cfg, n2i)
    ifaces = []
    for _ in range(2):
        iface = AnemoiModelInterface(config=cfg, graph_data=graph, statistics={}, data_indices=di)
        gen = torch.Generator().manual_seed(5)
        iface.init_params(gen)
        with torch.no_grad():
            for p in iface.model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
        ifaces.append(iface)
    x = torch.randn(1, 2, 1, graph["data"].num_nodes, 4, generator=torch.Generator().manual_seed(6))
    ref = ifaces[0].forward(x)
    before = dict(ea.LAUNCHES)
    out = ifaces[1].to(dev).forward(x.to(dev)).cpu()
    assert {k: ea.LAUNCHES[k] - before[k] for k in before} == {"kv_proj": 4, "edge_attn_csr": 4}
    bound = 1e-4 * max(1.0, ref.abs().mean().item())
    assert (out - ref).abs().max().item() <= bound
