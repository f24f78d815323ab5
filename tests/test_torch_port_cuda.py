"""PyTorch port on the card: the CUDA kernels against their plain versions,
the wrappers' checks and launch counts, and small models of the three
flavors on the card against the CPU. Marked ``cuda``; skipped where there is
no CUDA card.

On a machine with a card and without jax (the repository's conftest imports
jax), run it as::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

Tolerances: fp32 ``atol = rtol = 1e-5`` (only the summation order differs
from the plain version); bf16 inputs ``2e-2``. The backward is held to
``max |kernel - plain| <= 1e-4 * max(1, max |plain|)`` per output: both read
the same inputs and sum in fp32, in another order (the dw_aug sum runs over
every edge).
"""

import numpy as np
import pytest
import torch

from helpers_torch import one_torch_thread  # noqa: F401 (autouse)
from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu_torch.ops import edge_attention as ea
from anemoi_models_tpu_torch.ops import flash_attention as fa
from anemoi_models_tpu_torch.ops import gnn_conv as gc

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = 1e-4


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


def _csr_t(rowptr, src, num_src):
    return ea.CSRTranspose(*(
        torch.from_numpy(t).to(rowptr.device) for t in ea.csr_transpose(rowptr.cpu(), src.cpu(), num_src)
    ))


def _normwise(got, want):
    return (got.float() - want.float()).abs().max().item() / max(1.0, want.abs().max().item())


KV_SHAPES = [(1000, 64, 128), (257, 40, 96)] + [(m, k, 512) for m in (1, 63, 10242, 40320) for k in (40, 256)]


@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("shape", KV_SHAPES)
def test_kv_proj_matches_plain(dev, dtype, out_dtype, shape):
    """The Hopper GEMM (wgmma + TMA in bf16, the CUDA cores in fp32) against
    its plain version, ragged M, N and K included; two calls bit-identical."""
    m, k, n = shape
    gen = torch.Generator().manual_seed(0)
    f = torch.randn(m, k, generator=gen).to(dev, dtype)
    w = (torch.randn(n, k, generator=gen) * k ** -0.5).to(dev, dtype)
    b = torch.randn(n, generator=gen).to(dev)
    before = ea.LAUNCHES["kv_proj"]
    got = ea.kv_proj(f, w, b, out_dtype)
    again = ea.kv_proj(f, w, b, out_dtype)
    assert ea.LAUNCHES["kv_proj"] == before + 2
    want = ea.kv_proj_plain(f, w, b, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, again), "two calls differ"
    tol = TOL[out_dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_kv_proj_rejects_misaligned_rows(dev):
    """A bf16 row that is not whole 16-byte vectors (K = 36: 72-byte rows)
    is padded with zero columns by the wrapper and runs; an operand that
    starts off a 16-byte boundary is refused."""
    f = torch.randn(64, 36, device=dev).bfloat16()  # 72-byte rows
    w = torch.randn(128, 36, device=dev).bfloat16()
    before = ea.LAUNCHES["kv_proj"]
    got = ea.kv_proj(f, w, torch.zeros(128, device=dev))
    assert ea.LAUNCHES["kv_proj"] == before + 1 and got.shape == (64, 128)
    flat = torch.randn(64 * 64 + 1, device=dev).bfloat16()
    with pytest.raises(ValueError, match="16-byte"):
        ea.kv_proj(flat[1:].view(64, 64), torch.randn(128, 64, device=dev).bfloat16(), torch.zeros(128, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [32, 64, 128, 256])
def test_gnn_prepass_matches_node_products(dev, graph, dtype, channels):
    """The GNN conv's per-node pre-pass (one launch, two products) against
    its plain version, on a bipartite set's node counts."""
    gen = torch.Generator().manual_seed(5)
    nd, ns, c = graph["hidden"].num_nodes, graph["data"].num_nodes, channels
    x_dst = torch.randn(2, nd, c, generator=gen).to(dev, dtype)
    x_src = torch.randn(2, ns, c, generator=gen).to(dev, dtype)
    w0 = (torch.randn(c, 3 * c, generator=gen) * (3 * c) ** -0.5).to(dev, dtype)
    b0 = torch.randn(c, generator=gen).to(dev, dtype)
    before = gc.LAUNCHES["gnn_prepass"]
    got = gc.gnn_prepass(x_dst, x_src, w0, b0)
    assert gc.LAUNCHES["gnn_prepass"] == before + 1
    want = gc.node_products(x_dst, x_src, w0, b0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=TOL[torch.float32], rtol=TOL[torch.float32])


# every lane layout of ops/edge_attention.py:_lane_layout: one head group of 32 lanes (the flagship's
# C = 256), 24 active lanes (6 heads), several groups (C >= 384), one channel a lane (C = 32), a head
# of 128 or 256 channels (the hierarchical model's coarser levels: C = 512, 1024 with 4 heads), head
# widths that are not powers of two, so that lanes pad each head (D = 96, 48, 40, 24, 192), heads
# wider than 256 on 16 or 32 channels a lane (D = 320, 512, 1024, and 384 padded lanes), and head
# widths the wrapper pads with zero channels (D = 10 -> 16, 12 -> 16, 20 -> 24, 520 -> 544)
WIDTHS = [(64, 4), (256, 4), (512, 4), (128, 16), (32, 4), (192, 6), (384, 6), (768, 6), (1024, 8), (1024, 16),
          (1024, 4), (256, 1), (384, 4), (96, 1), (192, 4), (48, 1), (240, 6), (384, 16), (768, 4),
          (640, 2), (1024, 2), (1024, 1), (768, 2), (40, 4), (36, 3), (20, 1), (1040, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,heads", WIDTHS)
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
    again = ea.edge_attn_csr(q, kv, rowptr, src, a, w_aug, heads)
    torch.cuda.synchronize()
    for g, w, g2 in zip(got, want, again):
        torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])
        assert torch.equal(g, g2), "two calls differ"
    if edges == "dead":
        dead = torch.from_numpy(np.tile(np.arange(nd) % 4 == 1, batch)).to(dev)
        assert bool((got.m[dead] == -1e30).all()) and bool((got.den[dead] == 0).all())
        assert bool((got.num[dead] == 0).all())


def _bwd_edge_set(graph, edges, dev):
    """(rowptr, src, num_edges, ns, nd, dead) of a named edge set: the small
    graph's three sets; "dead", the processor's with every fourth
    destination cut off; "hub", the processor's plus 96 more edges into one
    destination (degree >= 96: the dst pass's subgroup walks several rounds
    of 32 source ids); "knn3", a bipartite knn-3 set with more destinations
    than sources and destinations 7 and the last with no edge."""
    if edges in ("hub", "knn3"):
        rng = np.random.RandomState(11)
        if edges == "hub":
            base = graph[("hidden", "to", "hidden")].edge_index
            ns = nd = graph["hidden"].num_nodes
            extra = np.stack([rng.randint(0, ns, 96), np.full(96, 5)])
            ei = np.concatenate([base, extra], axis=1)
            ei = ei[:, np.argsort(ei[1], kind="stable")]
        else:
            ns, nd = 300, 2000
            dst = np.repeat(np.arange(nd), 3)
            ei = np.stack([rng.randint(0, ns, dst.size), dst])
            ei = ei[:, (ei[1] != 7) & (ei[1] != nd - 1)]
        rowptr, src = ea.csr_from_edge_index(ei, ns, nd)
        deg = np.diff(rowptr)
        return (torch.from_numpy(rowptr).to(dev), torch.from_numpy(src).to(dev), ei.shape[1], ns, nd, deg == 0)
    names = {"hidden-hidden": ("hidden", "hidden"), "data-hidden": ("data", "hidden"),
             "hidden-data": ("hidden", "data"), "dead": ("hidden", "hidden")}[edges]
    es = graph[(names[0], "to", names[1])]
    ns, nd = graph[names[0]].num_nodes, graph[names[1]].num_nodes
    keep = es.edge_index[1] % 4 != 1 if edges == "dead" else None
    rowptr, src, num_edges = _csr(es, ns, nd, dev, keep)
    return rowptr, src, num_edges, ns, nd, np.diff(rowptr.cpu().numpy()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,heads", WIDTHS)
@pytest.mark.parametrize("edges", ["hidden-hidden", "data-hidden", "hidden-data", "dead", "hub", "knn3"])
@pytest.mark.parametrize("batch", [1, 2])
def test_edge_attn_csr_bwd_matches_plain_and_repeats_bit_for_bit(dev, graph, dtype, channels, heads, edges, batch):
    """All four gradients against the plain version (normwise 1e-4), two
    calls bit-identical and zero dq at destinations without edges, on the
    small graph's sets and the cases the dst pass's layout introduces: a
    destination of degree >= 96, a knn-3 set with more destinations than
    sources, destinations with no edge, and the batch loop (B = 2) that da
    is summed over inside the CTA."""
    rowptr, src, num_edges, ns, nd, dead = _bwd_edge_set(graph, edges, dev)
    csr_t = _csr_t(rowptr, src, ns)
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(batch * nd, channels, generator=gen).to(dev, dtype)
    kv = torch.randn(batch * ns, 2 * channels, generator=gen).to(dev, dtype)
    a = torch.randn(num_edges, 8, generator=gen).to(dev, dtype)
    w_aug = (torch.randn(8, channels, generator=gen) * 0.3).to(dev, dtype)
    g_num = torch.randn(batch * nd, channels, generator=gen).to(dev)
    g_den = torch.randn(batch * nd, heads, generator=gen).to(dev)
    m = ea.edge_attn_csr(q, kv, rowptr, src, a, w_aug, heads).m
    args = (q, kv, rowptr, src, a, w_aug, m, g_num, g_den, heads)
    before = ea.LAUNCHES["edge_attn_csr_bwd"]
    got = ea.edge_attn_csr_bwd(*args, csr_t)
    again = ea.edge_attn_csr_bwd(*args, csr_t)
    assert ea.LAUNCHES["edge_attn_csr_bwd"] == before + 2
    want = ea.edge_attn_csr_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, g2, w in zip(("dq", "dkv", "da", "dw_aug"), got, again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert torch.equal(g, g2), f"{name} differs between two calls"
        assert _normwise(g, w) <= BWD_TOL, f"{name}: normwise error {_normwise(g, w):.3e}"
    assert edges not in ("dead", "knn3") or dead.any()
    assert bool((got[0][torch.from_numpy(np.tile(dead, batch)).to(dev)] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,heads", [(256, 4), (192, 6), (1024, 16), (1024, 4), (384, 4)])
@pytest.mark.parametrize("a2", [5, 12, 16])
def test_edge_attention_takes_every_attribute_count(dev, graph, dtype, channels, heads, a2):
    """Both kernels at attribute counts other than the flagship's 8 (5, 12,
    16: the factored edge term takes any count), against the plain
    versions, batch 2, two calls bit-identical."""
    rowptr, src, num_edges, ns, nd, _ = _bwd_edge_set(graph, "data-hidden", dev)
    csr_t = _csr_t(rowptr, src, ns)
    gen = torch.Generator().manual_seed(4)
    batch = 2
    q = torch.randn(batch * nd, channels, generator=gen).to(dev, dtype)
    kv = torch.randn(batch * ns, 2 * channels, generator=gen).to(dev, dtype)
    a = torch.randn(num_edges, a2, generator=gen).to(dev, dtype)
    w_aug = (torch.randn(a2, channels, generator=gen) * 0.3).to(dev, dtype)
    g_num = torch.randn(batch * nd, channels, generator=gen).to(dev)
    g_den = torch.randn(batch * nd, heads, generator=gen).to(dev)
    got, again = (ea.edge_attn_csr(q, kv, rowptr, src, a, w_aug, heads) for _ in range(2))
    want = ea.edge_attn_csr_plain(q, kv, rowptr, src, a, w_aug, heads)
    args = (q, kv, rowptr, src, a, w_aug, got.m, g_num, g_den, heads)
    bgot, bagain = (ea.edge_attn_csr_bwd(*args, csr_t) for _ in range(2))
    bwant = ea.edge_attn_csr_bwd_plain(*args)
    torch.cuda.synchronize()
    for g, g2, w in zip(got, again, want):
        torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])
        assert torch.equal(g, g2), "two forward calls differ"
    for name, g, g2, w in zip(("dq", "dkv", "da", "dw_aug"), bgot, bagain, bwant):
        assert torch.equal(g, g2), f"{name} differs between two calls"
        assert _normwise(g, w) <= BWD_TOL, f"{name}: normwise error {_normwise(g, w):.3e}"


def test_wrappers_reject_what_the_kernels_do_not_take(dev, graph):
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    rowptr, src, num_edges = _csr(es, n, n, dev)
    q = torch.randn(n, 2048, device=dev)  # 1 head of 2048: wider than 1024
    kv = torch.randn(n, 4096, device=dev)
    a = torch.randn(num_edges, 8, device=dev)
    with pytest.raises(ValueError, match="head widths"):
        ea.edge_attn_csr(q, kv, rowptr, src, a, torch.randn(8, 2048, device=dev), 1)
    # 3 heads of 12 (not a multiple of 8) and 4 of 320 (wider than 256): padded or on wide lanes, they run
    for c, h in ((36, 3), (1280, 4)):
        q, kv = torch.randn(n, c, device=dev), torch.randn(n, 2 * c, device=dev)
        before = ea.LAUNCHES["edge_attn_csr"]
        p = ea.edge_attn_csr(q, kv, rowptr, src, a, torch.randn(8, c, device=dev), h)
        assert ea.LAUNCHES["edge_attn_csr"] == before + 1 and p.num.shape == (n, h, c // h)
    q, kv = torch.randn(n, 64, device=dev), torch.randn(n, 128, device=dev)
    with pytest.raises(ValueError, match="share one dtype"):
        ea.edge_attn_csr(q, kv.bfloat16(), rowptr, src, a, torch.randn(8, 64, device=dev), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ea.edge_attn_csr(q, kv, rowptr, src, a, torch.randn(64, 8, device=dev).t(), 4)
    with pytest.raises(ValueError, match="several devices"):
        ea.kv_proj(torch.randn(4, 8, device=dev), torch.randn(6, 8), torch.randn(6))
    with pytest.raises(ValueError, match="fp32"):
        ea.kv_proj(torch.randn(4, 8, device=dev), torch.randn(6, 8, device=dev), torch.randn(6, device=dev).bfloat16())
    # every width the forward takes also trains: one channel a lane (C = 32), 24 lanes (6 heads of 32)
    # and four head groups (C = 1024, 16 heads)
    for c, h in ((32, 4), (192, 6), (1024, 16)):
        q, kv, w_aug = torch.randn(n, c, device=dev), torch.randn(n, 2 * c, device=dev), torch.randn(8, c, device=dev)
        m = ea.edge_attn_csr(q, kv, rowptr, src, a, w_aug, h).m
        before = ea.LAUNCHES["edge_attn_csr_bwd"]
        dq, dkv, da, dw = ea.edge_attn_csr_bwd(q, kv, rowptr, src, a, w_aug, m, q, torch.zeros(n, h, device=dev), h,
                                               _csr_t(rowptr, src, n))
        assert ea.LAUNCHES["edge_attn_csr_bwd"] == before + 1
        assert dq.shape == (n, c) and dkv.shape == (n, 2 * c) and da.shape == a.shape and dw.shape == (8, c)
    misaligned = torch.randn(n * 64 + 1, device=dev)[1:].view(n, 64)  # 4 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte"):
        ea.edge_attn_csr(misaligned, torch.randn(n, 128, device=dev), rowptr, src, a, torch.randn(8, 64, device=dev), 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [64, 128, 256])
@pytest.mark.parametrize("edges", ["hidden-hidden", "data-hidden", "hidden-data", "dead"])
def test_gnn_conv_matches_plain_and_repeats_bit_for_bit(dev, graph, dtype, channels, edges):
    """agg and msg against the plain version, batch 2; the processor's edge
    set as a self-graph, the mappers' bipartite; two calls bit-identical."""
    names = {"hidden-hidden": ("hidden", "hidden"), "data-hidden": ("data", "hidden"),
             "hidden-data": ("hidden", "data"), "dead": ("hidden", "hidden")}[edges]
    es = graph[(names[0], "to", names[1])]
    ns, nd = graph[names[0]].num_nodes, graph[names[1]].num_nodes
    keep = es.edge_index[1] % 4 != 1 if edges == "dead" else None
    rowptr, src, num_edges = _csr(es, ns, nd, dev, keep)
    gen = torch.Generator().manual_seed(3)
    batch, c = 2, channels
    x_dst = torch.randn(batch, nd, c, generator=gen).to(dev, dtype)
    x_src = x_dst if names[0] == names[1] else torch.randn(batch, ns, c, generator=gen).to(dev, dtype)
    e = torch.randn(batch, num_edges, c, generator=gen).to(dev, dtype)
    dense = [(torch.randn(c, k, generator=gen) * k ** -0.5, torch.randn(c, generator=gen) * 0.1) for k in (3 * c, c, c)]
    norm = (1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
    ops = [t.to(dev) for t in gc.mlp_operands(dense, norm, dtype)]
    before = gc.LAUNCHES["gnn_conv"]
    got = gc.gnn_conv(x_dst, x_src, e, rowptr, src, ops, "SiLU")
    again = gc.gnn_conv(x_dst, x_src, e, rowptr, src, ops, "SiLU")
    assert gc.LAUNCHES["gnn_conv"] == before + 2
    want = gc.gnn_conv_plain(x_dst, x_src, e, rowptr, src, ops, "SiLU")
    torch.cuda.synchronize()
    for name, g, g2, w in zip(("agg", "msg"), got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, g2), f"{name} differs between two calls"
    # agg is the fp32 sum of the kernel's own msg; both against plain: elementwise in fp32, normwise in
    # bf16 (the two round at the same points from fp32 sums taken in another order, so a value can land
    # one bf16 step apart, and a step taken before "+ beta" or "+ e" stays where that sum cancels)
    torch.testing.assert_close(got[0], gc.aggregate(got[1], rowptr), atol=TOL[torch.float32],
                               rtol=TOL[torch.float32], msg="agg of msg")
    for name, g, w in zip(("agg", "msg"), got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype], msg=name)
        else:
            assert _normwise(g, w) <= TOL[dtype], f"{name}: normwise error {_normwise(g, w):.3e}"
    if edges == "dead":
        assert bool((got[0][:, torch.from_numpy(np.arange(nd) % 4 == 1).to(dev)] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 24, 48, 96, 256, 160, 512, 1024])
@pytest.mark.parametrize("n,window,causal", [(700, 64, False), (700, None, False), (333, 40, False),
                                             (700, 64, True), (450, None, True), (700, 40, False),
                                             (700, 100, False), (100, None, False), (100, 30, True),
                                             (1, None, False), (1, 0, True), (129, 64, False),
                                             (257, None, True)])
def test_flash_attention_matches_plain(dev, dtype, head_dim, n, window, causal):
    """Band-masked attention against the plain blockwise version, with q, k
    and v strided views of one fused (B, N, 3, H, D) projection (as the
    attention layer passes them) and ragged sequence lengths: windows
    narrower than a key block and not a multiple of 64, N below one
    128-query tile, N = 1 and N one past a 128 boundary; two calls
    bit-identical, contiguous copies the same bits, and k, v at strides of
    their own within the tolerance."""
    gen = torch.Generator().manual_seed(4)
    b, h = 2, 3
    qkv = torch.randn(b, n, 3, h, head_dim, generator=gen).to(dev, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, window, causal)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.blockwise_attention(q, k, v, window_size=window, is_causal=causal)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, h, n, head_dim) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(fa.flash_attention(q, k, v, window, causal), got), "two calls differ"
    contiguous = [t.contiguous() for t in (q, k, v)]
    torch.testing.assert_close(fa.flash_attention(*contiguous, window, causal), got, atol=0, rtol=0)
    mixed = fa.flash_attention(q, *contiguous[1:], window, causal)  # k, v off q's strides: the offset kernels
    torch.testing.assert_close(mixed.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim,n,window,causal", [(64, 700, 64, False), (64, 333, None, True), (24, 257, 40, False),
                                                      (256, 700, 100, False), (512, 300, 30, True)])
def test_flash_attention_dropout_matches_plain(dev, dtype, head_dim, n, window, causal):
    """Attention-weight dropout in the kernels (the wgmma, tile and row
    kernels) against the plain blockwise version with the same key: the
    same mask, so the outputs agree within the dropout-free tolerances; two
    calls bit-identical, another key another output, rate 0 with a key the
    dropout-free kernel's bits."""
    gen = torch.Generator().manual_seed(8)
    qkv = torch.randn(2, n, 3, 3, head_dim, generator=gen).to(dev, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    key = fa.fold_key(123, 7, 2)
    got = fa.flash_attention(q, k, v, window, causal, 0.1, key)
    want = fa.blockwise_attention(q, k, v, window_size=window, is_causal=causal, dropout_rate=0.1, dropout_key=key)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(fa.flash_attention(q, k, v, window, causal, 0.1, key), got)
    assert not torch.equal(fa.flash_attention(q, k, v, window, causal, 0.1, fa.fold_key(123, 8, 2)), got)
    assert torch.equal(fa.flash_attention(q, k, v, window, causal, 0.0, key), fa.flash_attention(q, k, v, window, causal))


FLASH_OFFSETS = {  # query rows [q0, q1) of a 333-long sequence, key rows, the window, causal, dropout
    "halo rank 0": ((0, 167), [(293, 333), (0, 207)], -40, 40, False, 0.0),
    "halo rank 1": ((167, 333), [(127, 333), None], 127, 40, False, 0.0),
    "gathered causal": ((167, 333), [(0, 333)], 0, None, True, 0.0),
    "gathered no window": ((100, 333), [(0, 333)], 0, None, False, 0.0),
    "halo rank 1 dropout": ((167, 333), [(127, 333), None], 127, 40, False, 0.1),
    "gathered window dropout": ((101, 333), [(0, 333)], 0, 64, False, 0.1),
    "no query rows": ((333, 333), [(0, 333)], 0, None, True, 0.0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128, 24, 256, 512, 1024])
@pytest.mark.parametrize("case", list(FLASH_OFFSETS))
def test_flash_attention_offsets_match_plain(dev, dtype, head_dim, case):
    """Queries and keys at offsets (a rank's rows of a sequence split over
    two ranks: halo-extended keys, 40 zero rows past the end on rank 1, a
    left halo before the start on rank 0; or every key): the kernels against
    the plain version with the same offsets, two calls bit-identical, and
    with dropout the rows of the unsharded call (the pairs drawn at global
    positions; rank 1's keys start off a multiple of 4)."""
    (q0, q1), parts, k_off, window, causal, rate = FLASH_OFFSETS[case]
    gen = torch.Generator().manual_seed(6)
    n, b, h = 333, 2, 3
    qkv = torch.randn(b, n, 3, h, head_dim, generator=gen).to(dev, dtype)
    q_all, k_all, v_all = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    k, v = torch.stack([torch.cat([t[:, :, p[0]:p[1]] if p else t.new_zeros(b, h, 40, head_dim) for p in parts],
                                  dim=2) for t in (k_all, v_all)])
    q = q_all[:, :, q0:q1]
    key = fa.fold_key(5, 1) if rate else None
    args = (window, causal, rate, key, q0, k_off, n)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, *args)
    assert fa.LAUNCHES["flash_attention"] == before + (q1 > q0)
    want = fa.blockwise_attention(q, k, v, window_size=window, is_causal=causal, dropout_rate=rate, dropout_key=key,
                                  q_offset=q0, k_offset=k_off, n_valid=n)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, h, q1 - q0, head_dim) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(fa.flash_attention(q, k, v, *args), got), "two calls differ"
    if rate:
        whole = fa.flash_attention(q_all, k_all, v_all, window, causal, rate, key)
        torch.testing.assert_close(got.float(), whole[:, :, q0:q1].float(), atol=TOL[dtype], rtol=TOL[dtype])


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev, graph):
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    rowptr, src, num_edges = _csr(es, n, n, dev)
    c = 64
    x, e = torch.randn(1, n, c, device=dev), torch.randn(1, num_edges, c, device=dev)
    dense = [(torch.randn(c, k), torch.randn(c)) for k in (3 * c, c, c)]
    ops = [t.to(dev) for t in gc.mlp_operands(dense, (torch.ones(c), torch.zeros(c)), torch.float32)]
    with pytest.raises(ValueError, match="fp32 or bf16"):
        gc.gnn_conv(x.half(), x.half(), e.half(), rowptr, src, [t.half() for t in ops], "SiLU")
    with pytest.raises(ValueError, match="share one dtype"):
        gc.gnn_conv(x.bfloat16(), x.bfloat16(), e.bfloat16(), rowptr, src, ops, "SiLU")
    with pytest.raises(ValueError, match="contiguous"):
        gc.gnn_conv(x, x, torch.randn(1, c, num_edges, device=dev).transpose(1, 2), rowptr, src, ops, "SiLU")
    # a deeper edge MLP takes the layered route, and so does a width off the 16-byte rule (padded)
    deep = [t.to(dev) for t in gc.mlp_operands(dense[:1] + dense[1:2] * 2 + dense[2:], (torch.ones(c), torch.zeros(c)),
                                               torch.float32)]
    before = gc.LAUNCHES["gnn_conv_layered"]
    gc.gnn_conv(x, x, e, rowptr, src, deep, "SiLU")
    assert gc.LAUNCHES["gnn_conv_layered"] == before + 1
    c = 36
    x, e = torch.randn(1, n, c, device=dev), torch.randn(1, num_edges, c, device=dev)
    odd = [t.to(dev) for t in gc.mlp_operands([(torch.randn(c, k), torch.randn(c)) for k in (3 * c, c, c)],
                                              (torch.ones(c), torch.zeros(c)), torch.float32)]
    before = gc.LAUNCHES["gnn_conv_layered"]
    agg, msg = gc.gnn_conv(x, x, e, rowptr, src, odd, "SiLU")
    assert gc.LAUNCHES["gnn_conv_layered"] == before + 1 and agg.shape == (1, n, c) and msg.shape == e.shape
    with pytest.raises(NotImplementedError, match="activation"):
        gc.gnn_conv(x, x, e, rowptr, src, ops, "hardswish")  # no such name in the reference's registry
    q = torch.randn(1, 2, 100, 64, device=dev)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.flash_attention(q.half(), q.half(), q.half(), 8)
    with pytest.raises(ValueError, match="contiguous channels"):
        strided = torch.randn(1, 2, 100, 128, device=dev)[..., ::2]
        fa.flash_attention(strided, strided, strided, 8)
    with pytest.raises(ValueError, match="head widths"):
        wide = torch.randn(1, 1, 10, 1040, device=dev)
        fa.flash_attention(wide, wide, wide, 8)
    with pytest.raises(ValueError, match="dropout_key"):
        fa.flash_attention(q, q, q, 8, False, 0.1)


def test_graph_conv_with_extra_mlp_layers_raises_on_the_card(dev, graph):
    """mlp_extra_layers > 0 on the card: the layered route, not a refusal.
    GraphConv's forward and its gradients on the card against the CPU's
    plain version, fp32."""
    from anemoi_models_tpu_torch.layers.conv import GraphConv

    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    rowptr, src, num_edges = _csr(es, n, n, torch.device("cpu"))
    conv = GraphConv(32, 32, mlp_extra_layers=1, device="cpu")
    gen = torch.Generator().manual_seed(6)
    x, e = torch.randn(1, n, 32, generator=gen), torch.randn(1, num_edges, 32, generator=gen)
    grads = []
    for device in (torch.device("cpu"), dev):
        layer = GraphConv(32, 32, mlp_extra_layers=1, device="cpu")
        layer.load_state_dict(conv.state_dict())
        layer.to(device)
        xx, ee = (t.detach().to(device).requires_grad_() for t in (x, e))
        before = gc.LAUNCHES["gnn_conv_layered"]
        agg, msg = layer(xx, ee, rowptr.to(device), src.to(device))
        assert gc.LAUNCHES["gnn_conv_layered"] == before + (device.type == "cuda")
        (agg.sum() + (msg * msg).sum()).backward()
        grads.append([t.detach().cpu() for t in (agg, msg, xx.grad, ee.grad)]
                     + [p.grad.cpu() for p in layer.parameters()])
    for got, want in zip(grads[1], grads[0]):
        assert _normwise(got, want) <= BWD_TOL


# 2056: above the 2,048 columns that the bf16 LayerNorm pass holds in registers; the last five padded to a
# multiple of 8
LAYERED = [(384, 0), (512, 0), (1024, 0), (2056, 0), (256, 1), (256, 2), (48, 0), (40, 1), (32, 1), (136, 0),
           (36, 0), (100, 0), (260, 0), (12, 1), (3, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,extra", LAYERED)
@pytest.mark.parametrize("edges", ["hidden-hidden", "data-hidden", "hidden-data", "dead"])
def test_gnn_conv_layered_matches_plain_and_repeats_bit_for_bit(dev, graph, dtype, channels, extra, edges,
                                                                monkeypatch):
    """The layered route (every width and MLP depth the fused kernels do not
    take; a width off C % 8 == 0 padded) against the plain version, batch 2, in chunks of
    1,000 edge rows (so a chunk crosses the batch boundary and the last is
    ragged); two calls bit-identical. msg at the fused route's bounds; agg
    exactly the fp32 sum of the kernel's own msg (1e-5) and, against plain,
    normwise in both dtypes: at C >= 384 the plain version's own fp32 agg
    differs from a float64 sum by up to 2.5e-5 here (cuBLAS's summation
    order over K = C against the kernel's; the kernel's differs by up to
    3.6e-5), so an elementwise 1e-5 on a sum of up to 30 messages would
    judge the reference's round-off, not the kernel."""
    names = {"hidden-hidden": ("hidden", "hidden"), "data-hidden": ("data", "hidden"),
             "hidden-data": ("hidden", "data"), "dead": ("hidden", "hidden")}[edges]
    es = graph[(names[0], "to", names[1])]
    ns, nd = graph[names[0]].num_nodes, graph[names[1]].num_nodes
    keep = es.edge_index[1] % 4 != 1 if edges == "dead" else None
    rowptr, src, num_edges = _csr(es, ns, nd, dev, keep)
    monkeypatch.setattr(gc, "LAYERED_CHUNK", 1000)
    gen = torch.Generator().manual_seed(7)
    batch, c = 2, channels
    x_dst = torch.randn(batch, nd, c, generator=gen).to(dev, dtype)
    x_src = x_dst if names[0] == names[1] else torch.randn(batch, ns, c, generator=gen).to(dev, dtype)
    e = torch.randn(batch, num_edges, c, generator=gen).to(dev, dtype)
    dense = [(torch.randn(c, k, generator=gen) * k ** -0.5, torch.randn(c, generator=gen) * 0.1)
             for k in (3 * c,) + (c,) * (2 + extra)]
    norm = (1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
    ops = [t.to(dev) for t in gc.mlp_operands(dense, norm, dtype)]
    assert gc._gnn_route(c, 3 + extra) == "layered"
    before = gc.LAUNCHES["gnn_conv_layered"]
    got = gc.gnn_conv(x_dst, x_src, e, rowptr, src, ops, "SiLU")
    again = gc.gnn_conv(x_dst, x_src, e, rowptr, src, ops, "SiLU")
    assert gc.LAUNCHES["gnn_conv_layered"] == before + 2
    want = gc.gnn_conv_plain(x_dst, x_src, e, rowptr, src, ops, "SiLU")
    torch.cuda.synchronize()
    for name, g, g2, w in zip(("agg", "msg"), got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, g2), f"{name} differs between two calls"
    torch.testing.assert_close(got[0], gc.aggregate(got[1], rowptr), atol=TOL[torch.float32],
                               rtol=TOL[torch.float32], msg="agg of msg")
    if dtype == torch.float32:
        torch.testing.assert_close(got[1], want[1], atol=TOL[dtype], rtol=TOL[dtype])
    else:
        assert _normwise(got[1], want[1]) <= TOL[dtype], f"msg: normwise error {_normwise(got[1], want[1]):.3e}"
    assert _normwise(got[0], want[0]) <= TOL[dtype], f"agg: normwise error {_normwise(got[0], want[0]):.3e}"
    if edges == "dead":
        assert bool((got[0][:, torch.from_numpy(np.arange(nd) % 4 == 1).to(dev)] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,chunk", [(2, None), (1, 1000), (2, 777)])
def test_gnn_conv_layered_at_production_width(dev, graph, dtype, batch, chunk, monkeypatch):
    """The layered route at C = 1024 (three Dense) on the processor set:
    two samples in one chunk, E larger than a chunk (1,000 rows: a chunk
    ends inside a destination's row and off the 128-row tile), and two
    samples in chunks of 777 (a chunk crosses the batch boundary). Two calls
    bit-identical, one launch each; agg the fp32 sum of the kernel's own msg;
    msg and agg against plain at the fused route's bounds (agg normwise, as
    in test_gnn_conv_layered_matches_plain_and_repeats_bit_for_bit)."""
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    rowptr, src, num_edges = _csr(es, n, n, dev)
    if chunk is not None:
        monkeypatch.setattr(gc, "LAYERED_CHUNK", chunk)
        assert batch * num_edges > chunk and chunk % 128
        assert bool(((rowptr[:-1] < chunk) & (rowptr[1:] > chunk)).any()), "the first chunk ends between destinations"
    gen = torch.Generator().manual_seed(11)
    c = 1024
    x = torch.randn(batch, n, c, generator=gen).to(dev, dtype)
    e = torch.randn(batch, num_edges, c, generator=gen).to(dev, dtype)
    dense = [(torch.randn(c, k, generator=gen) * k ** -0.5, torch.randn(c, generator=gen) * 0.1)
             for k in (3 * c, c, c)]
    norm = (1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
    ops = [t.to(dev) for t in gc.mlp_operands(dense, norm, dtype)]
    assert gc._gnn_route(c, 3) == "layered"
    before = gc.LAUNCHES["gnn_conv_layered"]
    got = gc.gnn_conv(x, x, e, rowptr, src, ops, "SiLU")
    again = gc.gnn_conv(x, x, e, rowptr, src, ops, "SiLU")
    assert gc.LAUNCHES["gnn_conv_layered"] == before + 2
    want = gc.gnn_conv_plain(x, x, e, rowptr, src, ops, "SiLU")
    torch.cuda.synchronize()
    for name, g, g2, w in zip(("agg", "msg"), got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, g2), f"{name} differs between two calls"
    torch.testing.assert_close(got[0], gc.aggregate(got[1], rowptr), atol=TOL[torch.float32],
                               rtol=TOL[torch.float32], msg="agg of msg")
    if dtype == torch.float32:
        torch.testing.assert_close(got[1], want[1], atol=TOL[dtype], rtol=TOL[dtype])
    else:
        assert _normwise(got[1], want[1]) <= TOL[dtype], f"msg: normwise error {_normwise(got[1], want[1]):.3e}"
    assert _normwise(got[0], want[0]) <= TOL[dtype], f"agg: normwise error {_normwise(got[0], want[0]):.3e}"


def _interfaces(graph, remat_policy="full"):
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
                          "num_layers": 2, "num_chunks": 2, "remat_policy": remat_policy, **mapper},
            "decoder": {"_target_": "anemoi.models.layers.mapper.GraphTransformerBackwardMapper", **mapper},
        },
    })
    n2i = {"lsm": 0, "z_500": 1, "t_850": 2, "t2m": 3, "tp": 4}
    di = IndexCollection(cfg, n2i)
    ifaces = []
    for _ in range(2):
        iface = AnemoiModelInterface(config=cfg, graph_data=graph, statistics={}, data_indices=di, device="cpu")
        gen = torch.Generator().manual_seed(5)
        iface.init_params(gen)
        with torch.no_grad():
            for p in iface.model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
        ifaces.append(iface)
    return ifaces


def test_model_forward_on_card_matches_cpu(dev, graph):
    cpu, card = _interfaces(graph)
    x = torch.randn(1, 2, 1, graph["data"].num_nodes, 4, generator=torch.Generator().manual_seed(6))
    ref = cpu.forward(x)
    before = dict(ea.LAUNCHES)
    out = card.to(dev).forward(x.to(dev)).cpu()
    assert {k: ea.LAUNCHES[k] - before[k] for k in before} == {"kv_proj": 4, "edge_attn_csr": 4, "edge_attn_csr_bwd": 0}
    bound = 1e-4 * max(1.0, ref.abs().mean().item())
    assert (out - ref).abs().max().item() <= bound


def test_rollout_launches_on_card(dev, graph):
    """predict_rollout on the card: 4 launches of each GraphTransformer
    forward kernel per lead time (encoder, two processor layers, decoder),
    none of the backward; the first lead time is predict_step's answer bit
    for bit; every lead time against the CPU's plain versions."""
    cpu, card = _interfaces(graph)
    card.to(dev)
    n_steps, n_grid = 3, graph["data"].num_nodes
    gen = torch.Generator().manual_seed(10)
    batch = torch.randn(1, 2, n_grid, 4, generator=gen)  # the model-input width
    forcings = torch.randn(n_steps, 1, 1, n_grid, 1, generator=gen)
    before = dict(ea.LAUNCHES)
    got = card.predict_rollout(batch.to(dev), n_steps, forcings.to(dev))
    counts = {k: ea.LAUNCHES[k] - before[k] for k in before}
    assert counts == {"kv_proj": 4 * n_steps, "edge_attn_csr": 4 * n_steps, "edge_attn_csr_bwd": 0}
    assert torch.equal(got[0], card.predict_step(batch.to(dev)))
    want = cpu.predict_rollout(batch, n_steps, forcings)
    for t in range(n_steps):
        assert (got[t].cpu() - want[t]).abs().max().item() <= 1e-4 * max(1.0, want[t].abs().mean().item()), t


@pytest.mark.parametrize("remat_policy", ["full", "none"])
def test_model_gradients_on_card_match_cpu(dev, graph, remat_policy):
    """Every parameter's gradient of the MSE loss, kernels on the card against
    the plain versions on the CPU, fp32; the two mapper blocks are recomputed
    in the backward under every policy (2 more forward launches of each
    kernel), and with "full" the two processor chunks too (2 more)."""
    from anemoi_models_tpu_torch.training import weighted_mse

    cpu, card = _interfaces(graph, remat_policy)
    card.to(dev)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(1, 2, 1, graph["data"].num_nodes, 4, generator=gen)
    y = torch.randn(1, 1, graph["data"].num_nodes, 4, generator=gen)
    weighted_mse(cpu.model(x), y).backward()
    before = dict(ea.LAUNCHES)
    weighted_mse(card.model(x.to(dev)), y.to(dev)).backward()
    torch.cuda.synchronize()
    recompute = 2 + (2 if remat_policy == "full" else 0)
    assert {k: ea.LAUNCHES[k] - before[k] for k in before} == {
        "kv_proj": 4 + recompute, "edge_attn_csr": 4 + recompute, "edge_attn_csr_bwd": 4,
    }
    card_grads = dict(card.model.named_parameters())
    for name, p in cpu.model.named_parameters():
        assert _normwise(card_grads[name].grad.cpu(), p.grad) <= BWD_TOL, name


def _flavor_interfaces(graph, flavor):
    from anemoi_models_tpu_torch.data_indices import IndexCollection
    from anemoi_models_tpu_torch.interface import AnemoiModelInterface
    from anemoi_models_tpu_torch.utils import DotDict

    edges = {"trainable_size": 4, "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
    gt = {**edges, "num_heads": 4}
    layers = "anemoi.models.layers."
    mapper, mkw, processor = {
        "gnn": ("GNN", edges, {"_target_": layers + "processor.GNNProcessor", **edges}),
        "transformer": ("GraphTransformer", gt, {"_target_": layers + "processor.TransformerProcessor",
                                                 "num_heads": 4, "window_size": 64, "dropout_p": 0.0}),
    }[flavor]
    cfg = DotDict({
        "data": {"forcing": ["lsm"], "diagnostic": ["tp"], "processors": {}},
        "graph": {"data": "data", "hidden": "hidden"},
        "training": {"multistep_input": 2},
        "model": {
            "num_channels": 64, "trainable_parameters": {"hidden": 8},
            "model": {"_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"},
            "encoder": {"_target_": layers + f"mapper.{mapper}ForwardMapper", **mkw},
            "processor": {"num_layers": 2, "num_chunks": 2, **processor},
            "decoder": {"_target_": layers + f"mapper.{mapper}BackwardMapper", **mkw},
        },
    })
    di = IndexCollection(cfg, {"lsm": 0, "z_500": 1, "t_850": 2, "t2m": 3, "tp": 4})
    ifaces = []
    for _ in range(2):
        iface = AnemoiModelInterface(config=cfg, graph_data=graph, statistics={}, data_indices=di, device="cpu")
        gen = torch.Generator().manual_seed(8)
        iface.init_params(gen)
        with torch.no_grad():
            for p in iface.model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
        ifaces.append(iface)
    return ifaces


@pytest.mark.parametrize("flavor", ["gnn", "transformer"])
def test_flavor_model_on_card_matches_cpu(dev, graph, flavor):
    """The GNN and Transformer flavors (C=64, 2 layers, fp32): forward and
    every parameter's gradient, kernels on the card against the plain
    versions on the CPU, and the new kernel launched on the path (with the
    two processor chunks recomputed in the backward, and the GNN's two
    mapper blocks)."""
    from anemoi_models_tpu_torch.training import weighted_mse

    cpu, card = _flavor_interfaces(graph, flavor)
    card.to(dev)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(1, 2, 1, graph["data"].num_nodes, 4, generator=gen)
    y = torch.randn(1, 1, graph["data"].num_nodes, 4, generator=gen)
    ref = cpu.forward(x)
    table, name, n_fwd = (gc.LAUNCHES, "gnn_conv", 4) if flavor == "gnn" else (fa.LAUNCHES, "flash_attention", 2)
    before = table[name]
    out = card.forward(x.to(dev)).cpu()
    assert table[name] == before + n_fwd
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().mean().item())
    weighted_mse(cpu.model(x), y).backward()
    before = table[name]
    weighted_mse(card.model(x.to(dev)), y.to(dev)).backward()
    torch.cuda.synchronize()
    # the two processor layers again under remat "full", and the GNN mappers' convs
    assert table[name] == before + n_fwd + 2 + (2 if flavor == "gnn" else 0)
    card_grads = dict(card.model.named_parameters())
    for pname, p in cpu.model.named_parameters():
        assert _normwise(card_grads[pname].grad.cpu(), p.grad) <= BWD_TOL, pname


# each policy's forward launches of the flavor's kernel in a step of the reduced models (2 processor
# layers in 2 chunks, 2 mappers): the mappers' blocks again under every remat policy, the chunks under
# "full" and "save_dots" (the kernels are not 2-D products, so "save_dots" recomputes them), nothing
# again under cpu_offload
POLICY_LAUNCHES = {
    "graphtransformer": {"full": {"kv_proj": 8, "edge_attn_csr": 8}, "save_dots": {"kv_proj": 8, "edge_attn_csr": 8},
                         "none": {"kv_proj": 6, "edge_attn_csr": 6}, "cpu_offload": {"kv_proj": 4, "edge_attn_csr": 4}},
    "gnn": {"full": {"gnn_conv": 8}, "save_dots": {"gnn_conv": 8}, "none": {"gnn_conv": 6},
            "cpu_offload": {"gnn_conv": 4}},
    "transformer": {"full": {"flash_attention": 4, "kv_proj": 4}, "save_dots": {"flash_attention": 4, "kv_proj": 4},
                    "none": {"flash_attention": 2, "kv_proj": 4},
                    "cpu_offload": {"flash_attention": 2, "kv_proj": 2}},
}


def _set_policy(model, policy):
    """The model's processor chunks under ``policy``, or every remat unit
    under cpu_offload."""
    for module in model.modules():
        if hasattr(module, "cpu_offload"):
            module.cpu_offload = policy == "cpu_offload"
        if hasattr(module, "remat_policy"):
            module.remat_policy = "full" if policy == "cpu_offload" else policy


@pytest.mark.parametrize("flavor,batch", [("graphtransformer", 1), ("graphtransformer", 2), ("gnn", 1),
                                          ("transformer", 1)])
def test_memory_policies_on_card(dev, graph, flavor, batch):
    """The four memory policies on the card (remat "full", "save_dots",
    "none" and cpu_offload on every unit), fp32: the loss and every
    gradient bit-identical to "full"'s and within the backward's normwise
    1e-4 of the CPU's; each policy's launches of the flavor's kernels
    (``POLICY_LAUNCHES``). At batch 2 the expanded edge tensors and the
    transposed weights come back from the host under cpu_offload."""
    from anemoi_models_tpu_torch.layers import remat
    from anemoi_models_tpu_torch.training import weighted_mse

    cpu, card = _interfaces(graph) if flavor == "graphtransformer" else _flavor_interfaces(graph, flavor)
    card.to(dev)
    gen = torch.Generator().manual_seed(17)
    x = torch.randn(batch, 2, 1, graph["data"].num_nodes, 4, generator=gen)
    y = torch.randn(batch, 1, graph["data"].num_nodes, 4, generator=gen)
    weighted_mse(cpu.model(x), y).backward()
    tables = (ea.LAUNCHES, gc.LAUNCHES, fa.LAUNCHES)
    runs = {}
    for policy in ("full", "save_dots", "none", "cpu_offload"):
        _set_policy(card.model, policy)
        card.model.zero_grad(set_to_none=True)
        before = {k: v for t in tables for k, v in t.items()}
        remat.OFFLOADED.update(tensors=0, bytes=0)
        loss = weighted_mse(card.model(x.to(dev)), y.to(dev))
        loss.backward()
        torch.cuda.synchronize()
        counts = {k: v - before[k] for t in tables for k, v in t.items()}
        want = POLICY_LAUNCHES[flavor][policy]
        assert {k: counts[k] for k in want} == want, policy
        assert (remat.OFFLOADED["bytes"] > 0) == (policy == "cpu_offload"), policy
        runs[policy] = (loss.item(), {n: p.grad.clone() for n, p in card.model.named_parameters()})
    for policy, (loss, grads) in runs.items():
        assert loss == runs["full"][0], policy
        for name, g in runs["full"][1].items():
            assert torch.equal(grads[name], g), f"{policy}: {name}"
    for name, p in cpu.model.named_parameters():
        assert _normwise(runs["full"][1][name].cpu(), p.grad) <= BWD_TOL, name


# ---------------------------------------------------------------------------
# repairs: every activation of the registry, kv_proj off 16-byte rows, more than 15 edge attributes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,channels,extra", [("fused", 64, 0), ("layered", 48, 1)])
@pytest.mark.parametrize("activation", ["LeakyReLU", "ELU", "Softplus", "Mish"])
def test_gnn_conv_takes_every_activation(dev, graph, dtype, route, channels, extra, activation):
    """The four activations the kernels took last (LeakyReLU slope 0.01,
    ELU alpha 1, overflow-safe softplus, mish) on both routes, against the
    plain version (torch.nn.functional's defaults), batch 2, inputs scaled
    so that the softplus of 30 and of -30 are reached; two calls
    bit-identical."""
    es = graph[("data", "to", "hidden")]
    ns, nd = graph["data"].num_nodes, graph["hidden"].num_nodes
    rowptr, src, num_edges = _csr(es, ns, nd, dev)
    gen = torch.Generator().manual_seed(12)
    c = channels
    x_dst = (10 * torch.randn(2, nd, c, generator=gen)).to(dev, dtype)
    x_src = torch.randn(2, ns, c, generator=gen).to(dev, dtype)
    e = torch.randn(2, num_edges, c, generator=gen).to(dev, dtype)
    dense = [(torch.randn(c, k, generator=gen) * k ** -0.5, torch.randn(c, generator=gen) * 0.1)
             for k in (3 * c,) + (c,) * (2 + extra)]
    norm = (1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
    ops = [t.to(dev) for t in gc.mlp_operands(dense, norm, dtype)]
    assert gc._gnn_route(c, 3 + extra) == route
    name = "gnn_conv" if route == "fused" else "gnn_conv_layered"
    before = gc.LAUNCHES[name]
    got = gc.gnn_conv(x_dst, x_src, e, rowptr, src, ops, activation)
    again = gc.gnn_conv(x_dst, x_src, e, rowptr, src, ops, activation)
    assert gc.LAUNCHES[name] == before + 2
    want = gc.gnn_conv_plain(x_dst, x_src, e, rowptr, src, ops, activation)
    torch.cuda.synchronize()
    for label, g, g2, w in zip(("agg", "msg"), got, again, want):
        assert torch.equal(g, g2), f"{label} differs between two calls"
        assert bool(torch.isfinite(g).all()), label
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype], msg=label)
        else:
            assert _normwise(g, w) <= TOL[dtype], f"{label}: normwise error {_normwise(g, w):.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [36, 100])
def test_kv_proj_off_16_byte_rows_matches_plain(dev, dtype, k):
    """kv_proj at K = 36 and 100 (the GraphTransformer's source width at C =
    36 and 100; N = 2C), and at an odd N, against its plain version."""
    gen = torch.Generator().manual_seed(13)
    for n in (2 * k, 2 * k + 3):
        f = torch.randn(1000, k, generator=gen).to(dev, dtype)
        w = (torch.randn(n, k, generator=gen) * k ** -0.5).to(dev, dtype)
        b = torch.randn(n, generator=gen).to(dev)
        got, again = ea.kv_proj(f, w, b), ea.kv_proj(f, w, b)
        want = ea.kv_proj_plain(f, w, b)
        torch.cuda.synchronize()
        assert got.shape == (1000, n) and got.is_contiguous() and torch.equal(got, again)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


def _gt_interface(graph, channels, compute_dtype, device):
    from anemoi_models_tpu_torch.data_indices import IndexCollection
    from anemoi_models_tpu_torch.interface import AnemoiModelInterface
    from anemoi_models_tpu_torch.utils import DotDict

    mapper = {"trainable_size": 4, "num_heads": 4, "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
    cfg = DotDict({
        "data": {"forcing": ["lsm"], "diagnostic": ["tp"], "processors": {}},
        "graph": {"data": "data", "hidden": "hidden"},
        "training": {"multistep_input": 2},
        "model": {
            "num_channels": channels, "compute_dtype": compute_dtype, "trainable_parameters": {"hidden": 8},
            "model": {"_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"},
            "encoder": {"_target_": "anemoi.models.layers.mapper.GraphTransformerForwardMapper", **mapper},
            "processor": {"_target_": "anemoi.models.layers.processor.GraphTransformerProcessor",
                          "num_layers": 2, "num_chunks": 2, **mapper},
            "decoder": {"_target_": "anemoi.models.layers.mapper.GraphTransformerBackwardMapper", **mapper},
        },
    })
    di = IndexCollection(cfg, {"lsm": 0, "z_500": 1, "t_850": 2, "t2m": 3, "tp": 4})
    iface = AnemoiModelInterface(config=cfg, graph_data=graph, statistics={}, data_indices=di, device="cpu")
    gen = torch.Generator().manual_seed(14)
    iface.init_params(gen)
    with torch.no_grad():
        for p in iface.model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return iface.to(device)


@pytest.mark.parametrize("channels", [36, 100])
def test_bf16_graph_transformer_off_16_byte_rows_matches_cpu(dev, graph, channels):
    """A bf16 GraphTransformer at C = 36 and 100 (4 heads of 9 and 25
    channels, padded in the kernels) on the card, forward and every
    parameter's gradient after one backward, against the CPU's fp32 run of
    the same weights, normwise 2e-2; kv_proj and both attention kernels
    launched. The same model in fp32 on the card holds every gradient to
    the CPU's at the backward's normwise 1e-4."""
    from anemoi_models_tpu_torch.training import weighted_mse

    cpu = _gt_interface(graph, channels, "float32", "cpu")
    card = _gt_interface(graph, channels, "bfloat16", dev)
    gen = torch.Generator().manual_seed(15)
    x = torch.randn(1, 2, 1, graph["data"].num_nodes, 4, generator=gen)
    y = torch.randn(1, 1, graph["data"].num_nodes, 4, generator=gen)
    ref = cpu.forward(x)
    before = dict(ea.LAUNCHES)
    out = card.forward(x.to(dev)).float().cpu()
    assert {k: ea.LAUNCHES[k] - before[k] for k in before} == {"kv_proj": 4, "edge_attn_csr": 4, "edge_attn_csr_bwd": 0}
    assert _normwise(out, ref) <= TOL[torch.bfloat16]
    weighted_mse(cpu.model(x), y).backward()
    before = ea.LAUNCHES["edge_attn_csr_bwd"]
    weighted_mse(card.model(x.to(dev)), y.to(dev)).backward()
    torch.cuda.synchronize()
    assert ea.LAUNCHES["edge_attn_csr_bwd"] == before + 4
    card_fp32 = _gt_interface(graph, channels, "float32", dev)
    weighted_mse(card_fp32.model(x.to(dev)), y.to(dev)).backward()
    torch.cuda.synchronize()
    assert ea.LAUNCHES["edge_attn_csr_bwd"] == before + 8
    grads = dict(card.model.named_parameters())
    grads_fp32 = dict(card_fp32.model.named_parameters())
    for name, p in cpu.model.named_parameters():
        assert _normwise(grads[name].grad.float().cpu(), p.grad) <= TOL[torch.bfloat16], name
        assert _normwise(grads_fp32[name].grad.cpu(), p.grad) <= BWD_TOL, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,heads", [(256, 4), (192, 6), (1024, 16), (64, 4)])
@pytest.mark.parametrize("a2", [17, 24, 32, 33, 48, 64])
def test_edge_attention_takes_more_than_16_attributes(dev, graph, dtype, channels, heads, a2):
    """Both kernels with 16 to 63 edge attributes (A2 = 17 to 64 with the
    ones column: the factored edge term streams them in chunks, so no count
    is refused) against the plain versions, batch 2, two calls
    bit-identical; the backward at every width and dtype, C = 1024 in fp32
    among them."""
    rowptr, src, num_edges, ns, nd, _ = _bwd_edge_set(graph, "data-hidden", dev)
    csr_t = _csr_t(rowptr, src, ns)
    gen = torch.Generator().manual_seed(16)
    batch = 2
    q = torch.randn(batch * nd, channels, generator=gen).to(dev, dtype)
    kv = torch.randn(batch * ns, 2 * channels, generator=gen).to(dev, dtype)
    a = torch.randn(num_edges, a2, generator=gen).to(dev, dtype)
    w_aug = (torch.randn(a2, channels, generator=gen) * 0.3).to(dev, dtype)
    g_num = torch.randn(batch * nd, channels, generator=gen).to(dev)
    g_den = torch.randn(batch * nd, heads, generator=gen).to(dev)
    got, again = (ea.edge_attn_csr(q, kv, rowptr, src, a, w_aug, heads) for _ in range(2))
    want = ea.edge_attn_csr_plain(q, kv, rowptr, src, a, w_aug, heads)
    torch.cuda.synchronize()
    for g, g2, w in zip(got, again, want):
        torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])
        assert torch.equal(g, g2), "two forward calls differ"
    args = (q, kv, rowptr, src, a, w_aug, got.m, g_num, g_den, heads)
    bgot, bagain = (ea.edge_attn_csr_bwd(*args, csr_t) for _ in range(2))
    bwant = ea.edge_attn_csr_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, g2, w in zip(("dq", "dkv", "da", "dw_aug"), bgot, bagain, bwant):
        assert torch.equal(g, g2), f"{name} differs between two calls"
        assert _normwise(g, w) <= BWD_TOL, f"{name}: normwise error {_normwise(g, w):.3e}"


# ---------------------------------------------------------------------------
# the backward kernels: gnn_conv_bwd and flash_attention_bwd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,extra,activation", [(32, 0, "SiLU"), (256, 0, "SiLU"), (40, 1, "GELU"),
                                                       (36, 0, "Mish"), (1024, 0, "SiLU"), (64, 0, "ReLU"),
                                                       (128, 1, "Tanh"), (256, -1, "GELU"), (384, 0, "SiLU"),
                                                       (64, -1, "ELU")])
@pytest.mark.parametrize("edges,batch", [("hidden-hidden", 1), ("data-hidden", 2), ("hidden-data", 1)])
def test_gnn_conv_bwd_matches_plain_and_repeats_bit_for_bit(dev, graph, dtype, channels, extra, activation, edges,
                                                             batch):
    """gnn_conv_bwd against gnn_conv_bwd_plain (every gradient, fp32 1e-4 and
    bf16 2e-2 normwise: both round at the same points from fp32 sums taken in
    another order), two calls bit-identical, one launch a call: in bf16 the
    fused chain at C = 32, 64, 128 and 256 (2, 3 and 4 Dense) and the layered
    chain at C = 36 (padded), 40, 384 and 1024."""
    _gnn_bwd_case(dev, graph, dtype, channels, extra, activation, edges, batch)


@pytest.mark.parametrize("channels", [64, 40])
@pytest.mark.parametrize("activation", ["identity", "SiLU", "GELU", "ReLU", "Tanh", "Sigmoid", "LeakyReLU", "ELU",
                                        "Softplus", "Mish"])
def test_gnn_conv_bwd_every_activation(dev, graph, channels, activation):
    """Every activation code through the bf16 backward's two chains (C = 64
    the fused one, C = 40 the layered one) against gnn_conv_bwd_plain."""
    assert gc._bwd_route(channels, 3, torch.bfloat16) == ("fused" if channels == 64 else "layered")
    _gnn_bwd_case(dev, graph, torch.bfloat16, channels, 0, activation, "hidden-hidden", 1)


def _gnn_bwd_case(dev, graph, dtype, channels, extra, activation, edges, batch):
    s_name, d_name = edges.split("-")
    es = graph[(s_name, "to", d_name)]
    ns, nd = graph[s_name].num_nodes, graph[d_name].num_nodes
    rowptr, src, num_edges = _csr(es, ns, nd, dev)
    gen = torch.Generator().manual_seed(channels + extra)
    x_dst = torch.randn(batch, nd, channels, generator=gen).to(dev, dtype)
    x_src = x_dst if s_name == d_name else torch.randn(batch, ns, channels, generator=gen).to(dev, dtype)
    e = torch.randn(batch, num_edges, channels, generator=gen).to(dev, dtype)
    dense = [(torch.randn(channels, k, generator=gen) * k ** -0.5, 0.1 * torch.randn(channels, generator=gen))
             for k in (3 * channels,) + (channels,) * (2 + extra)]
    norm = (1 + 0.1 * torch.randn(channels, generator=gen), 0.1 * torch.randn(channels, generator=gen))
    ops = gc.mlp_operands([(w.to(dev), b.to(dev)) for w, b in dense], tuple(t.to(dev) for t in norm), dtype)
    g_agg = torch.randn(batch, nd, channels, generator=gen).to(dev)
    g_msg = torch.randn(batch, num_edges, channels, generator=gen).to(dev, dtype)
    args = (x_dst, x_src, e, rowptr, src, ops, activation, g_agg, g_msg)
    before = gc.LAUNCHES["gnn_conv_bwd"]
    got = gc.gnn_conv_bwd(*args, _csr_t(rowptr, src, ns))
    again = gc.gnn_conv_bwd(*args)  # the transposed CSR built by the wrapper
    assert gc.LAUNCHES["gnn_conv_bwd"] == before + 2
    want = gc.gnn_conv_bwd_plain(*args)
    tol = BWD_TOL if dtype == torch.float32 else TOL[dtype]
    for g, g2, w in zip([*got[:3], *got[3]], [*again[:3], *again[3]], [*want[:3], *want[3]]):
        assert torch.equal(g, g2), "two calls differ"
        assert torch.isfinite(g).all() and _normwise(g, w) <= tol


FLASH_BWD = {  # keyword arguments of the attention, query rows, key rows (from a 700-row sequence)
    "window": (dict(window_size=64), (0, 700), (0, 700)),
    "no window": (dict(window_size=None), (0, 333), (0, 333)),
    "causal": (dict(window_size=40, is_causal=True), (0, 700), (0, 700)),
    "dropout": (dict(window_size=64, dropout_rate=0.1, dropout_key=fa.fold_key(5, 1)), (0, 700), (0, 700)),
    "halo rows": (dict(window_size=64, n_valid=700), (350, 700), (286, 700)),
    "gathered causal rows": (dict(window_size=None, is_causal=True, n_valid=700), (350, 700), (0, 700)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 24, 96, 256])
@pytest.mark.parametrize("case", list(FLASH_BWD))
def test_flash_attention_bwd_matches_plain(dev, dtype, head_dim, case):
    """flash_attention_bwd against flash_attention_bwd_plain from the
    forward kernel's row log-sum-exp (fp32 1e-4, bf16 2e-2 normwise), two
    calls bit-identical; the forward's output the same bits with the row
    statistics and without."""
    kw, (q0, q1), (k0, k1) = FLASH_BWD[case]
    kw = dict(kw, q_offset=q0, k_offset=k0)
    gen = torch.Generator().manual_seed(head_dim)
    qkv = torch.randn(1, 700, 3, 2, head_dim, generator=gen).to(dev, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    q, k, v = q[:, :, q0:q1], k[:, :, k0:k1], v[:, :, k0:k1]
    g = torch.randn(1, 2, q1 - q0, head_dim, generator=gen).to(dev, dtype)
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
    _, lse_want = fa.blockwise_attention(q, k, v, **kw, return_lse=True)
    finite = torch.isfinite(lse_want)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(lse[finite], lse_want[finite], atol=BWD_TOL, rtol=BWD_TOL)
    before = fa.LAUNCHES["flash_attention_bwd"]
    got, again = (fa.flash_attention_bwd(q, k, v, out, g, lse, **kw) for _ in range(2))
    assert fa.LAUNCHES["flash_attention_bwd"] == before + 2
    want = fa.flash_attention_bwd_plain(q, k, v, out, g, lse, **kw)
    tol = BWD_TOL if dtype == torch.float32 else TOL[dtype]
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b), "two calls differ"
        assert torch.isfinite(a).all() and _normwise(a, w) <= tol


@pytest.mark.parametrize("flavor", ["gnn", "transformer"])
def test_backward_functions_run_the_kernels(dev, graph, flavor, monkeypatch):
    """GNNConv's and FlashAttention's backwards on CUDA tensors launch their
    kernels and never reach a plain version: the plain versions raise here."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA backward reached a plain version")

    for mod, name in ((gc, "gnn_conv_plain"), (gc, "gnn_conv_bwd_plain"), (fa, "blockwise_attention"),
                      (fa, "flash_attention_bwd_plain")):
        monkeypatch.setattr(mod, name, refuse)
    gen = torch.Generator().manual_seed(3)
    if flavor == "gnn":
        es = graph[("hidden", "to", "hidden")]
        n = graph["hidden"].num_nodes
        rowptr, src, num_edges = _csr(es, n, n, dev)
        x = torch.randn(1, n, 64, generator=gen).to(dev).requires_grad_()
        e = torch.randn(1, num_edges, 64, generator=gen).to(dev).requires_grad_()
        params = [(torch.randn(64, k, generator=gen) * k ** -0.5).to(dev).requires_grad_() if i % 2 == 0
                  else torch.zeros(64, device=dev, requires_grad=True) for i, k in enumerate((192, 192, 64, 64, 64, 64))]
        params += [torch.ones(64, device=dev, requires_grad=True), torch.zeros(64, device=dev, requires_grad=True)]
        before = gc.LAUNCHES["gnn_conv_bwd"]
        agg, msg = gc.GNNConv.apply(x, x, e, rowptr, src, _csr_t(rowptr, src, n), "SiLU", *params)
        (agg.sum() + (msg * msg).sum()).backward()
        assert gc.LAUNCHES["gnn_conv_bwd"] == before + 1
        leaves = [x, e, *params]
    else:
        q, k, v = (torch.randn(1, 2, 300, 32, generator=gen).to(dev).requires_grad_() for _ in range(3))
        before = fa.LAUNCHES["flash_attention_bwd"]
        fa.FlashAttention.apply(q, k, v, 40, False).square().sum().backward()
        assert fa.LAUNCHES["flash_attention_bwd"] == before + 1
        leaves = [q, k, v]
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
