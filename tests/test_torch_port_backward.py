"""PyTorch port, the backward kernels' plain versions: ``gnn_conv_bwd_plain``
(the GNN conv's explicit backward) and ``flash_attention_bwd_plain`` (band-
masked attention's, from the forward's row log-sum-exp), held against
autograd of their plain forwards and against the JAX package's vjp.

On the card ``GNNConv`` and ``FlashAttention`` run ``csrc/gnn_conv_bwd.cu``
and ``csrc/flash_attention_bwd.cu`` (held to these twins by
``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``); here they run the
twins. Sizes: the oracle graph (``grid_lat=6, mesh_refinements=2``), a few
heads of 8 channels. Tolerances: fp32 normwise 1e-5 against autograd (the
same function, summed in another order); 5e-4 against JAX
(``tests/layers/test_commuted.py:64``); bf16 normwise 2e-2 against autograd,
whose graph rounds each cotangent to bf16 where it passes a cast of the
forward (the twins round at the kernels' points instead: the gradient of a
Dense's output and the dropped weights and dS before their products), so the
two land a few bf16 steps apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.layers.conv import GraphConv as JaxGraphConv
from anemoi_models_tpu.ops.pallas import flash_attention as jfa
from anemoi_models_tpu_torch.ops import cost
from anemoi_models_tpu_torch.ops import edge_attention as ea
from anemoi_models_tpu_torch.ops import flash_attention as fa
from anemoi_models_tpu_torch.ops import gnn_conv as gc

JAX_TOL = dict(atol=5e-4, rtol=5e-4)
FP32_TOL = 1e-5
BF16_TOL = 2e-2

# (label, C, Dense layers, activation, edge set): the fused kernel's width and depth, and a padded layered one
GNN_CASES = {
    "fused C=32 SiLU": (32, 3, "SiLU", ("hidden", "hidden")),
    "layered C=40 GELU": (40, 4, "GELU", ("data", "hidden")),
}
# (label, keyword arguments of the attention, query rows, key rows)
FLASH_CASES = {
    "band": (dict(window_size=5), 40, 40),
    "causal": (dict(window_size=6, is_causal=True), 40, 40),
    "dropout": (dict(window_size=5, dropout_rate=0.1, dropout_key=fa.fold_key(7, 3, 1)), 40, 40),
    # a rank's 20 rows at global 20.. against keys at global 14..43 of a 40-row sequence
    "offsets": (dict(window_size=6, q_offset=20, k_offset=14, n_valid=40), 20, 30),
}


def normwise(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)


def _gnn_inputs(graph, case: str, seed: int = 0) -> dict:
    c, n_dense, act, (s_name, d_name) = GNN_CASES[case]
    ei = graph[(s_name, "to", d_name)].edge_index
    ns, nd = graph[s_name].num_nodes, graph[d_name].num_nodes
    rng = np.random.RandomState(seed)
    widths = [3 * c] + [c] * n_dense
    tree = {f"Dense_{i}": {"kernel": (rng.randn(a, b) * a ** -0.5).astype(np.float32),
                           "bias": (rng.randn(b) * 0.1).astype(np.float32)}
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}
    tree["AutocastLayerNorm_0"] = {"LayerNorm_0": {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                                                   "bias": (0.1 * rng.randn(c)).astype(np.float32)}}
    x_dst = rng.randn(1, nd, c).astype(np.float32)
    x_src = x_dst if s_name == d_name else rng.randn(1, ns, c).astype(np.float32)
    rowptr, src = (torch.from_numpy(t) for t in ea.csr_from_edge_index(ei, ns, nd))
    return dict(c=c, act=act, ei=ei, tree=tree, x_dst=x_dst, x_src=x_src, rowptr=rowptr, src=src,
                e=rng.randn(1, ei.shape[1], c).astype(np.float32),
                g_agg=rng.randn(1, nd, c).astype(np.float32), g_msg=rng.randn(1, ei.shape[1], c).astype(np.float32))


def _port_params(tree) -> list[torch.Tensor]:
    n = sum(k.startswith("Dense_") for k in tree)
    dense = [torch.tensor(tree[f"Dense_{i}"][k].T if k == "kernel" else tree[f"Dense_{i}"][k])
             for i in range(n) for k in ("kernel", "bias")]
    ln = tree["AutocastLayerNorm_0"]["LayerNorm_0"]
    return dense + [torch.tensor(ln["scale"]), torch.tensor(ln["bias"])]


def _gnn_twin(inp: dict, dt: torch.dtype):
    params = _port_params(inp["tree"])
    return gc.gnn_conv_bwd_plain(
        *(torch.from_numpy(inp[k]).to(dt) for k in ("x_dst", "x_src", "e")), inp["rowptr"], inp["src"],
        gc.mlp_operands([(params[i], params[i + 1]) for i in range(0, len(params) - 2, 2)], tuple(params[-2:]), dt),
        inp["act"], torch.from_numpy(inp["g_agg"]), torch.from_numpy(inp["g_msg"]).to(dt))


@pytest.mark.parametrize("case", list(GNN_CASES))
def test_gnn_bwd_plain_matches_autograd(graph, case):
    """Every gradient of the explicit backward against torch.autograd of
    gnn_conv_plain, in fp32 (1e-5) and bf16 (2e-2), cotangents on agg and msg."""
    inp = _gnn_inputs(graph, case)
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        leaves = [torch.from_numpy(inp[k]).clone().requires_grad_() for k in ("x_dst", "x_src", "e")]
        params = [p.clone().requires_grad_() for p in _port_params(inp["tree"])]
        ops = gc._operands(params, dt)
        agg, msg = gc.gnn_conv_plain(*(t.to(dt) for t in leaves), inp["rowptr"], inp["src"], ops, inp["act"])
        want = torch.autograd.grad((agg, msg), leaves + params,
                                   (torch.from_numpy(inp["g_agg"]), torch.from_numpy(inp["g_msg"]).to(dt)))
        dx_dst, dx_src, de, dops = _gnn_twin(inp, dt)
        for name, got, ref in zip(["x_dst", "x_src", "e"] + [f"param {i}" for i in range(len(dops))],
                                  [dx_dst, dx_src, de, *dops], want):
            assert normwise(got, ref) <= tol, (case, dt, name, normwise(got, ref))


@pytest.mark.parametrize("case", list(GNN_CASES))
def test_gnn_bwd_plain_matches_jax_vjp(graph, case):
    """fp32 gradients of the explicit backward against jax.vjp of the JAX
    GraphConv's segment path (gathers, the flax MLP, segment_sum)."""
    inp = _gnn_inputs(graph, case, seed=1)
    c, n_dense = GNN_CASES[case][:2]
    conv = JaxGraphConv(out_channels=c, mlp_extra_layers=n_dense - 3, activation=inp["act"])
    self_graph = inp["x_src"] is inp["x_dst"]

    def fwd(x_src, x_dst, e, tree):
        return conv.apply({"params": {"MLP_0": tree}}, x_dst if self_graph else (x_src, x_dst), e,
                          jnp.asarray(inp["ei"]))

    @jax.jit
    def grads(*primals):
        return jax.vjp(fwd, *primals)[1]((jnp.asarray(inp["g_agg"]), jnp.asarray(inp["g_msg"])))

    gx_src, gx_dst, ge, gtree = grads(jnp.asarray(inp["x_src"]), jnp.asarray(inp["x_dst"]), jnp.asarray(inp["e"]),
                                      jax.tree_util.tree_map(jnp.asarray, inp["tree"]))
    dx_dst, dx_src, de, dops = _gnn_twin(inp, torch.float32)
    if self_graph:  # the same node rows feed both ends
        dx_dst = dx_dst + dx_src
    else:
        np.testing.assert_allclose(dx_src.numpy(), np.asarray(gx_src), err_msg="x_src", **JAX_TOL)
    np.testing.assert_allclose(dx_dst.numpy(), np.asarray(gx_dst), err_msg="x_dst", **JAX_TOL)
    np.testing.assert_allclose(de.numpy(), np.asarray(ge), err_msg="e", **JAX_TOL)
    want = _port_params(jax.tree_util.tree_map(np.asarray, gtree))
    for i, (got, ref) in enumerate(zip(dops, want)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), err_msg=f"param {i}", **JAX_TOL)


def _flash_inputs(case: str, dt: torch.dtype, seed: int = 2):
    kw, nq, nk = FLASH_CASES[case]
    rng = np.random.RandomState(seed)
    q, g = (torch.from_numpy(rng.randn(1, 2, nq, 8).astype(np.float32)).to(dt) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, 2, nk, 8).astype(np.float32)).to(dt) for _ in range(2))
    return kw, q, k, v, g


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_bwd_plain_matches_autograd(case):
    """dq, dk, dv of the explicit backward (from the forward's log-sum-exp,
    at two block sizes) against torch.autograd of blockwise_attention, fp32
    (1e-5) and bf16 (2e-2); with dropout both see the forward's mask."""
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        kw, q, k, v, g = _flash_inputs(case, dt)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        ref = fa.blockwise_attention(*(t.to(dt) for t in leaves), block_size=16, **kw)
        want = torch.autograd.grad(ref, leaves, g)
        out, lse = fa.blockwise_attention(q, k, v, return_lse=True, **kw)
        assert torch.equal(out, ref.detach()), "the row statistics changed the output"
        for block in (512, 16):
            got = fa.flash_attention_bwd_plain(q, k, v, out, g, lse, block_size=block, **kw)
            for name, a, b in zip("qkv", got, want):
                assert normwise(a, b) <= tol, (case, dt, block, name, normwise(a, b))


@pytest.mark.parametrize("case", ["band", "causal"])
def test_flash_bwd_plain_matches_jax_vjp(case):
    """fp32 dq, dk, dv against jax.vjp of the JAX package's blockwise_attention."""
    kw, q, k, v, g = _flash_inputs(case, torch.float32, seed=3)
    want = jax.jit(lambda *a: jax.vjp(lambda *p: jfa.blockwise_attention(*p, block_size=16, **kw), *a)[1](
        jnp.asarray(g.numpy())))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    out, lse = fa.blockwise_attention(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd_plain(q, k, v, out, g, lse, **kw)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **JAX_TOL)


def test_functions_run_the_twins_on_cpu(graph):
    """GNNConv and FlashAttention on CPU tensors: their backwards run the
    plain twins (the same gradients, bit for bit), launch nothing, and
    record each backward's FLOPs by the card route's formula."""
    inp = _gnn_inputs(graph, "fused C=32 SiLU", seed=4)
    before = {**gc.LAUNCHES, **fa.LAUNCHES}
    x, e = (torch.from_numpy(inp[k]).requires_grad_() for k in ("x_dst", "e"))
    params = [p.requires_grad_() for p in _port_params(inp["tree"])]
    with cost.FlopCount() as count:
        agg, msg = gc.GNNConv.apply(x, x, e, inp["rowptr"], inp["src"], inp["act"], *params)
        torch.autograd.backward((agg, msg), (torch.from_numpy(inp["g_agg"]), torch.from_numpy(inp["g_msg"])))
    nd, c = x.shape[1:]
    assert count.kernels["gnn_conv_bwd"] == (1, cost.gnn_conv_bwd_flops(1, e.shape[1], nd, nd, c, 3))
    assert count.kernels["gnn_conv_bwd"][1] == 3 * count.kernels["gnn_conv"][1]
    assert count.aten == 0, "the plain versions' products were counted as aten"
    dx_dst, dx_src, de, dops = _gnn_twin(inp, torch.float32)
    assert torch.equal(x.grad, dx_dst + dx_src) and torch.equal(e.grad, de)
    assert all(torch.equal(p.grad, d) for p, d in zip(params, dops))

    kw, q, k, v, g = _flash_inputs("offsets", torch.float32, seed=5)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    with cost.FlopCount() as count:
        out = fa.FlashAttention.apply(*leaves, kw["window_size"], False, 0.0, None, kw["q_offset"], kw["k_offset"],
                                      kw["n_valid"])
        out.backward(g)
    pairs = fa.live_pairs(q.shape[2], kw["window_size"], False, k.shape[2], kw["q_offset"], kw["k_offset"], kw["n_valid"])
    assert count.kernels["flash_attention_bwd"] == (1, cost.flash_bwd_flops(2, pairs, 8))
    assert count.aten == 0
    ref, lse = fa.blockwise_attention(q.detach(), k.detach(), v.detach(), return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), ref, g, lse, **kw)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    assert {**gc.LAUNCHES, **fa.LAUNCHES} == before, "a CPU call counted a kernel launch"


def test_gnn_bwd_route_follows_the_shape():
    """The card's choice of backward chain, a function of (C, Dense layers,
    dtype) alone: the fused chain in bf16 at C = 32, 64, 128, 256 where its
    z tiles fit the 227 KB a block may have (C = 256: up to three Dense; the
    smaller widths: up to four), the layered chain otherwise and in fp32;
    the fused chain's shared memory pinned at the flagship's shape."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert gc._chain_smem(256, 3) == 224312 <= gc._SMEM_LIMIT < gc._chain_smem(256, 4)
    assert gc._chain_smem(32, 2) == 22584 and gc._chain_smem(128, 4) == 171064
    for c in (32, 64, 128, 256):
        for n_dense in (2, 3, 4, 5):
            fits = n_dense <= (3 if c == 256 else 4)
            assert gc._bwd_route(c, n_dense, bf16) == ("fused" if fits else "layered"), (c, n_dense)
            assert gc._bwd_route(c, n_dense, f32) == "layered"
    for c in (8, 24, 36, 40, 48, 96, 100, 384, 512, 1024):
        assert gc._bwd_route(c, 3, bf16) == "layered", c
    with pytest.raises(ValueError):
        gc._bwd_route(64, 1, bf16)


def test_gnn_bwd_weight_gradient_split_follows_the_shape():
    """The K split of the weight gradients (about 128 CTAs over one launch's
    (C, C) tiles: every Dense of a chunk in bf16, one in fp32), at most one
    range per K step of the chunk, and pinned at the main path's shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    chunk = gc.LAYERED_CHUNK
    assert gc._dw_splits(256, chunk, bf16, 3) == 22  # 2 tiles a Dense (128 x 256)
    assert gc._dw_splits(1024, chunk, bf16, 3) == 2  # 32 tiles a Dense
    assert gc._dw_splits(40, chunk, bf16, 3) == 43  # 1 tile a Dense (128 x 128)
    assert gc._dw_splits(256, chunk, f32) == 8 and gc._dw_splits(1024, chunk, f32) == 1
    assert gc._dw_splits(256, 100, bf16, 3) == 2  # a 100-row chunk has two K steps of 64
    for c in (32, 40, 256, 384, 1024):
        for n in (2, 3, 4, 6):
            assert 1 <= gc._dw_splits(c, chunk, bf16, n) <= -(-chunk // 64)


def test_flash_bwd_widths_and_query_tiles_follow_the_shape():
    """The backward's head widths (the tile kernels' 16, 32, 64, 128 up to
    128, both dtypes; the row kernels' own width above) and the 64-query
    tiles whose dQ the bf16 kernel adds to in key-block order (a counter
    each, after the work counter)."""
    assert [fa._bwd_width(d) for d in (1, 16, 17, 24, 32, 48, 64, 96, 128, 129, 256, 1000)] == \
        [16, 16, 32, 32, 32, 64, 64, 128, 128, 129, 256, 1000]
    assert [fa._bwd_query_tiles(n) for n in (1, 64, 65, 700, 5121, 10242)] == [1, 1, 2, 11, 81, 161]
