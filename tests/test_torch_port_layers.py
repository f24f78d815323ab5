"""PyTorch port, layers: LayerNorm, GELU, node attributes, the GraphTransformer
processor block and processor, and both mappers, against flax on the CPU.

Weights come from flax ``init`` (trainable tensors perturbed so they carry
signal) and reach the port through ``load_flax_params``. fp32,
``atol = rtol = 2e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch import one_torch_thread  # noqa: F401 (autouse)
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.layers import block as jblock
from anemoi_models_tpu.layers import graph as jgraph
from anemoi_models_tpu.layers import mapper as jmapper
from anemoi_models_tpu.layers import processor as jproc
from anemoi_models_tpu.layers import utils as jutils
from anemoi_models_tpu_torch.layers import block as tblock
from anemoi_models_tpu_torch.layers import graph as tgraph
from anemoi_models_tpu_torch.layers import mapper as tmapper
from anemoi_models_tpu_torch.layers import processor as tproc
from anemoi_models_tpu_torch.layers import utils as tutils
from anemoi_models_tpu_torch.ops.edge_attention import CSRTranspose, csr_from_edge_index, csr_transpose
from anemoi_models_tpu_torch.weights import load_flax_params

C, HEADS, TRAINABLE = 16, 4, 2
EDGE_ATTRS = ["edge_length", "edge_dirs"]
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)


def _perturbed(params, seed=1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), params
    )


def _load(module, params):
    module.load_state_dict(load_flax_params(params), strict=True)
    return module


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autocast_layer_norm_matches_flax(dtype):
    x = np.random.RandomState(0).randn(3, 7, C).astype(np.float32) * 3 + 1
    jdt = getattr(jnp, dtype)
    ln = jutils.AutocastLayerNorm()
    params = _perturbed(ln.init(jax.random.key(0), jnp.asarray(x, jdt)))
    ref = ln.apply(params, jnp.asarray(x, jdt))
    port = _load(tutils.AutocastLayerNorm(C), {"LayerNorm_0": params["params"]["LayerNorm_0"]})
    out = port(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(atol=3e-2, rtol=1e-2)  # bf16 output rounding
    np.testing.assert_allclose(out.float().numpy(), _np(ref.astype(jnp.float32)), **tol)
    assert port.eps == 1e-6


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 301).astype(np.float32)
    out = tutils.get_activation("GELU")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, _np(jutils.get_activation("GELU")(jnp.asarray(x))), **TOL)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(out - exact).max() > 1e-4  # torch's default (erf) would not match


def test_named_nodes_attributes_match_flax(graph):
    flax_mod = jgraph.NamedNodesAttributes(num_trainable_params=4, graph_data=graph)
    params = _perturbed(flax_mod.init(jax.random.key(0), "data", 2))
    state = load_flax_params({"node_attributes": params["params"]})
    port = tgraph.NamedNodesAttributes(4, graph)
    port.load_state_dict({k.removeprefix("node_attributes."): v for k, v in state.items()}, strict=True)
    for name in ("data", "hidden"):
        ref = flax_mod.apply(params, name, 2)
        np.testing.assert_allclose(port(name, 2).numpy(), _np(ref), **TOL)
    assert port.attr_ndims == {"data": 8, "hidden": 8}


def _edge_inputs(es, trainable, num_src, num_dst):
    static = es.attr_tensor(EDGE_ATTRS)
    attr = np.concatenate([static, trainable], axis=-1)
    rowptr, src = csr_from_edge_index(es.edge_index, num_src, num_dst)
    csr_t = CSRTranspose(*map(torch.from_numpy, csr_transpose(rowptr, src, num_src)))
    return attr, torch.from_numpy(rowptr), torch.from_numpy(src), csr_t


def test_processor_block_matches_flax(graph):
    """One block on the plain segment path of the JAX package (fused
    ``lin_qkvs``), against the port's block (split ``lin_qr`` / ``lin_kv``)."""
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    rng = np.random.RandomState(2)
    x = rng.randn(2, n, C).astype(np.float32)
    trainable = rng.randn(es.num_edges, TRAINABLE).astype(np.float32) * 0.1
    attr, rowptr, src, csr_t = _edge_inputs(es, trainable, n, n)
    blk = jblock.GraphTransformerProcessorBlock(
        in_channels=C, hidden_dim=4 * C, out_channels=C, num_heads=HEADS
    )
    edge_attr = jnp.broadcast_to(jnp.asarray(attr), (2, *attr.shape))
    args = (jnp.asarray(x), edge_attr, jnp.asarray(es.edge_index), n)
    params = _perturbed(blk.init(jax.random.key(0), *args))
    ref, _ = blk.apply(params, *args)
    port = _load(
        tblock.GraphTransformerProcessorBlock(C, 4 * C, C, attr.shape[1], num_heads=HEADS),
        params,
    )
    out = port(torch.from_numpy(x), torch.from_numpy(attr), rowptr, src, csr_t)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("graph_impl", ["pallas", "dense"])
def test_processor_matches_flax(graph, graph_impl):
    """Chunks, blocks and edge registration; JAX runs its kernel plan
    ("pallas", through the plain reference off-TPU) or its bucketed
    commuted path ("dense")."""
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    x = np.random.RandomState(3).randn(1, n, C).astype(np.float32)
    kw = dict(num_layers=2, num_channels=C, num_chunks=2, num_heads=HEADS, trainable_size=TRAINABLE,
              sub_graph=es, sub_graph_edge_attributes=EDGE_ATTRS, graph_impl=graph_impl)
    flax_mod = jproc.GraphTransformerProcessor(**kw)
    params = _perturbed(jax.jit(flax_mod.init)(jax.random.key(0), jnp.asarray(x)))
    ref = jax.jit(flax_mod.apply)(params, jnp.asarray(x))
    port = _load(tproc.GraphTransformerProcessor(src_grid_size=n, dst_grid_size=n, **kw), params)
    out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("kv_src_gather", ["auto", "wide"])
def test_forward_mapper_matches_flax(graph, kv_src_gather):
    """``auto`` is the JAX commuted dataflow (``emb_nodes_src`` under
    ``proc``); ``wide`` keeps it at the mapper level."""
    es = graph[("data", "to", "hidden")]
    nd, nh = graph["data"].num_nodes, graph["hidden"].num_nodes
    rng = np.random.RandomState(4)
    x_src = rng.randn(1, nd, 11).astype(np.float32)
    x_dst = rng.randn(1, nh, 8).astype(np.float32)
    kw = dict(in_channels_src=11, in_channels_dst=8, hidden_dim=C, trainable_size=TRAINABLE,
              num_heads=HEADS, sub_graph=es, sub_graph_edge_attributes=EDGE_ATTRS)
    flax_mod = jmapper.GraphTransformerForwardMapper(kv_src_gather=kv_src_gather, **kw)
    xs = (jnp.asarray(x_src), jnp.asarray(x_dst))
    params = _perturbed(jax.jit(flax_mod.init)(jax.random.key(0), xs))
    assert ("emb_nodes_src" in params["params"]["proc"]) == (kv_src_gather == "auto")
    ref_src, ref_dst = jax.jit(flax_mod.apply)(params, xs)
    port = _load(tmapper.GraphTransformerForwardMapper(src_grid_size=nd, dst_grid_size=nh, **kw), params)
    out_src, out_dst = port((torch.from_numpy(x_src), torch.from_numpy(x_dst)))
    np.testing.assert_array_equal(out_src.numpy(), x_src)
    np.testing.assert_allclose(out_dst.numpy(), _np(ref_dst), **TOL)


def test_backward_mapper_matches_flax(graph):
    es = graph[("hidden", "to", "data")]
    nd, nh = graph["data"].num_nodes, graph["hidden"].num_nodes
    rng = np.random.RandomState(5)
    x_src = rng.randn(1, nh, C).astype(np.float32)
    x_dst = rng.randn(1, nd, 11).astype(np.float32)
    kw = dict(in_channels_src=C, in_channels_dst=11, hidden_dim=C, out_channels_dst=4,
              trainable_size=TRAINABLE, num_heads=HEADS, sub_graph=es,
              sub_graph_edge_attributes=EDGE_ATTRS)
    flax_mod = jmapper.GraphTransformerBackwardMapper(**kw)
    xs = (jnp.asarray(x_src), jnp.asarray(x_dst))
    params = _perturbed(jax.jit(flax_mod.init)(jax.random.key(0), xs))
    ref = jax.jit(flax_mod.apply)(params, xs)
    port = _load(tmapper.GraphTransformerBackwardMapper(src_grid_size=nh, dst_grid_size=nd, **kw), params)
    out = port((torch.from_numpy(x_src), torch.from_numpy(x_dst)))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("edges", [("hidden", "hidden"), ("data", "hidden"), ("hidden", "data")])
def test_edge_buffers_carry_the_inverse_of_perm(graph, edges):
    """The transposed CSR a layer registers for the attention backward:
    ``pos_t`` inverts ``perm_t`` (the backward writes each edge's (dl, w) at
    its position in the source-sorted list) and ``dst_t[perm_t]`` runs source
    by source, in ascending edge order within a source."""
    es = graph[(edges[0], "to", edges[1])]
    ns, nd = graph[edges[0]].num_nodes, graph[edges[1]].num_nodes
    module = torch.nn.Module()
    tproc.register_edge_buffers(module, es, EDGE_ATTRS, TRAINABLE, ns, nd, "pallas", "cpu")
    perm, colptr, dst, pos = (t.numpy() for t in tproc.edge_csr_t(module))
    e = np.arange(es.edge_index.shape[1])
    np.testing.assert_array_equal(perm[pos], e)
    np.testing.assert_array_equal(pos[perm], e)
    src = module.src.numpy()
    for s in range(ns):
        edge_ids = perm[colptr[s]:colptr[s + 1]]
        assert np.all(src[edge_ids] == s) and np.all(np.diff(edge_ids) > 0)
    np.testing.assert_array_equal(dst, es.edge_index[1])
