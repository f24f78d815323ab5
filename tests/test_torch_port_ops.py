"""PyTorch port, ops: the plain versions of the Hopper kernels, the partials
contract and the segment ops, against the JAX package on the CPU.

Inputs are made from numpy seeds and handed to both frameworks. Where the JAX
function reaches the Pallas feats kernel it runs as the JAX tests run it on
the CPU: through its plain reference (``impl="reference"``) or in interpret
mode. Tolerance: fp32 ``atol = rtol = 2e-5``, the forward bound of
``tests/layers/test_commuted.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch import one_torch_thread  # noqa: F401 (autouse)
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.graphs.kernel_plan import build_edge_kernel_plan
from anemoi_models_tpu.layers.conv import graph_transformer_conv as jax_conv
from anemoi_models_tpu.ops import segment as jseg
from anemoi_models_tpu.ops import slot_attention as jsa
from anemoi_models_tpu.ops.pallas.edge_attention import slot_attention_feats_pallas
from anemoi_models_tpu_torch.layers.conv import graph_transformer_conv
from anemoi_models_tpu_torch.ops import edge_attention as ea
from anemoi_models_tpu_torch.ops import segment as tseg

H, D, F, A = 4, 8, 16, 5
C = H * D
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def hidden_edges():
    g = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    es = g[("hidden", "to", "hidden")]
    return es.edge_index, g["hidden"].num_nodes


def _inputs(num_nodes, num_edges, seed, batch=1):
    rng = np.random.RandomState(seed)
    return dict(
        q=rng.randn(batch, num_nodes, H, D).astype(np.float32),
        feats=rng.randn(batch, num_nodes, F).astype(np.float32),
        w_kv=(rng.randn(F, 2 * C) * 0.3).astype(np.float32),  # flax (in, out) layout
        b_kv=(rng.randn(2 * C) * 0.1).astype(np.float32),
        a=rng.randn(num_edges, A).astype(np.float32),
        w_e=(rng.randn(A, C) * 0.3).astype(np.float32),
        b_e=(rng.randn(C) * 0.1).astype(np.float32),
    )


def _port_conv(x, edge_index, num_dst):
    num_src = x["feats"].shape[1]
    rowptr, src = ea.csr_from_edge_index(edge_index, num_src, num_dst)
    t = torch.from_numpy
    out = graph_transformer_conv(
        t(x["q"]), t(x["feats"]), t(x["w_kv"]).t(), t(x["b_kv"]), t(x["a"]),
        t(x["w_e"]).t(), t(x["b_e"]), t(rowptr), t(src),
        ea.CSRTranspose(*map(t, ea.csr_transpose(rowptr, src, num_src))),
    )
    return out.numpy()


def _edge_transform(x):
    def transform(a):
        e = a @ x["w_e"] + x["b_e"]
        return e.reshape(*e.shape[:-1], H, D)

    return transform


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_proj_plain_matches_jax_projection(dtype):
    """The projection of ``slot_attention_feats_partials``: f32-accumulated,
    rounded to the compute dtype."""
    rng = np.random.RandomState(0)
    f = rng.randn(37, F).astype(np.float32)
    w = (rng.randn(F, 2 * C) * 0.3).astype(np.float32)
    b = (rng.randn(2 * C) * 0.1).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    fj, wj = jnp.asarray(f, jdt), jnp.asarray(w, jdt)
    ref = (jnp.einsum("nf,fc->nc", fj, wj, preferred_element_type=jnp.float32) + b).astype(jdt)
    tdt = getattr(torch, dtype)
    out = ea.kv_proj(torch.from_numpy(f).to(tdt), torch.from_numpy(w).t().contiguous().to(tdt), torch.from_numpy(b))
    assert out.dtype == tdt and out.shape == (37, 2 * C)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)  # one bf16 ulp at the rounding point
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_merge_and_finalize_partials_match_jax():
    rng = np.random.RandomState(1)
    n = 23

    def partials(seed_shift):
        num = rng.randn(n, H, D).astype(np.float32)
        den = rng.rand(n, H).astype(np.float32) + 0.5
        m = rng.randn(n, H).astype(np.float32) * 3
        dead = (np.arange(n) % (5 + seed_shift)) == 0  # no edge in this set
        num[dead], den[dead], m[dead] = 0.0, 0.0, -1e30
        return num, den, m

    p1, p2 = partials(0), partials(1)
    jm = jsa.merge_partials(jsa.AttentionPartials(*map(jnp.asarray, p1)),
                            jsa.AttentionPartials(*map(jnp.asarray, p2)))
    tm = ea.merge_partials(ea.AttentionPartials(*map(torch.from_numpy, p1)),
                           ea.AttentionPartials(*map(torch.from_numpy, p2)))
    for got, want in zip(tm, jm):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        ea.finalize_partials(tm, torch.float32).numpy(),
        np.asarray(jsa.finalize_partials(jm, jnp.float32)), **TOL,
    )


@pytest.mark.parametrize("op", ["segment_sum", "segment_max", "segment_softmax"])
def test_segment_ops_match_jax(op):
    rng = np.random.RandomState(2)
    ids = np.sort(rng.randint(0, 9, size=40)).astype(np.int32)  # some segments empty
    data = rng.randn(2, 40, 3).astype(np.float32)
    want = np.asarray(getattr(jseg, op)(jnp.asarray(data), jnp.asarray(ids), 11))
    got = getattr(tseg, op)(torch.from_numpy(data), torch.from_numpy(ids), 11).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_conv_matches_jax_planned_tables(hidden_edges):
    """Against the JAX processor conv through the kernel plan (slot partials
    and outlier partials merged), the path ``graph_impl="pallas"`` takes."""
    edge_index, n = hidden_edges
    x = _inputs(n, edge_index.shape[1], seed=3, batch=2)
    plan = build_edge_kernel_plan(edge_index, n, n, block_nodes=32, cap=8, slab_width=32)
    assert len(plan.outlier_src) > 0, "the plan must exercise the outlier merge"
    ref = jax_conv(
        jnp.asarray(x["q"]), jnp.asarray(x["feats"]), None, jnp.asarray(x["a"])[None],
        jnp.asarray(edge_index), n, jsa.PlannedTables(plan, impl="reference"),
        _edge_transform(x), commute_kv=(jnp.asarray(x["w_kv"]), jnp.asarray(x["b_kv"])),
    )
    np.testing.assert_allclose(_port_conv(x, edge_index, n), np.asarray(ref), **TOL)


def _segment_path_ref(x, edge_index, n):
    kv = x["feats"] @ x["w_kv"] + x["b_kv"]
    k, v = (t.reshape(*t.shape[:-1], H, D) for t in np.split(kv, 2, axis=-1))
    e = _edge_transform(x)(x["a"])[None]
    return np.asarray(jax_conv(
        jnp.asarray(x["q"]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(e), jnp.asarray(edge_index), n,
    ))


def test_conv_matches_jax_segment_path(hidden_edges):
    edge_index, n = hidden_edges
    x = _inputs(n, edge_index.shape[1], seed=4)
    np.testing.assert_allclose(_port_conv(x, edge_index, n), _segment_path_ref(x, edge_index, n), **TOL)


def test_conv_dead_destinations(hidden_edges):
    """Destinations without edges: partials hold m = -1e30, den = 0, num = 0,
    and the conv gives 0 there, as the JAX segment path does."""
    edge_index, n = hidden_edges
    keep = edge_index[1] % 5 != 2
    sub = edge_index[:, keep]
    x = _inputs(n, sub.shape[1], seed=5)
    out = _port_conv(x, sub, n)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, _segment_path_ref(x, sub, n), **TOL)
    dead = np.arange(n) % 5 == 2
    assert (out[0, dead] == 0).all()

    rowptr, src = ea.csr_from_edge_index(sub, n, n)
    kv = ea.kv_proj(torch.from_numpy(x["feats"][0]), torch.from_numpy(x["w_kv"]).t(), torch.from_numpy(x["b_kv"]))
    a = torch.cat([torch.from_numpy(x["a"]), torch.ones(sub.shape[1], 1)], dim=-1)
    w_aug = torch.from_numpy(np.concatenate([x["w_e"], x["b_e"][None]]))
    p = ea.edge_attn_csr(torch.from_numpy(x["q"][0]).reshape(n, C), kv, torch.from_numpy(rowptr),
                         torch.from_numpy(src), a, w_aug, H)
    assert (p.m[dead] == -1e30).all() and (p.den[dead] == 0).all() and (p.num[dead] == 0).all()


def test_partials_match_feats_kernel_interpret(hidden_edges):
    """The port's partials (num, den, m) against the Pallas feats kernel in
    interpret mode, on a plan that places every edge in a slot."""
    edge_index, n = hidden_edges
    x = _inputs(n, edge_index.shape[1], seed=6)
    plan = build_edge_kernel_plan(edge_index, n, n, block_nodes=32, cap=32, slab_width=168)
    assert len(plan.outlier_src) == 0
    a_aug = np.concatenate([x["a"], np.ones((edge_index.shape[1], 1), np.float32)], axis=-1)
    w_aug = np.concatenate([x["w_e"], x["b_e"][None]])
    ref = slot_attention_feats_pallas(
        jnp.asarray(x["q"][0]), jnp.asarray(x["feats"][0]), jnp.asarray(x["w_kv"]), jnp.asarray(x["b_kv"]),
        jsa._slot_attrs(jnp.asarray(a_aug[:, :-1]), plan), jnp.asarray(w_aug.reshape(A + 1, H, D)),
        plan, interpret=True,
    )
    rowptr, src = ea.csr_from_edge_index(edge_index, n, n)
    t = torch.from_numpy
    kv = ea.kv_proj(t(x["feats"][0]), t(x["w_kv"]).t().contiguous(), t(x["b_kv"]))
    got = ea.edge_attn_csr(t(x["q"][0]).reshape(n, C), kv, t(rowptr), t(src), t(a_aug), t(w_aug), H)
    for name, g, w in zip(("num", "den", "m"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    before = dict(ea.LAUNCHES)
    f = torch.randn(5, 4)
    w = torch.randn(6, 4)
    b = torch.randn(6)
    torch.testing.assert_close(ea.kv_proj(f, w, b), ea.kv_proj_plain(f, w, b), rtol=0, atol=0)
    assert ea.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        ea.kv_proj(f.to("meta"), w.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="sorted"):
        ea.csr_from_edge_index(np.array([[0, 1], [1, 0]]), 2, 2)
    with pytest.raises(ValueError, match="source ids"):
        ea.csr_from_edge_index(np.array([[0, 2], [0, 1]]), 2, 2)
