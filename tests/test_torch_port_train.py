"""PyTorch port, train step: the edge-attention backward, the model's
gradients, the loss, the optimizer and the train step, against the JAX
package on the CPU.

Inputs come from numpy seeds and reach both frameworks as numpy arrays. Where
the JAX function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it on the CPU. Sizes are those of the port's model
tests (``grid_lat=6, mesh_refinements=2``, C=16, 2 processor layers).
Tolerances follow the reference's tests: outputs 2e-5
(``tests/layers/test_commuted.py``), fp32 gradients 5e-4 (the same file's
gradient checks), loss traces ``rtol=6e-4`` (``tests/parallel/test_fsdp.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from helpers_models import VARS, make_config
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.graphs.kernel_plan import build_edge_kernel_plan
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu.ops import slot_attention as jsa
from anemoi_models_tpu.ops.pallas.edge_attention import (
    slot_attention_feats_kernel,
    slot_attention_partials_kernel,
)
from anemoi_models_tpu.training import make_optimizer as jax_make_optimizer
from anemoi_models_tpu.training import make_train_step as jax_make_train_step
from anemoi_models_tpu.training import weighted_mse as jax_weighted_mse
from anemoi_models_tpu.training.step import TrainState
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec
from anemoi_models_tpu_torch.ops import edge_attention as ea
from anemoi_models_tpu_torch.training import (
    WeightedMSELoss,
    make_optimizer,
    make_train_step,
    warmup_cosine_decay_schedule,
    weighted_mse,
)
from anemoi_models_tpu_torch.weights import load_flax_params, to_flax_params

H, D, F, A = 4, 8, 16, 5
C = H * D
OUT = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)


@pytest.fixture(scope="module")
def hidden_edges(graph):
    return graph[("hidden", "to", "hidden")].edge_index, graph["hidden"].num_nodes


def _inputs(num_nodes, num_edges, seed, batch=1):
    rng = np.random.RandomState(seed)
    return dict(
        q=rng.randn(batch * num_nodes, C).astype(np.float32),
        feats=rng.randn(num_nodes, F).astype(np.float32),
        w_kv=(rng.randn(F, 2 * C) * 0.3).astype(np.float32),  # flax (in, out) layout
        b_kv=(rng.randn(2 * C) * 0.1).astype(np.float32),
        a=rng.randn(num_edges, A).astype(np.float32),
        w_aug=(rng.randn(A + 1, C) * 0.3).astype(np.float32),  # bias as the last row
        g=rng.randn(batch * num_nodes, C).astype(np.float32),  # output cotangent
    )


def _leaves(x, names):
    return [torch.tensor(x[n], requires_grad=True) for n in names]


def _csr_t(rowptr, src, num_src):
    return ea.CSRTranspose(*(torch.from_numpy(t) for t in ea.csr_transpose(rowptr, src, num_src)))


def _port_attention(q, kv, a_raw, w_aug, rowptr, src):
    """Port partials -> finalized output (N, C), through the Functions."""
    a = torch.cat([a_raw, torch.ones(a_raw.shape[0], 1)], dim=-1)
    num, den, m = ea.EdgeAttnCSR.apply(
        q, kv, a, w_aug, torch.from_numpy(rowptr), torch.from_numpy(src), H, _csr_t(rowptr, src, kv.shape[0])
    )
    return ea.finalize_partials(ea.AttentionPartials(num, den, m), torch.float32).reshape(q.shape)


def _no_outlier_plan(edge_index, n):
    plan = build_edge_kernel_plan(edge_index, n, n, block_nodes=32, cap=32, slab_width=168)
    assert len(plan.outlier_src) == 0
    return plan


def _assert_grads(got, want, names, tol=GRAD):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **tol)


def test_feats_grads_match_pallas_feats_kernel_interpret(hidden_edges):
    """q, feats, w_kv, b_kv, the raw per-edge attributes and w_aug through
    KVProj + EdgeAttnCSR against jax.grad of the Pallas feats kernel (forward
    and hand-written backward) in interpret mode."""
    edge_index, n = hidden_edges
    x = _inputs(n, edge_index.shape[1], seed=10)
    plan = _no_outlier_plan(edge_index, n)

    def jax_loss(q, feats, w_kv, b_kv, a, w_aug):
        p = slot_attention_feats_kernel(
            q.reshape(n, H, D), feats, w_kv, b_kv, jsa._slot_attrs(a, plan), w_aug.reshape(A + 1, H, D),
            plan, True,
        )
        return (jsa.finalize_partials(p, jnp.float32).reshape(n, C) * x["g"]).sum()

    names = ("q", "feats", "w_kv", "b_kv", "a", "w_aug")
    want = jax.grad(jax_loss, argnums=tuple(range(6)))(*(jnp.asarray(x[k]) for k in names))
    q, feats, w_kv, b_kv, a, w_aug = _leaves(x, names)
    rowptr, src = ea.csr_from_edge_index(edge_index, n, n)
    kv = ea.KVProj.apply(feats, w_kv.t(), b_kv)
    out = _port_attention(q, kv, a, w_aug, rowptr, src)
    (out * torch.from_numpy(x["g"])).sum().backward()
    got = [q.grad, feats.grad, w_kv.grad, b_kv.grad, a.grad, w_aug.grad]
    _assert_grads(got, want, names)


def test_partials_and_grads_match_pallas_partials_kernel_interpret(hidden_edges):
    """On a per-node [k|v], the port's edge_attn_csr and its backward compute
    the function of the JAX package's k/v kernel (#3, forward) and its
    backward kernel (#4): values and gradients, in interpret mode."""
    edge_index, n = hidden_edges
    x = _inputs(n, edge_index.shape[1], seed=11)
    rng = np.random.RandomState(12)
    x["k"], x["v"] = rng.randn(n, C).astype(np.float32), rng.randn(n, C).astype(np.float32)
    plan = _no_outlier_plan(edge_index, n)

    def jax_partials(q, k, v, a, w_aug):
        return slot_attention_partials_kernel(
            q.reshape(n, H, D), k.reshape(n, H, D), v.reshape(n, H, D), jsa._slot_attrs(a, plan),
            w_aug.reshape(A + 1, H, D), plan, True,
        )

    names = ("q", "k", "v", "a", "w_aug")
    jargs = [jnp.asarray(x[k]) for k in names]
    ref = jax_partials(*jargs)
    want = jax.grad(
        lambda *args: (jsa.finalize_partials(jax_partials(*args), jnp.float32).reshape(n, C) * x["g"]).sum(),
        argnums=tuple(range(5)),
    )(*jargs)

    q, k, v, a, w_aug = _leaves(x, names)
    rowptr, src = ea.csr_from_edge_index(edge_index, n, n)
    a1 = torch.cat([a, torch.ones(a.shape[0], 1)], dim=-1)
    kv = torch.cat([k, v], dim=-1)
    num, den, m = ea.EdgeAttnCSR.apply(
        q, kv, a1, w_aug, torch.from_numpy(rowptr), torch.from_numpy(src), H, _csr_t(rowptr, src, n)
    )
    for name, got_, want_ in zip(("num", "den", "m"), (num, den, m), ref):
        np.testing.assert_allclose(got_.detach().numpy(), np.asarray(want_), err_msg=name, **OUT)
    out = ea.finalize_partials(ea.AttentionPartials(num, den, m), torch.float32).reshape(n, C)
    (out * torch.from_numpy(x["g"])).sum().backward()
    _assert_grads([q.grad, k.grad, v.grad, a.grad, w_aug.grad], want, names)


@pytest.mark.parametrize("edges", [("hidden", "hidden"), ("data", "hidden"), ("hidden", "data")])
def test_bwd_plain_matches_autograd_of_plain_forward(graph, edges):
    """Two independent derivations: the backward's formula in segment ops
    against torch.autograd through edge_attn_csr_plain + finalize_partials,
    batch 2, with destinations that have no edge."""
    es = graph[(edges[0], "to", edges[1])]
    ns, nd = graph[edges[0]].num_nodes, graph[edges[1]].num_nodes
    ei = es.edge_index[:, es.edge_index[1] % 5 != 2]
    rowptr, src = (torch.from_numpy(t) for t in ea.csr_from_edge_index(ei, ns, nd))
    rng = np.random.RandomState(13)
    t = lambda *shape, s=1.0: torch.tensor(rng.randn(*shape).astype(np.float32) * s, requires_grad=True)  # noqa: E731
    q, kv, a, w_aug = t(2 * nd, C), t(2 * ns, 2 * C), t(ei.shape[1], A + 1), t(A + 1, C, s=0.3)
    g = torch.from_numpy(rng.randn(2 * nd, C).astype(np.float32))
    p = ea.edge_attn_csr_plain(q, kv, rowptr, src, a, w_aug, H)
    out = ea.finalize_partials(p, torch.float32).reshape(2 * nd, C)
    want = torch.autograd.grad((out * g).sum(), (q, kv, a, w_aug, p.num, p.den), retain_graph=True)
    got = ea.edge_attn_csr_bwd_plain(
        q.detach(), kv.detach(), rowptr, src, a.detach(), w_aug.detach(), p.m.detach(),
        want[4].reshape(2 * nd, C), want[5], H,
    )
    for name, gt, wt in zip(("dq", "dkv", "da", "dw_aug"), got, want[:4]):
        torch.testing.assert_close(gt, wt, **GRAD, msg=name)


def test_gauge_split_merge_gives_one_set_gradients(hidden_edges):
    """Splitting the edges into two CSR sets and merging the partials gives
    the gradients of one set: the m-cotangent the Function drops carries
    nothing under merge_partials + finalize_partials."""
    edge_index, n = hidden_edges
    x = _inputs(n, edge_index.shape[1], seed=14)
    half = np.random.RandomState(15).rand(edge_index.shape[1]) < 0.5
    names = ("q", "feats", "w_kv", "b_kv", "a", "w_aug")
    grads = []
    for split in (False, True):
        q, feats, w_kv, b_kv, a, w_aug = _leaves(x, names)
        kv = ea.KVProj.apply(feats, w_kv.t(), b_kv)
        a1 = torch.cat([a, torch.ones(a.shape[0], 1)], dim=-1)
        parts = []
        for mask in ([half, ~half] if split else [np.ones_like(half)]):
            rowptr, src = ea.csr_from_edge_index(edge_index[:, mask], n, n)
            num, den, m = ea.EdgeAttnCSR.apply(
                q, kv, a1[torch.from_numpy(mask)], w_aug, torch.from_numpy(rowptr), torch.from_numpy(src), H,
                _csr_t(rowptr, src, n),
            )
            parts.append(ea.AttentionPartials(num, den, m))
        p = ea.merge_partials(*parts) if split else parts[0]
        (ea.finalize_partials(p, torch.float32).reshape(n, C) * torch.from_numpy(x["g"])).sum().backward()
        grads.append([q.grad, feats.grad, w_kv.grad, b_kv.grad, a.grad, w_aug.grad])
    for name, g1, g2 in zip(names, *grads):
        torch.testing.assert_close(g2, g1, **GRAD, msg=name)


def test_dead_destinations_give_finite_zero_gradients(hidden_edges):
    edge_index, n = hidden_edges
    keep = edge_index[1] % 4 != 1
    x = _inputs(n, int(keep.sum()), seed=16)
    q, feats, w_kv, b_kv, a, w_aug = _leaves(x, ("q", "feats", "w_kv", "b_kv", "a", "w_aug"))
    rowptr, src = ea.csr_from_edge_index(edge_index[:, keep], n, n)
    out = _port_attention(q, ea.KVProj.apply(feats, w_kv.t(), b_kv), a, w_aug, rowptr, src)
    dead = torch.from_numpy(np.arange(n) % 4 == 1)
    assert bool((out[dead] == 0).all())
    (out * torch.from_numpy(x["g"])).sum().backward()
    for g in (q.grad, feats.grad, w_kv.grad, b_kv.grad, a.grad, w_aug.grad):
        assert bool(torch.isfinite(g).all())
    assert bool((q.grad[dead] == 0).all())


def test_csr_transpose_orders_edges_by_source():
    rng = np.random.RandomState(17)
    ns, nd = 7, 5
    dst = np.sort(rng.randint(0, nd, 30))
    ei = np.stack([rng.randint(0, ns - 1, 30), dst])  # source 6 has no edge
    rowptr, src = ea.csr_from_edge_index(ei, ns, nd)
    perm, colptr, dst_t, pos = ea.csr_transpose(rowptr, src, ns)
    assert perm.dtype == colptr.dtype == dst_t.dtype == pos.dtype == np.int32
    np.testing.assert_array_equal(dst_t, ei[1])
    np.testing.assert_array_equal(perm[pos], np.arange(ei.shape[1]))  # pos inverts perm
    np.testing.assert_array_equal(pos[perm], np.arange(ei.shape[1]))
    np.testing.assert_array_equal(src[perm], np.sort(src, kind="stable"))
    np.testing.assert_array_equal(np.diff(colptr), np.bincount(src, minlength=ns))
    for s in range(ns):  # ascending edge ids within a source: a fixed summation order
        assert np.all(np.diff(perm[colptr[s]:colptr[s + 1]]) > 0)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_setup(graph):
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    n_grid = graph["data"].num_nodes
    rng = np.random.RandomState(0)
    x = rng.randn(1, 2, 1, n_grid, len(di.internal_model.input)).astype(np.float32)
    y = rng.randn(1, 1, n_grid, len(di.internal_model.output)).astype(np.float32)
    params = jax.jit(JaxModel(model_config=cfg, data_indices=di, graph_data=graph).init)(
        jax.random.key(0), jnp.asarray(x)
    )
    rng = np.random.RandomState(1)  # zero-init trainables carry no signal: perturb every parameter
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    return di, x, y, params


def _configs(graph_impl="pallas", remat_policy="full"):
    cfg = make_config("graphtransformer")
    cfg.model.processor.graph_impl = graph_impl
    cfg.model.processor.remat_policy = remat_policy
    return cfg


def _port_model(cfg, di, graph, params):
    model = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph, device="cpu")
    model.load_state_dict(load_flax_params(params), strict=True)
    return model


def _port_grads(model, x, y):
    model.zero_grad(set_to_none=True)
    loss = weighted_mse(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("graph_impl", ["pallas", "dense"])
def test_model_grads_match_jax(graph, model_setup, graph_impl):
    """Every parameter's gradient of the MSE loss against jax.grad of the JAX
    model, leaf by leaf through to_flax_params. The k-side bias has no
    gradient in the JAX commuted form (it is softmax-invariant and dropped);
    in the port its gradient is round-off, inside the absolute tolerance."""
    di, x, y, params = model_setup
    cfg = _configs(graph_impl)
    jmodel = JaxModel(model_config=cfg, data_indices=di, graph_data=graph)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jax_weighted_mse(jmodel.apply(p, jnp.asarray(x)), jnp.asarray(y))
    ))(params)
    loss, grads = _port_grads(_port_model(cfg, di, graph, params), x, y)
    np.testing.assert_allclose(loss, float(loss_ref), **OUT)
    want, got = _flat(grads_ref), _flat(to_flax_params(grads))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **GRAD)


def test_many_edge_attributes_match_jax(graph):
    """The GraphTransformer with A2 = 33 edge attributes in its mappers and
    64 in its processor (3 static, A2 - 4 trainable, the ones column; the
    card's kernels take them in the factored form): the forward (2e-5) and
    every parameter's gradient (5e-4) against the JAX model, through the
    plain versions."""
    cfg = make_config("graphtransformer")
    for part, a2 in (("encoder", 33), ("processor", 64), ("decoder", 33)):
        cfg.model[part].trainable_size = a2 - 4
    cfg.model.processor.graph_impl = "dense"
    di = IndexCollection(cfg, dict(VARS))
    n_grid = graph["data"].num_nodes
    rng = np.random.RandomState(33)
    x = rng.randn(1, 2, 1, n_grid, len(di.internal_model.input)).astype(np.float32)
    y = rng.randn(1, 1, n_grid, len(di.internal_model.output)).astype(np.float32)
    jmodel = JaxModel(model_config=cfg, data_indices=di, graph_data=graph)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)

    def loss_and_out(p):
        out = jmodel.apply(p, jnp.asarray(x))
        return jax_weighted_mse(out, jnp.asarray(y)), out

    (loss_ref, out_ref), grads_ref = jax.jit(jax.value_and_grad(loss_and_out, has_aux=True))(params)
    model = _port_model(cfg, di, graph, params)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), np.asarray(out_ref), **OUT)
    loss, grads = _port_grads(model, x, y)
    np.testing.assert_allclose(loss, float(loss_ref), **OUT)
    want, got = _flat(grads_ref), _flat(to_flax_params(grads))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **GRAD)


def test_remat_full_and_none_give_equal_gradients(graph, model_setup):
    """Every memory policy gives the same loss and gradients bit for bit:
    remat "full", "save_dots" and "none", and cpu_offload on every mapper
    and the processor."""
    di, x, y, params = model_setup
    cfgs = [_configs(remat_policy=p) for p in ("full", "save_dots", "none")]
    cfgs.append(_configs())
    for part in ("encoder", "processor", "decoder"):
        cfgs[-1].model[part].cpu_offload = True
    runs = [_port_grads(_port_model(cfg, di, graph, params), x, y) for cfg in cfgs]
    for run in runs[1:]:
        assert run[0] == runs[0][0]
        for name, g in runs[0][1].items():
            torch.testing.assert_close(run[1][name], g, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("clip_norm", [32.0, 0.05], ids=["no-clip", "clip"])
def test_train_trace_matches_jax(graph, model_setup, clip_norm):
    """Four steps of make_train_step + make_optimizer (warmup 2, so the first
    update has lr 0 and the others not) against the JAX package's: the loss
    trace and the final parameters. With clip_norm 0.05 every step clips."""
    di, x, y, params = model_setup
    cfg = _configs()
    opt_kw = dict(warmup_steps=2, total_steps=10, weight_decay=0.1, clip_norm=clip_norm)

    jmodel = JaxModel(model_config=cfg, data_indices=di, graph_data=graph)
    jopt = jax_make_optimizer(1e-3, **opt_kw)
    _, jstep = jax_make_train_step(jmodel, jopt)
    jstep = jax.jit(jstep)
    state = TrainState(params=params, opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    want = []
    for _ in range(4):
        state, loss = jstep(state, jnp.asarray(x), jnp.asarray(y))
        want.append(float(loss))

    model = _port_model(cfg, di, graph, params)
    opt = make_optimizer(model.parameters(), 1e-3, **opt_kw)
    step = make_train_step(model, opt)
    got = [step(torch.from_numpy(x), torch.from_numpy(y)).item() for _ in range(4)]
    assert opt.count == 4
    np.testing.assert_allclose(got, want, rtol=6e-4, atol=2e-5)
    assert want[-1] < want[1]  # the updates after warmup move the loss
    _, grads = _port_grads(model, x, y)
    final, final_ref = _flat(to_flax_params(model.state_dict())), _flat(state.params)
    if clip_norm < 1:
        assert float(optax.global_norm(jax.tree_util.tree_map(jnp.asarray, _flat(to_flax_params(grads))))) > clip_norm
    for name in final_ref:
        got_, want_ = final[name].copy(), final_ref[name].copy()
        k_cols = {"lin_kv/bias": slice(0, 16), "lin_qkvs/bias": slice(16, 32)}  # C = 16
        for suffix, cols in k_cols.items():
            if name.endswith(suffix):
                # the k-side bias: zero gradient in JAX, round-off in the port,
                # which Adam's normalisation turns into steps of up to lr each
                np.testing.assert_allclose(got_[cols], want_[cols], rtol=0, atol=3.5e-3, err_msg=name)
                got_[cols] = want_[cols] = 0.0
        np.testing.assert_allclose(got_, want_, err_msg=name, **GRAD)


@pytest.mark.parametrize("warmup,total,end_ratio", [(3, 12, 0.01), (0, 5, 0.1), (4, 4, 0.0)])
def test_lr_schedule_matches_optax(warmup, total, end_ratio):
    peak = 2e-3
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=peak, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=peak * end_ratio,
    )
    ours = warmup_cosine_decay_schedule(0.0, peak, warmup, max(total, warmup + 1), peak * end_ratio)
    for count in range(total + 4):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12, err_msg=str(count))


def test_weighted_mse_matches_jax():
    """fp32 upcast, weights, mask and the + 1e-12 of the JAX loss, also for a
    bf16 prediction."""
    rng = np.random.RandomState(18)
    pred, target = rng.randn(2, 1, 9, 4).astype(np.float32), rng.randn(2, 1, 9, 4).astype(np.float32)
    nw, vw = rng.rand(9).astype(np.float32), rng.rand(4).astype(np.float32)
    mask = (rng.rand(9, 4) > 0.2).astype(np.float32)
    for args in ((), (nw,), (nw, vw, mask), (None, vw)):
        jargs = [None if a is None else jnp.asarray(a) for a in args]
        targs = [None if a is None else torch.from_numpy(a) for a in args]
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = float(jax_weighted_mse(jnp.asarray(pred, jdt), jnp.asarray(target), *jargs))
            got = WeightedMSELoss(*targs)(torch.from_numpy(pred).to(tdt), torch.from_numpy(target))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), want, **OUT)


def test_flax_tree_round_trip_is_exact(model_setup):
    params = model_setup[3]
    back = _flat(to_flax_params(load_flax_params(params)))
    ref = _flat(params)
    assert back.keys() == ref.keys()
    for name in ref:
        np.testing.assert_array_equal(back[name], ref[name], err_msg=name)


def test_train_step_refuses_dropout(graph, model_setup):
    """A deterministic=False model refuses to roll out without a dropout
    key; its train step draws one from the step count, and a GraphTransformer
    model, which has no dropout layer, trains exactly as the deterministic
    one (attention dropout itself: tests/test_torch_port_crps_dropout.py)."""
    from anemoi_models_tpu_torch.training import make_rollout_fn

    di, x, y, params = model_setup
    cfg = _configs()
    losses = []
    for deterministic in (False, True):
        model = _port_model(cfg, di, graph, params)
        model.deterministic = deterministic
        if not deterministic:
            with pytest.raises(ValueError, match="dropout_key"):
                make_rollout_fn(model, di, 1)(torch.from_numpy(np.asarray(x)))
        step = make_train_step(model, make_optimizer(model.parameters()))
        losses.append([float(step(torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y))))
                       for _ in range(2)])
    assert losses[0] == losses[1]


def test_ema_update_matches_jax():
    from anemoi_models_tpu.training import ema_update as jax_ema_update
    from anemoi_models_tpu_torch.training import ema_update

    rng = np.random.RandomState(19)
    ema = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    want = jax_ema_update(ema, params, decay=0.9)
    got = ema_update({k: torch.from_numpy(v) for k, v in ema.items()},
                     {k: torch.from_numpy(v) for k, v in params.items()}, decay=0.9)
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **OUT)
