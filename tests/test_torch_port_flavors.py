"""PyTorch port, the GNN and Transformer flavors against the JAX package on
the CPU: the plain versions of the GNN conv and band-masked attention kernels
against the Pallas kernels in interpret mode and their plain twins, the
gradients of the two autograd Functions, and each flavor's whole model
(forward, every parameter's gradient, ``predict_step`` and the flax weight
round trip).

Inputs come from numpy seeds and reach both frameworks as numpy arrays.
Sizes are those of the port's other tests (``grid_lat=6, mesh_refinements=2``,
``make_config(flavor)``, C=16, 2 processor layers). Tolerances follow the
reference's tests: outputs 2e-5 (``tests/layers/test_commuted.py``), fp32
gradients 5e-4 (the same file's gradient checks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config, make_statistics
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)
from jax.experimental.pallas import tpu as pltpu

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.graphs.kernel_plan import build_edge_kernel_plan
from anemoi_models_tpu.interface import AnemoiModelInterface as JaxInterface
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu.ops.pallas import flash_attention as jfa
from anemoi_models_tpu.ops.pallas.gnn_conv import slot_gnn_pallas
from anemoi_models_tpu.ops.slot_gnn import planned_gnn_conv, to_slot_edges
from anemoi_models_tpu.training import weighted_mse as jax_weighted_mse
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec
from anemoi_models_tpu_torch.ops import flash_attention as fa
from anemoi_models_tpu_torch.ops import gnn_conv as gc
from anemoi_models_tpu_torch.ops.edge_attention import csr_from_edge_index
from anemoi_models_tpu_torch.training import weighted_mse
from anemoi_models_tpu_torch.weights import init_params, load_flax_params, to_flax_params

C = 16
OUT = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)
FLAVORS = ("gnn", "transformer")


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the GNN conv (kernel #5)
# ---------------------------------------------------------------------------


def _mlp_tree(rng, widths):
    tree = {f"Dense_{i}": {"kernel": (rng.randn(a, b) * 0.3).astype(np.float32),
                           "bias": (rng.randn(b) * 0.1).astype(np.float32)}
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}
    ln = {"scale": (1 + 0.1 * rng.randn(C)).astype(np.float32), "bias": (0.1 * rng.randn(C)).astype(np.float32)}
    return {**tree, "AutocastLayerNorm_0": {"LayerNorm_0": ln}}


def _port_params(tree):
    """GNNConv's parameters (torch Linear layout) from a flax MLP tree."""
    n = sum(k.startswith("Dense_") for k in tree)
    params = [torch.tensor(tree[f"Dense_{i}"][k].T if k == "kernel" else tree[f"Dense_{i}"][k], requires_grad=True)
              for i in range(n) for k in ("kernel", "bias")]
    ln = tree["AutocastLayerNorm_0"]["LayerNorm_0"]
    return params + [torch.tensor(ln["scale"], requires_grad=True), torch.tensor(ln["bias"], requires_grad=True)]


@pytest.fixture(scope="module")
def gnn_case(graph):
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    plan = build_edge_kernel_plan(es.edge_index, n, n, block_nodes=32, cap=32, slab_width=168)
    assert len(plan.outlier_src) == 0 and np.all(plan.slot_of_edge >= 0)
    rng = np.random.RandomState(20)
    x = rng.randn(1, n, C).astype(np.float32)
    e = rng.randn(1, es.num_edges, C).astype(np.float32)
    g_agg, g_msg = rng.randn(1, n, C).astype(np.float32), rng.randn(1, es.num_edges, C).astype(np.float32)
    rowptr, src = (torch.from_numpy(t) for t in csr_from_edge_index(es.edge_index, n, n))
    return dict(plan=plan, x=x, e=e, tree=_mlp_tree(rng, [3 * C, C, C, C]), rowptr=rowptr, src=src,
                g_agg=g_agg, g_msg=g_msg)


def _port_gnn(case, params, x, e):
    return gc.GNNConv.apply(x, x, e, case["rowptr"], case["src"], "SiLU", *params)


@pytest.mark.parametrize("twin", ["pallas-interpret", "reference"])
def test_gnn_conv_plain_matches_jax(gnn_case, twin):
    """agg and msg (fp32) of the plain version against the Pallas kernel in
    interpret mode and against planned_gnn_conv's reference twin; msg maps
    from the slot layout back to edge order."""
    case, plan = gnn_case, gnn_case["plan"]
    x, e = jnp.asarray(case["x"]), jnp.asarray(case["e"])
    w = jax.tree_util.tree_map(jnp.asarray, case["tree"])
    if twin == "pallas-interpret":
        agg_ref, slots = slot_gnn_pallas(x[0], to_slot_edges(e[0], plan).slots, w, plan, "SiLU", interpret=True)
        agg_ref, slots = agg_ref[None], slots[None]
    else:
        agg_ref, edges = planned_gnn_conv(x, e, w, plan, "SiLU", impl="reference")
        slots = edges.slots
    msg_ref = np.asarray(slots)[:, plan.slot_of_edge]
    with torch.no_grad():
        agg, msg = _port_gnn(case, _port_params(case["tree"]), torch.from_numpy(case["x"]),
                             torch.from_numpy(case["e"]))
    np.testing.assert_allclose(agg.numpy(), np.asarray(agg_ref), **OUT)
    np.testing.assert_allclose(msg.numpy(), msg_ref, **OUT)


def test_gnn_conv_grads_match_jax(gnn_case):
    """Gradients of GNNConv (its backward recomputes through the plain
    version) against jax.grad of planned_gnn_conv: x, e and every MLP
    parameter, with cotangents on both agg and msg."""
    case, plan = gnn_case, gnn_case["plan"]

    def loss(x, e, w):
        agg, edges = planned_gnn_conv(x, e, w, plan, "SiLU", impl="reference")
        msg = edges.slots[:, plan.slot_of_edge]
        return (agg * case["g_agg"]).sum() + (msg * case["g_msg"]).sum()

    w = jax.tree_util.tree_map(jnp.asarray, case["tree"])
    gx, ge, gw = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(case["x"]), jnp.asarray(case["e"]), w)
    x, e = (torch.tensor(case[k], requires_grad=True) for k in ("x", "e"))
    params = _port_params(case["tree"])
    agg, msg = _port_gnn(case, params, x, e)
    ((agg * torch.from_numpy(case["g_agg"])).sum() + (msg * torch.from_numpy(case["g_msg"])).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), err_msg="x", **GRAD)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), err_msg="e", **GRAD)
    want = _port_params(jax.tree_util.tree_map(np.asarray, gw))
    for i, (p, ref) in enumerate(zip(params, want)):
        np.testing.assert_allclose(p.grad.numpy(), ref.detach().numpy(), err_msg=f"param {i}", **GRAD)


# ---------------------------------------------------------------------------
# band-masked attention (kernel #6)
# ---------------------------------------------------------------------------

ATTN_CASES = {  # (n, window, causal)
    "windowed": (96, 16, False),
    "full": (64, None, False),
    "causal": (80, 16, True),
    "ragged": (100, 8, False),
}


def _qkv(n, seed, d=32, h=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, h, n, d).astype(np.float32) for _ in range(4)]  # q, k, v, cotangent


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blockwise_plain_matches_jax(case):
    """The plain version (default block 512, and 32 for several blocks)
    against the Pallas kernel in interpret mode and the JAX blockwise twin."""
    n, window, causal = ATTN_CASES[case]
    q, k, v, _ = _qkv(n, seed=21)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jax.jit(lambda *a: jfa._flash_forward(*a, window, causal, 32))(jq, jk, jv))
    twin = np.asarray(jax.jit(lambda *a: jfa.blockwise_attention(
        *a, window_size=window, is_causal=causal, block_size=32))(jq, jk, jv))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for blk in (512, 32):
        got = fa.blockwise_attention(tq, tk, tv, window_size=window, is_causal=causal, block_size=blk).numpy()
        np.testing.assert_allclose(got, kernel, err_msg=f"vs kernel, block {blk}", **OUT)
        np.testing.assert_allclose(got, twin, err_msg=f"vs twin, block {blk}", **OUT)
    assert fa.live_pairs(n, window, causal) == int(
        sum(((abs(i - j) <= (window if window is not None else n)) and (not causal or j <= i))
            for i in range(n) for j in range(n)))


@pytest.mark.parametrize("case", ["windowed", "causal"])
def test_flash_attention_grads_match_jax(case):
    """FlashAttention's gradients (recomputed through the plain version)
    against jax.grad of the JAX custom_vjp flash_attention, whose forward
    runs the Pallas kernel in interpret mode."""
    n, window, causal = ATTN_CASES[case]
    q, k, v, g = _qkv(n, seed=22)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(lambda *a: (jfa.flash_attention(*a, window, causal, 32) * g).sum(),
                                argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    (fa.FlashAttention.apply(*leaves, window, causal) * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, **GRAD)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flavor_setup(graph):
    out = {}
    for i, flavor in enumerate(FLAVORS):
        cfg = make_config(flavor)
        di = IndexCollection(cfg, dict(VARS))
        jmodel = JaxModel(model_config=cfg, data_indices=di, graph_data=graph)
        rng = np.random.RandomState(30 + i)
        x = rng.randn(1, 2, 1, graph["data"].num_nodes, len(di.internal_model.input)).astype(np.float32)
        y = rng.randn(1, 1, graph["data"].num_nodes, len(di.internal_model.output)).astype(np.float32)
        # the JAX tree's layout, traced without compiling; the values come from
        # the port's seeded init, perturbed (zero-init trainables carry no signal)
        shapes = jax.eval_shape(jmodel.init, jax.random.key(i), jnp.asarray(x))
        layout = {"/".join(str(k.key) for k in path): v.shape
                  for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        model = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph, device="cpu")
        init_params(model, torch.Generator().manual_seed(i))
        params = jax.tree_util.tree_map(lambda a: a + 0.02 * rng.randn(*a.shape).astype(np.float32),
                                        to_flax_params(model.state_dict()))
        def loss(p, x=x, y=y, jmodel=jmodel):
            pred = jmodel.apply(p, jnp.asarray(x))
            return jax_weighted_mse(pred, jnp.asarray(y)), pred

        (loss_ref, pred), grads_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[flavor] = dict(cfg=cfg, di=di, x=x, y=y, params=params, layout=layout, pred=np.asarray(pred),
                           loss_ref=float(loss_ref), grads_ref=_flat(grads_ref))
    return out


def _port_model(s, graph):
    model = AnemoiModelEncProcDec(model_config=s["cfg"].to_dict(), data_indices=s["di"], graph_data=graph,
                                  device="cpu")
    model.load_state_dict(load_flax_params(s["params"]), strict=True)
    return model


@pytest.mark.parametrize("flavor", FLAVORS)
def test_flavor_forward_and_grads_match_jax(graph, flavor_setup, flavor):
    """Whole-model forward (2e-5) and every parameter's gradient of the MSE
    loss (5e-4) against the JAX model, leaf by leaf through to_flax_params."""
    s = flavor_setup[flavor]
    model = _port_model(s, graph)
    out = model(torch.from_numpy(s["x"]))
    np.testing.assert_allclose(out.detach().numpy(), s["pred"], **OUT)
    loss = weighted_mse(out, torch.from_numpy(s["y"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), s["loss_ref"], **OUT)
    got = _flat(to_flax_params({k: p.grad for k, p in model.named_parameters()}))
    assert got.keys() == s["grads_ref"].keys()
    for name, want in s["grads_ref"].items():
        np.testing.assert_allclose(got[name], want, err_msg=name, **GRAD)


@pytest.mark.parametrize("flavor", FLAVORS)
def test_flavor_predict_step_and_round_trip(graph, flavor_setup, flavor):
    """predict_step against the JAX interface, the exact flax round trip,
    and the port's parameter tree laid out as the JAX model's."""
    s = flavor_setup[flavor]
    stats = make_statistics()
    n_in = len(s["di"].data.input.full)
    batch = (stats["mean"][:n_in] + stats["stdev"][:n_in]
             * np.random.RandomState(32).randn(1, 3, s["x"].shape[3], n_in)).astype(np.float32)
    ref = np.asarray(JaxInterface(config=s["cfg"], graph_data=graph, statistics=stats, data_indices=s["di"])
                     .make_predict_fn()(s["params"], jnp.asarray(batch)))
    iface = AnemoiModelInterface(config=s["cfg"], graph_data=graph, statistics=stats, data_indices=s["di"],
                                 device="cpu")
    iface.load_params(s["params"])
    out = iface.predict_step(torch.from_numpy(batch)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **OUT)

    flat = _flat(s["params"])
    back = _flat(to_flax_params(iface.model.state_dict()))
    assert back.keys() == flat.keys()
    for name in flat:
        np.testing.assert_array_equal(back[name], flat[name], err_msg=name)
    assert {k: v.shape for k, v in flat.items()} == s["layout"]
