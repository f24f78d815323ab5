"""PyTorch port, model parallelism on ``torch.distributed`` against the JAX
package on the CPU.

The ranks are processes spawned with ``torch.multiprocessing`` (spawn mode)
and joined in a gloo process group (``helpers_parallel``); each module
fixture spawns once and runs every check of its grid in the ranks, and the
parametrised tests below assert each case on what the ranks returned. The
JAX side runs in this process on the 8-device CPU mesh of
``tests/conftest.py``, with the same numpy-seeded inputs and its flax
parameters carried into the port by ``weights.load_flax_params``.

Sizes are those of ``__graft_entry__.py:dryrun_multichip``: ``grid_lat=8,
mesh_refinements=1`` (42 hidden nodes), C = 16, 2 processor layers, a
window of 8. The hierarchical model is ``tests/parallel/test_sharding.py``'s
(``grid_lat=6, mesh_refinements=2, num_levels=2``, C = 8, level processors
of 2 layers), held to the JAX model's single-device forward, gradients,
AdamW step and rollout. Tolerances: the JAX gate's for a sharded forward against the
unsharded one (``__graft_entry__.py:251-253``: atol 5e-4, rtol 1e-3) and
its rollout loss (rtol 5e-5, ``:308-311``); the port's sharded forward
against its own unsharded one at 2e-5, gradients and the layers' backward at
the reference's fp32 gradient tolerance 5e-4 (``tests/layers/test_commuted.py``);
the primitives at 1e-6. Parameters after one AdamW step at lr 1e-4 are held
to the port's unsharded step at 5e-4; against the JAX package the update
itself (after - before, about the learning rate) is held at lr / 20, so a
skipped or mis-scaled update fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config
from helpers_parallel import (
    NON_HALO_ATTENTION,
    PRIM_COLS,
    PRIM_ROWS,
    PRIMITIVES,
    hier_source,
    layers_task,
    model_task,
    primitive_inputs,
    primitives_task,
    spawn,
    tasks,
)
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu import native
from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build as jax_build
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.graphs import partition as jpart
from anemoi_models_tpu.layers.processor import HaloGNNProcessor as JaxHaloGNNProcessor
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu.models import AnemoiModelEncProcDecHierarchical as JaxHierarchical
from anemoi_models_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
from anemoi_models_tpu.ops.ring_attention import halo_window_attention as jax_halo_window_attention
from anemoi_models_tpu.training.loss import weighted_mse as jax_weighted_mse
from anemoi_models_tpu.parallel import make_mesh as jax_make_mesh
from anemoi_models_tpu.parallel import use_mesh as jax_use_mesh
from anemoi_models_tpu.parallel.halo_conv import halo_graph_conv as jax_halo_graph_conv
from anemoi_models_tpu.parallel.halo_conv import halo_graph_transformer_conv as jax_halo_gt_conv
from anemoi_models_tpu.parallel.halo_conv import shard_edge_values as jax_shard_edge_values
from anemoi_models_tpu.training import make_rollout_fn as jax_make_rollout_fn
from anemoi_models_tpu_torch.checkpoint import save_checkpoint
from anemoi_models_tpu_torch.data_indices import IndexCollection as PortIndexCollection
from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph as port_build_graph
from anemoi_models_tpu_torch.graphs import build_hierarchical_graph as port_build_hierarchical_graph
from anemoi_models_tpu_torch.graphs import partition as ppart
from anemoi_models_tpu_torch.layers.processor import HaloGNNProcessor
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec, AnemoiModelEncProcDecHierarchical
from anemoi_models_tpu_torch.ops.edge_attention import csr_from_edge_index
from anemoi_models_tpu_torch.ops.flash_attention import blockwise_attention
from anemoi_models_tpu_torch.ops.gnn_conv import GNNConv
from anemoi_models_tpu_torch.parallel import row_range
from anemoi_models_tpu_torch.training import AdamW, WeightedMSELoss, make_train_step, train_run
from anemoi_models_tpu_torch.weights import load_flax_params, to_flax_params

GRAPH = dict(grid_lat=8, mesh_refinements=1)
HIER_GRAPH = dict(grid_lat=6, mesh_refinements=2, num_levels=2)  # tests/parallel/test_sharding.py:99
# the hierarchical model's train_run: 2 steps on hier_source, under (1, 2) against unsharded
HIER_RUN = dict(architecture="hierarchical", mesh_refinements=2, num_hidden_levels=2, steps=2, batch_size=2,
                log_every=1, forcing=("var_0",), peak_lr=5e-3, warmup_steps=1, seed=2,
                model_kwargs=dict(num_channels=8, num_layers=2, num_heads=2, num_chunks=1, trainable_hidden=2,
                                  trainable_edges=2, compute_dtype="float32"))
C = 16
FLAVORS = ("graphtransformer", "gnn", "transformer")
MESHES = {"model2": (1, 2), "data2_model2": (2, 2)}
GATE = dict(atol=5e-4, rtol=1e-3)  # __graft_entry__.py:251-253
OUT = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)
LR = 1e-4
WINDOW = 8


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfg(flavor):
    cfg = make_config(flavor, num_channels=C)
    if flavor == "transformer":  # the JAX layer's default, which selects the halo path under a mesh
        cfg.model.processor.attention_impl = "auto"
    return cfg


def _run_once(fn, *args):
    """``fn(*args)`` jitted at XLA's lowest backend optimisation level: the
    references are run once, and their compiles cost more than their runs."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _jax_step(jmodel, params, x, y, node_weights):
    """The JAX model's single-device forward and train step: the output, the
    weighted MSE loss, its gradients and the parameters after one AdamW step
    at LR (the port's ``AdamW(..., lambda count: LR, clip_norm=32.0)``: optax's
    clip_by_global_norm, then adamw's first step from zero moments, p - LR g
    / (|g| + 1e-8), written out in numpy), as flat {path: array} dicts."""

    def loss_of(p):
        out = jmodel.apply(p, jnp.asarray(x))
        return jax_weighted_mse(out, jnp.asarray(y), jnp.asarray(node_weights)), out

    (loss, out), grads = _run_once(jax.value_and_grad(loss_of, has_aux=True), params)
    grads, flat = _flat(grads), _flat(params)
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in grads.values()))
    scale = 32.0 / norm if norm >= 32.0 else 1.0
    stepped = {k: flat[k] - LR * (scale * g) / (np.abs(scale * g) + 1e-8) for k, g in grads.items()}
    return np.asarray(out), float(loss), grads, stepped, flat


def _assert_update(after: dict, before: dict, stepped: dict, grads: dict) -> None:
    """A rank's parameters after one AdamW step (flat, JAX names) against the
    JAX step's: the update after - before at LR / 20. AdamW's first step
    moves a parameter by about LR sign(g), so where JAX's gradient is within
    the gradient tolerance of 0 its sign is not fixed by the gradients'
    check, and there the update is only held to at most LR."""
    assert after.keys() == stepped.keys()
    for name, want in stepped.items():
        got, want = after[name] - before[name], want - before[name]
        sure = np.abs(grads[name]) > GRAD["atol"]
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=LR / 20, err_msg=f"update {name}")
        assert np.all(np.abs(got) <= LR * 1.001), f"update {name} larger than the learning rate"


def _jax_params(model) -> dict:
    """A port model's initial parameters as the JAX package's tree, perturbed
    (no JAX init to compile)."""
    rng = np.random.RandomState(12)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32),
                                  to_flax_params(model.state_dict()))


def _jax_rollout_loss(jmodel, di, params, inputs) -> float:
    forcing = np.asarray(di.internal_model.input.forcing)
    x = jnp.asarray(inputs["x"])
    _, preds = _run_once(jax_make_rollout_fn(jmodel, di, 2), params, x, jnp.asarray(inputs["truth"][..., forcing]))
    return float(jnp.mean((preds.astype(jnp.float32) - inputs["targets"]) ** 2))


def _inputs(rng, n_grid, n_in, n_out) -> dict:
    return dict(
        x=rng.randn(2, 2, 1, n_grid, n_in).astype(np.float32),
        y=rng.randn(2, 1, n_grid, n_out).astype(np.float32),
        truth=rng.randn(2, 2, 1, n_grid, n_in).astype(np.float32),
        targets=(0.1 * rng.randn(2, 2, 1, n_grid, n_out)).astype(np.float32),
        node_weights=(0.5 + rng.rand(n_grid)).astype(np.float32),
    )


def _port_flat(named: dict) -> dict:
    """A rank's {port name: array} as the JAX package's flat tree."""
    return _flat(to_flax_params({k: torch.from_numpy(np.asarray(v)) for k, v in named.items()}))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jgraph = build_enc_proc_dec_graph(**GRAPH)
    pgraph = port_build_graph(**GRAPH)
    n_grid = jgraph["data"].num_nodes
    rng = np.random.RandomState(11)
    out = {"jgraph": jgraph, "pgraph": pgraph, "flavors": {}}
    inputs = None
    for flavor in FLAVORS:
        cfg = _cfg(flavor)
        di = IndexCollection(cfg, dict(VARS))
        n_in, n_out = len(di.internal_model.input), len(di.internal_model.output)
        if inputs is None:
            inputs = _inputs(rng, n_grid, n_in, n_out)
        jmodel = JaxModel(model_config=cfg, data_indices=di, graph_data=jgraph)
        params = _run_once(jmodel.init, jax.random.key(0), jnp.asarray(inputs["x"]))
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
        forward = np.asarray(_run_once(jmodel.apply, params, jnp.asarray(inputs["x"])))
        rollout_loss = _jax_rollout_loss(jmodel, di, params, inputs)
        state = load_flax_params(params)
        ckpt = save_checkpoint(str(tmp_path_factory.mktemp(f"ckpt_{flavor}")), params=state, config=cfg.to_dict())
        # the port's unsharded references: the forward and one train step on the whole batch
        pdi = PortIndexCollection(cfg.to_dict(), dict(VARS))
        model = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=pdi, graph_data=pgraph, device="cpu")
        model.load_state_dict(state, strict=True)
        with torch.no_grad():
            port_forward = model(torch.from_numpy(inputs["x"])).numpy()
        opt = AdamW(model.parameters(), lambda count: LR, clip_norm=32.0)
        loss = float(make_train_step(model, opt, WeightedMSELoss(torch.from_numpy(inputs["node_weights"])))(
            torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["y"])))
        out["flavors"][flavor] = dict(
            cfg=cfg.to_dict(), checkpoint=ckpt, jax_forward=forward, jax_rollout_loss=rollout_loss,
            port_forward=port_forward, port_loss=loss,
            port_grads={k: p.grad.numpy().copy() for k, p in model.named_parameters()},
            port_params={k: p.detach().numpy().copy() for k, p in model.named_parameters()},
        )
    out["inputs"] = inputs
    return out


@pytest.fixture(scope="module")
def global_attention(setup, tmp_path_factory):
    """The Transformer flavor whose attention the halo path does not take
    (no window: every rank's queries against the gathered keys), the JAX
    model's single-device forward and train step. The JAX Transformer
    processor has no causal mask (its block passes is_causal=False), so a
    model cannot run one; the causal attention is held at the layer."""
    cfg = make_config("transformer", num_channels=C)
    cfg.model.processor.window_size = None
    cfg.model.processor.attention_impl = "chunked"
    di = IndexCollection(cfg, dict(VARS))
    inputs = setup["inputs"]
    jmodel = JaxModel(model_config=cfg, data_indices=di, graph_data=setup["jgraph"])
    torch.manual_seed(1)
    params = _jax_params(AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=PortIndexCollection(
        cfg.to_dict(), dict(VARS)), graph_data=setup["pgraph"], device="cpu"))
    forward, loss, grads, stepped, before = _jax_step(jmodel, params, inputs["x"], inputs["y"], inputs["node_weights"])
    ckpt = save_checkpoint(str(tmp_path_factory.mktemp("ckpt_global")), params=load_flax_params(params),
                           config=cfg.to_dict())
    return dict(cfg=cfg.to_dict(), checkpoint=ckpt, jax_forward=forward, jax_loss=loss, jax_grads=grads,
                jax_params=stepped, jax_before=before)


def _jax_hier_graph():
    saved = native._lib
    native._lib = lambda: None  # the numpy code path, as the port's builder (test_torch_port_hierarchical.py)
    try:
        return jax_build.build_hierarchical_graph(**HIER_GRAPH)
    finally:
        native._lib = saved


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    """The hierarchical model (tests/parallel/test_sharding.py:99's), the JAX
    model's single-device forward, train step and 2-step rollout loss, and
    the port's unsharded train_run loss trace."""
    jgraph, names = _jax_hier_graph()
    pgraph, _ = port_build_hierarchical_graph(**HIER_GRAPH)
    cfg = make_config("graphtransformer", num_channels=8)
    cfg.graph.hidden = list(names)
    cfg.model.model._target_ = "anemoi.models.models.hierarchical.AnemoiModelEncProcDecHierarchical"
    cfg.model.enable_hierarchical_level_processing = True
    cfg.model.level_process_num_layers = 2
    di = IndexCollection(cfg, dict(VARS))
    n_grid = jgraph["data"].num_nodes
    inputs = _inputs(np.random.RandomState(31), n_grid, len(di.internal_model.input), len(di.internal_model.output))
    jmodel = JaxHierarchical(model_config=cfg, data_indices=di, graph_data=jgraph)
    torch.manual_seed(2)
    params = _jax_params(AnemoiModelEncProcDecHierarchical(model_config=cfg.to_dict(), data_indices=PortIndexCollection(
        cfg.to_dict(), dict(VARS)), graph_data=pgraph, device="cpu"))
    forward, loss, grads, stepped, before = _jax_step(jmodel, params, inputs["x"], inputs["y"], inputs["node_weights"])
    ckpt = save_checkpoint(str(tmp_path_factory.mktemp("ckpt_hier")), params=load_flax_params(params),
                           config=cfg.to_dict())
    unsharded_run = train_run(hier_source(), device="cpu", log=lambda s: None, handle_signals=False, **HIER_RUN)
    return dict(cfg=cfg.to_dict(), checkpoint=ckpt, inputs=inputs, n_grid=n_grid, levels=names, jax_forward=forward,
                jax_loss=loss, jax_grads=grads, jax_params=stepped, jax_before=before,
                jax_rollout_loss=_jax_rollout_loss(jmodel, di, params, inputs), run_losses=unsharded_run["losses"])


def _model_spec(setup, mesh, extra_flavors=None, **extra):
    flavors = {f: {"cfg": s["cfg"], "checkpoint": s["checkpoint"]} for f, s in setup["flavors"].items()}
    flavors.update(extra_flavors or {})
    return dict(mesh=mesh, graph=GRAPH, inputs=setup["inputs"], lr=LR, name_to_index=dict(VARS), flavors=flavors,
                **extra)


def _hier_spec(hier, mesh, **extra):
    return dict(mesh=mesh, graph=HIER_GRAPH, hierarchical=True, inputs=hier["inputs"], lr=LR,
                name_to_index=dict(VARS), flavors={"hierarchical": {"cfg": hier["cfg"],
                                                                    "checkpoint": hier["checkpoint"]}}, **extra)


# ---------------------------------------------------------------------------
# the halo GNN processor, as JAX builds and runs it
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def halo_gnn(setup):
    g = setup["jgraph"]
    n = g["hidden"].num_nodes
    proc = JaxHaloGNNProcessor(num_layers=2, num_channels=C, trainable_size=2, sub_graph=g[("hidden", "to", "hidden")])
    x = np.random.RandomState(5).randn(1, n, C).astype(np.float32)
    tree = proc.init(jax.random.key(3), jnp.asarray(x))
    rng = np.random.RandomState(6)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), tree)
    ref = np.asarray(_run_once(proc.apply, tree, jnp.asarray(x)))
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    with jax_use_mesh(mesh):
        sharded = np.asarray(jax.jit(proc.apply)(tree, jnp.asarray(x)))
    return dict(tree=tree, x=x, ref=ref, jax_sharded=sharded)


# ---------------------------------------------------------------------------
# the halo layers' inputs and the JAX package's outputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layers(setup):
    g = setup["jgraph"]
    es = g[("hidden", "to", "hidden")]
    n, ne = g["hidden"].num_nodes, es.num_edges
    rng = np.random.RandomState(21)
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    part = jpart.partition_1hop(es.edge_index, n, 2)

    def r(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)

    # the GNN conv: the edge MLP with its LayerNorm (the GNN processors' layout)
    tree = {"w1": r(3 * C, C, scale=(3 * C) ** -0.5), "b1": r(C, scale=0.1), "w2": r(C, C, scale=C ** -0.5),
            "b2": r(C, scale=0.1), "w3": r(C, C, scale=C ** -0.5), "b3": r(C, scale=0.1),
            "ln_s": 1 + r(C, scale=0.1), "ln_b": r(C, scale=0.1)}
    gnn = dict(x=r(2, n, C), e=r(2, ne, C), g_agg=r(2, n, C), g_msg=r(2, ne, C), activation="SiLU",
               params=[tree["w1"].T.copy(), tree["b1"], tree["w2"].T.copy(), tree["b2"], tree["w3"].T.copy(),
                       tree["b3"], tree["ln_s"], tree["ln_b"]])
    e_sh = jax_shard_edge_values(jnp.asarray(gnn["e"]), part)
    agg, edges_new = jax.jit(lambda x, e, p: jax_halo_graph_conv(mesh, part, p, x, e))(
        jnp.asarray(gnn["x"]), e_sh, jax.tree_util.tree_map(jnp.asarray, tree))
    jax_gnn = dict(agg=np.asarray(agg), edges_new=np.asarray(edges_new))

    # the GraphTransformer conv: 4 heads, 3 edge attributes
    h, a_n = 4, 3
    gt = dict(q=r(2, n, h, C // h), feats=r(2, n, C), w_kv=r(2 * C, C, scale=C ** -0.5), b_kv=r(2 * C, scale=0.1),
              edge_attr=r(ne, a_n), w_edge=r(C, a_n), b_edge=r(C, scale=0.1), g_out=r(2, n, h, C // h))
    kv = gt["feats"] @ gt["w_kv"].T + gt["b_kv"]
    k, v = (t.reshape(2, n, h, C // h) for t in np.split(kv, 2, axis=-1))
    a = np.concatenate([gt["edge_attr"], np.ones((ne, 1), np.float32)], axis=1)
    w_aug = np.concatenate([gt["w_edge"].T, gt["b_edge"][None]], axis=0).reshape(a_n + 1, h, C // h)
    a_sh = jax_shard_edge_values(jnp.asarray(a), part)

    def gt_loss(q, k, v, a_sh, w_aug):
        out = jax_halo_gt_conv(mesh, part, q, k, v, a_sh, w_aug)
        return jnp.sum(out * gt["g_out"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(gt_loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        jnp.asarray(gt["q"]), jnp.asarray(k), jnp.asarray(v), a_sh, jnp.asarray(w_aug))
    dq, dk, dv, da_sh, dw_aug = (np.asarray(t) for t in grads)
    da = np.zeros_like(a)
    for s in range(2):
        live = part.edge_mask[s]
        da[part.edge_ids[s][live]] = da_sh[s][live]
    dkv = np.concatenate([dk.reshape(2, n, C), dv.reshape(2, n, C)], axis=-1).reshape(-1, 2 * C)
    f2 = gt["feats"].reshape(-1, C)
    jax_gt = dict(out=np.asarray(out), dq=dq, dfeats=(dkv @ gt["w_kv"]).reshape(2, n, C), dw_kv=dkv.T @ f2,
                  db_kv=dkv.sum(0), dedge=da[:, :a_n], dw_edge=dw_aug[:a_n].reshape(a_n, C).T,
                  db_edge=dw_aug[a_n].reshape(C))

    # the window attention, and the layer's input for the attention the halo path does not take
    win = dict(q=r(1, 2, n, 8), k=r(1, 2, n, 8), v=r(1, 2, n, 8), g_out=r(1, 2, n, 8), window=WINDOW, x=r(1, n, 8))

    def win_loss(q, k, v):
        out = jax_halo_window_attention(q, k, v, window_size=WINDOW, mesh=mesh)
        return jnp.sum(out * win["g_out"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(win_loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(win[k]) for k in ("q", "k", "v")))
    jax_win = dict(out=np.asarray(out), **{f"d{k}": np.asarray(t) for k, t in zip("qkv", grads)})
    # every other attention under a mesh: the JAX package's unsharded dot_product_attention
    jax_attn = {}
    for case, kw in NON_HALO_ATTENTION.items():
        def attn_loss(q, k, v, kw=kw):
            out = jax_dot_product_attention(q, k, v, window_size=kw["window_size"],
                                            is_causal=kw.get("is_causal", False),
                                            impl=kw.get("attention_impl", "auto"))
            return jnp.sum(out * win["g_out"]), out

        (_, out), grads = jax.jit(jax.value_and_grad(attn_loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(win[k]) for k in ("q", "k", "v")))
        jax_attn[case] = dict(out=np.asarray(out), **{f"d{k}": np.asarray(t) for k, t in zip("qkv", grads)})
    spec = dict(graph=GRAPH, gnn=gnn, gt=gt, window=win)
    return dict(spec=spec, part=part, jax_gnn=jax_gnn, jax_gt=jax_gt, jax_win=jax_win, jax_attn=jax_attn, n=n)


@pytest.fixture(scope="module")
def ranks2(setup, layers, halo_gnn, global_attention, hier, tmp_path_factory):
    """Two ranks (model = 2): the primitives, the halo layers, every flavor
    (and the Transformer on the gathered keys' path) and the
    HaloGNNProcessor, the step without the gradient reduction, and the
    hierarchical model with its train_run."""
    hg = dict(tree=halo_gnn["tree"], x=halo_gnn["x"], num_layers=2, channels=C)
    glob = {"transformer_global": {"cfg": global_attention["cfg"], "checkpoint": global_attention["checkpoint"]}}
    ranks = spawn(tasks, 2, str(tmp_path_factory.mktemp("ranks2")), {
        "prims": (primitives_task, ()), "layers": (layers_task, (layers["spec"],)),
        "model": (model_task, (_model_spec(setup, MESHES["model2"], glob, negative=True, save_dots=True,
                                           halo_gnn=hg),)),
        "hier": (model_task, (_hier_spec(hier, MESHES["model2"], train_run=HIER_RUN),)),
    })
    return {key: [r[key] for r in ranks] for key in ("prims", "layers", "model", "hier", "leaked")}


@pytest.fixture(scope="module")
def ranks4(setup, hier, tmp_path_factory):
    """Four ranks: the primitives, and every flavor and the hierarchical
    model at data = 2, model = 2."""
    ranks = spawn(tasks, 4, str(tmp_path_factory.mktemp("ranks4")), {
        "prims": (primitives_task, ()), "model": (model_task, (_model_spec(setup, MESHES["data2_model2"]),)),
        "hier": (model_task, (_hier_spec(hier, MESHES["data2_model2"]),))})
    return {key: [r[key] for r in ranks] for key in ("prims", "model", "hier", "leaked")}


def _ranks(request, world):
    return request.getfixturevalue(f"ranks{world}")


def _assemble(ranks, flavor, key, mesh, n_grid, grid_axis=2):
    """The whole batch from the ranks' (data slice, grid rows) outputs."""
    data, model = mesh
    rows = [np.concatenate([ranks[d * model + m][flavor][key] for m in range(model)], axis=grid_axis)
            for d in range(data)]
    out = np.concatenate(rows, axis=0)
    assert out.shape[grid_axis] == n_grid
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_run_without_jax(request, world):
    """Every rank ran the sharded model, its layers and the primitives with
    nothing of jax, flax or the JAX package imported (the card's machine
    has none of them)."""
    assert _ranks(request, world)["leaked"] == [[]] * world


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("edges", ["processor", "encoder", "decoder"])
def test_partition_matches_jax(setup, edges, shards):
    """partition_1hop (the processor's self-graph): every array equal to the
    JAX package's. mapper_shard (the mappers' bipartite sets): each rank's
    destinations, edges and the sources they read, in order, equal to the
    JAX package's destination split (mapper_shard_tables' live slots)."""
    jg, pg = setup["jgraph"], setup["pgraph"]
    names = {"processor": ("hidden", "hidden"), "encoder": ("data", "hidden"), "decoder": ("hidden", "data")}[edges]
    key = (names[0], "to", names[1])
    ns, nd = jg[names[0]].num_nodes, jg[names[1]].num_nodes
    np.testing.assert_array_equal(pg[key].edge_index, jg[key].edge_index)
    if edges == "processor":
        want, got = jpart.partition_1hop(jg[key].edge_index, nd, shards), ppart.partition_1hop(pg[key].edge_index,
                                                                                               nd, shards)
        assert (got.num_shards, got.num_nodes) == (shards, nd)
        for f in ("local_edges", "edge_mask", "boundary_contrib", "halo_select", "halo_mask", "edge_ids"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        for s in range(shards):
            sh = ppart.halo_shard(got, s, "cpu")
            lo, hi = row_range(nd, shards, s)
            assert sh.num_local == hi - lo and sh.edge_hi - sh.edge_lo == int(got.edge_mask[s].sum())
        return
    want = jpart.mapper_shard_tables(jg[key], nd, ns, shards)
    gids = want.slot_edge_gids.reshape(want.mask.shape)
    for s in range(shards):
        sh = ppart.mapper_shard(pg[key].edge_index, ns, nd, shards, s, "cpu")
        lo, hi = row_range(nd, shards, s)
        assert (sh.dst_lo, sh.dst_hi) == (lo, hi) and lo == min(s * want.dst_per_shard, nd)
        live = want.mask[s][: hi - lo]
        np.testing.assert_array_equal(np.diff(sh.rowptr.numpy()), live.sum(axis=1))
        np.testing.assert_array_equal(np.arange(sh.edge_lo, sh.edge_hi), gids[s][: hi - lo][live])
        np.testing.assert_array_equal(sh.src_rows.numpy()[sh.src.numpy()], want.src_ids[s][: hi - lo][live])


def test_khop_matches_jax(setup):
    """graphs/khop.py: the 2-hop closure of the processor's edge set and its
    destination-range chunks, equal to the JAX package's."""
    from anemoi_models_tpu.graphs import khop as jkhop
    from anemoi_models_tpu_torch.graphs import khop as pkhop

    es = setup["pgraph"][("hidden", "to", "hidden")]
    n = setup["pgraph"]["hidden"].num_nodes
    np.testing.assert_array_equal(pkhop.get_k_hop_edges(es.edge_index, n, 2), jkhop.get_k_hop_edges(es.edge_index, n, 2))
    for got, want in zip(pkhop.sort_edges_1hop_chunks(es.edge_index, n, 3),
                         jkhop.sort_edges_1hop_chunks(es.edge_index, n, 3), strict=True):
        np.testing.assert_array_equal(got, want)


def test_shape_helpers_and_padding_match_jax(setup):
    """get_shape_shards and change_channels_in_shape (tensor_split shapes),
    and pad_nodes / unpad_nodes over a partition, against the JAX
    package's."""
    from anemoi_models_tpu.parallel import halo as jhalo
    from anemoi_models_tpu.parallel import primitives as jprim
    from anemoi_models_tpu_torch.parallel import change_channels_in_shape, get_shape_shards, pad_nodes, unpad_nodes

    x = np.random.RandomState(3).randn(2, 43, 5).astype(np.float32)
    for shards in (2, 4):
        shapes = get_shape_shards(torch.from_numpy(x), 1, shards)
        assert shapes == jprim.get_shape_shards(jnp.asarray(x), 1, shards)
        assert change_channels_in_shape(shapes, 7) == jprim.change_channels_in_shape(shapes, 7)
    es = setup["pgraph"][("hidden", "to", "hidden")]
    n = setup["pgraph"]["hidden"].num_nodes
    part = ppart.partition_1hop(es.edge_index, n, 4)
    y = np.random.RandomState(4).randn(2, n, 3).astype(np.float32)
    padded = pad_nodes(torch.from_numpy(y), part)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jhalo.pad_nodes(jnp.asarray(y), part)))
    np.testing.assert_array_equal(unpad_nodes(padded, part).numpy(), y)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------


def _primitive_reference(name, world):
    """Every rank's (output, input gradient), from the whole arrays."""
    ins = [primitive_inputs(world, r)[name] for r in range(world)]
    rows = [row_range(PRIM_ROWS, world, r) for r in range(world)]
    xs, gs = [i[0] for i in ins], [i[1] for i in ins]
    if name == "shard_tensor":
        return [(xs[r][lo:hi], np.concatenate(gs)) for r, (lo, hi) in enumerate(rows)]
    if name == "gather_tensor":
        return [(np.concatenate(xs), gs[r][lo:hi]) for r, (lo, hi) in enumerate(rows)]
    if name == "sync_tensor":
        return [(np.concatenate(xs), sum(gs)[lo:hi]) for lo, hi in rows]
    if name == "reduce_shard_tensor":
        return [(sum(xs)[lo:hi], np.concatenate(gs)) for lo, hi in rows]
    return [(sum(xs), gs[r]) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_forward_and_adjoint(request, name, world):
    """Each collective and its adjoint on every rank against the function
    of the whole arrays (7 rows: uneven over 2 and 4 ranks), fp32 1e-6."""
    got = _ranks(request, world)["prims"]
    for r, (y, dx) in enumerate(_primitive_reference(name, world)):
        np.testing.assert_allclose(got[r][name][0], y, atol=1e-6, rtol=1e-6, err_msg=f"{name} rank {r} forward")
        np.testing.assert_allclose(got[r][name][1], dx, atol=1e-6, rtol=1e-6, err_msg=f"{name} rank {r} adjoint")
        assert got[r][name][1].shape[1] == PRIM_COLS


# ---------------------------------------------------------------------------
# the halo layers
# ---------------------------------------------------------------------------


def test_halo_graph_conv_matches_jax(ranks2, layers):
    """agg and the threaded edge features of the halo GNN conv against the
    JAX package's halo_graph_conv on a 2-device mesh."""
    got = [r["gnn"] for r in ranks2["layers"]]
    np.testing.assert_allclose(np.concatenate([g["agg"] for g in got], axis=1), layers["jax_gnn"]["agg"], **OUT)
    part = layers["part"]
    for s, g in enumerate(got):
        live = int(part.edge_mask[s].sum())
        np.testing.assert_allclose(g["msg"], layers["jax_gnn"]["edges_new"][s][:, :live], **OUT)


def test_halo_graph_conv_matches_unsharded(ranks2, layers):
    """The halo GNN conv's outputs and every gradient (the rows', the edges',
    the edge MLP's summed over ranks) against the port's unsharded GNNConv."""
    spec = layers["spec"]["gnn"]
    g = port_build_graph(**GRAPH)[("hidden", "to", "hidden")]
    n = layers["n"]
    rowptr, src = (torch.from_numpy(t) for t in csr_from_edge_index(g.edge_index, n, n))
    x, e = (torch.tensor(spec[k], requires_grad=True) for k in ("x", "e"))
    params = [torch.tensor(p, requires_grad=True) for p in spec["params"]]
    agg, msg = GNNConv.apply(x, x, e, rowptr, src, spec["activation"], *params)
    ((agg * torch.from_numpy(spec["g_agg"])).sum() + (msg * torch.from_numpy(spec["g_msg"])).sum()).backward()
    got = [r["gnn"] for r in ranks2["layers"]]
    np.testing.assert_allclose(np.concatenate([r["agg"] for r in got], axis=1), agg.detach().numpy(), **OUT)
    np.testing.assert_allclose(np.concatenate([r["msg"] for r in got], axis=1), msg.detach().numpy(), **OUT)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in got], axis=1), x.grad.numpy(), **GRAD)
    np.testing.assert_allclose(np.concatenate([r["de"] for r in got], axis=1), e.grad.numpy(), **GRAD)
    for i, p in enumerate(params):
        np.testing.assert_allclose(sum(r["dparams"][i] for r in got), p.grad.numpy(), **GRAD)
    assert g.num_edges == sum(r["edge_range"][1] - r["edge_range"][0] for r in got)


def test_halo_graph_transformer_conv_matches_jax(ranks2, layers):
    """The halo GraphTransformer conv (kv projected on the rank's rows, one
    halo exchange of [k|v], the attention over the rank's CSR) against the
    JAX package's halo_graph_transformer_conv: the output at 2e-5, and every
    gradient, the JAX ones carried through the projections, at 5e-4."""
    got = [r["gt"] for r in ranks2["layers"]]
    want = layers["jax_gt"]
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got], axis=1), want["out"], **OUT)
    for key in ("dq", "dfeats"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got], axis=1), want[key], **GRAD, err_msg=key)
    np.testing.assert_allclose(np.concatenate([g["dedge"] for g in got]), want["dedge"], **GRAD)
    for key in ("dw_kv", "db_kv", "dw_edge", "db_edge"):
        np.testing.assert_allclose(sum(g[key] for g in got), want[key], **GRAD, err_msg=key)


def test_halo_window_attention_matches_jax(ranks2, layers):
    """The halo window attention at p = 0 (the rows of 2 ranks, a window of
    8) against the JAX package's, forward and gradients."""
    got = [r["window"] for r in ranks2["layers"]]
    want = layers["jax_win"]
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got], axis=2), want["out"], **OUT)
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got], axis=2), want[key], **GRAD, err_msg=key)


@pytest.mark.parametrize("case", sorted(NON_HALO_ATTENTION))
def test_non_halo_attention_under_mesh_raises(ranks2, layers, case):
    """Attention under a model-sharded mesh that the halo path does not take
    (a causal mask, another attention_impl, no window) no longer raises: each
    rank's queries attend the gathered keys on the flash kernel's path. The
    ranks' rows against the JAX package's unsharded dot_product_attention,
    the output at 2e-5 and dq, dk, dv at 5e-4; and the attention layer under
    the mesh takes that path: its rows are its unsharded output's."""
    got = [r[f"non_halo_{case}"] for r in ranks2["layers"]]
    want = layers["jax_attn"][case]
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got], axis=2), want["out"], **OUT)
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got], axis=2), want[key], **GRAD, err_msg=key)
    for g in got:
        np.testing.assert_allclose(g["layer"], g["layer_unsharded"], **OUT)


def test_halo_window_attention_dropout_keep_rate(ranks2, layers):
    """At p = 0.5 the ranks draw their pairs at global positions, so the
    sharded forward is the unsharded one's (with v = 1 an output is the kept
    weights' sum over (1 - p): 1 on average); at p = 0 the same call gives
    exactly 1. The JAX package draws per shard, a pattern that depends on
    the rank count."""
    dropped = np.concatenate([r["window"]["dropped"] for r in ranks2["layers"]], axis=2)
    spec = layers["spec"]["window"]
    q, k = (torch.from_numpy(spec[name]) for name in ("q", "k"))
    whole = blockwise_attention(q, k, torch.ones_like(q), window_size=WINDOW, dropout_rate=0.5, dropout_key=7)
    np.testing.assert_allclose(dropped, whole.numpy(), **OUT)
    assert abs(float(dropped.mean()) - 1.0) < 0.1
    assert float(dropped.std()) > 0.1
    ones = blockwise_attention(q, k, torch.ones_like(q), window_size=WINDOW)
    np.testing.assert_allclose(ones.numpy(), 1.0, atol=1e-6)


OFFSET_CASES = {"band": dict(window_size=4), "causal": dict(window_size=None, is_causal=True),
                "dropout": dict(window_size=4, dropout_rate=0.3, dropout_key=11)}


def _offset_rows(case: str, k_shift: int = 0):
    """A rank's rows [19, 37) of a 37-long sequence against the whole call's:
    windowed cases on the halo-extended keys [15, 41) (the last w rows past
    the end padded), the causal case on every key."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 3, 37, 8, generator=gen) for _ in range(3))
    kw = OFFSET_CASES[case]
    whole = blockwise_attention(q, k, v, block_size=8, **kw)
    lo, w = 19, kw["window_size"]
    if w is None:
        rows = blockwise_attention(q[:, :, lo:], k, v, block_size=8, q_offset=lo, **kw)
    else:
        kk, vv = (torch.nn.functional.pad(t[:, :, lo - w:], (0, 0, 0, w)) for t in (k, v))
        rows = blockwise_attention(q[:, :, lo:], kk, vv, block_size=8, q_offset=lo, k_offset=lo - w + k_shift,
                                   n_valid=37, **kw)
    return rows, whole[:, :, lo:]


@pytest.mark.parametrize("case", sorted(OFFSET_CASES))
def test_blockwise_offsets_give_the_whole_calls_rows(case):
    """The plain version with q_offset / k_offset / n_valid on a rank's rows
    (the band on halo-extended keys, causal on every key, dropout drawn at
    global positions) gives those rows of the whole-sequence call."""
    rows, want = _offset_rows(case)
    np.testing.assert_allclose(rows.numpy(), want.numpy(), **OUT)


def test_blockwise_wrong_key_offset_differs():
    """The check can fail: the halo keys placed one row off give other rows."""
    rows, want = _offset_rows("band", k_shift=1)
    assert float((rows - want).abs().max()) > 0.1


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("flavor", FLAVORS)
def test_sharded_forward(request, setup, flavor, mesh):
    """The sharded forward (a model loaded from the unsharded model's
    checkpoint, each rank its data slice and grid rows) against the JAX
    package's unsharded forward at the gate's tolerance and the port's
    unsharded forward at 2e-5."""
    ranks = _ranks(request, 4 if mesh == "data2_model2" else 2)["model"]
    s = setup["flavors"][flavor]
    got = _assemble(ranks, flavor, "forward", MESHES[mesh], setup["jgraph"]["data"].num_nodes)
    np.testing.assert_allclose(got, s["jax_forward"], **GATE)
    np.testing.assert_allclose(got, s["port_forward"], **OUT)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("flavor", FLAVORS)
def test_sharded_train_step(request, setup, flavor, mesh):
    """One sharded train step against the unsharded step on the whole
    batch: the loss, every reduced gradient (the same on every rank) and
    every updated parameter."""
    ranks = _ranks(request, 4 if mesh == "data2_model2" else 2)["model"]
    s = setup["flavors"][flavor]
    for r in ranks:
        np.testing.assert_allclose(r[flavor]["loss"], s["port_loss"], rtol=5e-4)
        for k, want in s["port_grads"].items():
            np.testing.assert_allclose(r[flavor]["grads"][k], want, **GRAD, err_msg=k)
        for k, want in s["port_params"].items():
            np.testing.assert_allclose(r[flavor]["params"][k], want, **GRAD, err_msg=k)
    for r in ranks[1:]:
        for k, v in r[flavor]["params"].items():
            np.testing.assert_array_equal(v, ranks[0][flavor]["params"][k], err_msg=f"ranks disagree on {k}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("flavor", FLAVORS)
def test_sharded_rollout_loss(request, setup, flavor, mesh):
    """The 2-step sharded rollout train step's loss against the JAX
    package's unsharded rollout loss (rtol 5e-5, the gate's)."""
    ranks = _ranks(request, 4 if mesh == "data2_model2" else 2)["model"]
    for r in ranks:
        np.testing.assert_allclose(r[flavor]["rollout_loss"], setup["flavors"][flavor]["jax_rollout_loss"], rtol=5e-5)


def test_step_without_gradient_reduction_differs(ranks2, setup):
    """The check can fail: the same sharded step with the reduction of the
    replicated parameters' gradients left out gives each rank its partial
    gradients, far outside the tolerance, and parameters that differ from
    the unsharded step's and between the ranks."""
    s = setup["flavors"]["graphtransformer"]
    ranks = [r["graphtransformer"] for r in ranks2["model"]]
    worst = max(np.abs(r["negative_grads"][k] - want).max() for r in ranks for k, want in s["port_grads"].items())
    assert worst > 100 * GRAD["atol"]
    moved = max(np.abs(r["negative_params"][k] - want).max() for r in ranks for k, want in s["port_params"].items())
    assert moved > 1e-6
    assert any(not np.array_equal(ranks[0]["negative_params"][k], ranks[1]["negative_params"][k])
               for k in s["port_params"])


def test_sharded_step_under_save_dots(ranks2, setup):
    """The sharded GraphTransformer step under remat "save_dots": its loss
    and every reduced gradient bit-identical to the same rank's step under
    "full" and within 5e-4 of the unsharded step; each mapper's
    destination-sharded block ran twice (the forward, then its recompute in
    the backward, which gathers the source rows again)."""
    s = setup["flavors"]["graphtransformer"]
    for r in (r["graphtransformer"] for r in ranks2["model"]):
        assert r["save_dots_loss"] == r["loss"]
        for k, want in s["port_grads"].items():
            np.testing.assert_array_equal(r["save_dots_grads"][k], r["grads"][k], err_msg=k)
            np.testing.assert_allclose(r["save_dots_grads"][k], want, **GRAD, err_msg=k)
        assert r["mapper_block_calls"] == {"encoder": 2, "decoder": 2}


def test_sharded_transformer_without_halo_matches_jax(ranks2, global_attention, setup):
    """The Transformer flavor with no window under (1, 2) (each rank's
    queries against the gathered keys): the sharded forward against the JAX
    model's single-device forward at the gate's tolerance, and one sharded
    train step's loss, reduced gradients (5e-4) and parameter update (LR /
    20) against the JAX model's single-device step."""
    g = global_attention
    ranks = ranks2["model"]
    got = _assemble(ranks, "transformer_global", "forward", MESHES["model2"], setup["jgraph"]["data"].num_nodes)
    np.testing.assert_allclose(got, g["jax_forward"], **GATE)
    for r in ranks:
        res = r["transformer_global"]
        np.testing.assert_allclose(res["loss"], g["jax_loss"], rtol=5e-4)
        grads = _port_flat(res["grads"])
        assert grads.keys() == g["jax_grads"].keys()
        for name, want in g["jax_grads"].items():
            np.testing.assert_allclose(grads[name], want, **GRAD, err_msg=f"grads {name}")
        _assert_update(_port_flat(res["params"]), g["jax_before"], g["jax_params"], g["jax_grads"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_hierarchical_forward(request, hier, mesh):
    """The hierarchical model's sharded forward (every level's rows split
    over model, the level mappers destination-sharded, each level processor
    on its own halo plan) against the JAX model's single-device forward at
    the gate's tolerance (tests/parallel/test_sharding.py:123)."""
    ranks = _ranks(request, 4 if mesh == "data2_model2" else 2)["hier"]
    got = _assemble(ranks, "hierarchical", "forward", MESHES[mesh], hier["n_grid"])
    np.testing.assert_allclose(got, hier["jax_forward"], **GATE)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_hierarchical_train_step(request, hier, mesh):
    """One sharded train step of the hierarchical model against the JAX
    model's single-device step: the loss, every reduced gradient at 5e-4 and
    every parameter's AdamW update at LR / 20, the same on every rank."""
    ranks = _ranks(request, 4 if mesh == "data2_model2" else 2)["hier"]
    for r in ranks:
        res = r["hierarchical"]
        np.testing.assert_allclose(res["loss"], hier["jax_loss"], rtol=5e-4)
        grads = _port_flat(res["grads"])
        assert grads.keys() == hier["jax_grads"].keys()
        for name, want in hier["jax_grads"].items():
            np.testing.assert_allclose(grads[name], want, **GRAD, err_msg=f"grads {name}")
        _assert_update(_port_flat(res["params"]), hier["jax_before"], hier["jax_params"], hier["jax_grads"])
    for r in ranks[1:]:
        for k, v in r["hierarchical"]["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["hierarchical"]["params"][k], err_msg=f"ranks disagree on {k}")


def test_unapplied_update_fails_the_update_check(hier):
    """The check can fail: parameters left where they were (the optimizer's
    update skipped) are refused."""
    with pytest.raises(AssertionError, match="update"):
        _assert_update(hier["jax_before"], hier["jax_before"], hier["jax_params"], hier["jax_grads"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_hierarchical_rollout_loss(request, hier, mesh):
    """The hierarchical model's 2-step sharded rollout train step's loss
    against the JAX model's single-device rollout (rtol 5e-5, the gate's)."""
    for r in _ranks(request, 4 if mesh == "data2_model2" else 2)["hier"]:
        np.testing.assert_allclose(r["hierarchical"]["rollout_loss"], hier["jax_rollout_loss"], rtol=5e-5)


def test_sharded_hierarchical_train_run(ranks2, hier):
    """train_run(architecture="hierarchical") under (1, 2), 2 steps, against
    the port's unsharded run: the loss trace at rtol 6e-4, the same on both
    ranks."""
    traces = [r["train_run"] for r in ranks2["hier"]]
    assert len(hier["run_losses"]) == 2 and traces[0] == traces[1]
    np.testing.assert_allclose(traces[0], hier["run_losses"], rtol=6e-4)


# ---------------------------------------------------------------------------
# the HaloGNNProcessor
# ---------------------------------------------------------------------------


def _port_halo_gnn(setup, halo_gnn):
    n = setup["pgraph"]["hidden"].num_nodes
    proc = HaloGNNProcessor(2, num_channels=C, trainable_size=2, sub_graph=setup["pgraph"][("hidden", "to", "hidden")],
                            src_grid_size=n, dst_grid_size=n, device="cpu")
    proc.load_state_dict(load_flax_params(halo_gnn["tree"]), strict=True)
    return proc


def test_halo_gnn_processor_unsharded_matches_jax(setup, halo_gnn):
    """The HaloGNNProcessor with no mesh (its plain path) against JAX's."""
    with torch.no_grad():
        got = _port_halo_gnn(setup, halo_gnn)(torch.from_numpy(halo_gnn["x"])).numpy()
    np.testing.assert_allclose(got, halo_gnn["ref"], **OUT)


def test_halo_gnn_processor_sharded_matches_jax(ranks2, halo_gnn):
    """The HaloGNNProcessor on 2 ranks against JAX's on a 2-device mesh."""
    got = np.concatenate([r["halo_gnn"] for r in ranks2["model"]], axis=1)
    np.testing.assert_allclose(got, halo_gnn["jax_sharded"], **GATE)
    np.testing.assert_allclose(got, halo_gnn["ref"], **GATE)


def test_halo_gnn_processor_weights_round_trip(setup, halo_gnn):
    """weights.py maps the HaloGNNProcessor's tree both ways: its own
    conv_{i}_* parameters as they are, its MLPs by the usual rules."""
    proc = _port_halo_gnn(setup, halo_gnn)
    want = _flat(halo_gnn["tree"])
    got = _flat(to_flax_params(proc.state_dict()))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
