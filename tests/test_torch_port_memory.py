"""PyTorch port, the memory policies of a train step on the CPU: the JAX
layers' config fields, remat "full" / "save_dots" / "none" and cpu_offload
(``layers/remat.py``), the mapper blocks' remat, and the ``remat_policy="auto"``
resolver (``training.step.resolve_remat_policy``).

Sizes are those of the port's other tests (``grid_lat=6, mesh_refinements=2``,
``make_config(flavor)``, C = 16, 2 processor layers, here in 2 chunks and at
batch 2). Every policy computes the same function, so the port's four give
the same gradients bit for bit; against the JAX model, fp32 gradients within
5e-4 (``tests/layers/test_commuted.py``). Each flavor is held to the JAX
model under one of the JAX package's non-default policies (one XLA compile a
flavor; ``tests/test_torch_port_flavors.py`` and ``test_torch_port_train.py``
hold "full").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.layers import mapper as jmapper
from anemoi_models_tpu.layers import processor as jprocessor
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu.training import weighted_mse as jax_weighted_mse
from anemoi_models_tpu_torch.layers import mapper as pmapper
from anemoi_models_tpu_torch.layers import processor as pprocessor
from anemoi_models_tpu_torch.layers import remat
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec
from anemoi_models_tpu_torch.training import (
    SyntheticSource,
    WeightedCRPSLoss,
    estimate_step_bytes,
    resolve_remat_policy,
    train_run,
    weighted_mse,
)
from anemoi_models_tpu_torch.training import run as port_run
from anemoi_models_tpu_torch.weights import init_params, load_flax_params, to_flax_params

GRAD = dict(atol=5e-4, rtol=5e-4)
FLAVORS = ("graphtransformer", "gnn", "transformer")
POLICIES = ("full", "save_dots", "none", "cpu_offload")
# the JAX package's policy each flavor is held to
JAX_POLICY = {"graphtransformer": "cpu_offload", "gnn": "save_dots", "transformer": "none"}
LAYERS = {  # JAX class, port class, edge set
    "TransformerProcessor": (jprocessor.TransformerProcessor, pprocessor.TransformerProcessor, None),
    "GNNProcessor": (jprocessor.GNNProcessor, pprocessor.GNNProcessor, ("hidden", "hidden")),
    "GraphTransformerProcessor": (jprocessor.GraphTransformerProcessor, pprocessor.GraphTransformerProcessor,
                                  ("hidden", "hidden")),
    "HaloGNNProcessor": (jprocessor.HaloGNNProcessor, pprocessor.HaloGNNProcessor, ("hidden", "hidden")),
    "GraphTransformerForwardMapper": (jmapper.GraphTransformerForwardMapper, pmapper.GraphTransformerForwardMapper,
                                      ("data", "hidden")),
    "GraphTransformerBackwardMapper": (jmapper.GraphTransformerBackwardMapper,
                                       pmapper.GraphTransformerBackwardMapper, ("hidden", "data")),
    "GNNForwardMapper": (jmapper.GNNForwardMapper, pmapper.GNNForwardMapper, ("data", "hidden")),
    "GNNBackwardMapper": (jmapper.GNNBackwardMapper, pmapper.GNNBackwardMapper, ("hidden", "data")),
}


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)


def _config(flavor: str, policy: str = "full"):
    """``make_config(flavor)`` with its processor in two chunks, under
    ``policy`` (``"cpu_offload"``: on the mappers and the processor)."""
    cfg = make_config(flavor)
    cfg.model.processor.num_chunks = 2
    if policy == "cpu_offload":
        for part in ("encoder", "processor", "decoder"):
            cfg.model[part].cpu_offload = True
    else:
        cfg.model.processor.remat_policy = policy
    return cfg


@pytest.fixture(scope="module")
def setup(graph):
    """Per flavor: seeded flax parameters (the port's init, perturbed: zero-init
    trainables carry no signal) and a batch of 2."""
    out = {}
    for i, flavor in enumerate(FLAVORS):
        cfg = _config(flavor)
        di = IndexCollection(cfg, dict(VARS))
        model = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph, device="cpu")
        init_params(model, torch.Generator().manual_seed(40 + i))
        rng = np.random.RandomState(40 + i)
        params = jax.tree_util.tree_map(lambda a: a + 0.02 * rng.randn(*a.shape).astype(np.float32),
                                        to_flax_params(model.state_dict()))
        n = graph["data"].num_nodes
        x = rng.randn(2, 2, 1, n, len(di.internal_model.input)).astype(np.float32)
        y = rng.randn(2, 1, n, len(di.internal_model.output)).astype(np.float32)
        out[flavor] = dict(di=di, params=params, x=x, y=y)
    return out


def _port_model(flavor, policy, graph, s):
    model = AnemoiModelEncProcDec(model_config=_config(flavor, policy).to_dict(), data_indices=s["di"],
                                  graph_data=graph, device="cpu")
    model.load_state_dict(load_flax_params(s["params"]), strict=True)
    return model


def _port_grads(model, s):
    loss = weighted_mse(model(torch.from_numpy(s["x"])), torch.from_numpy(s["y"]))
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the JAX layers' config fields
# ---------------------------------------------------------------------------


def _layer_kwargs(name: str, graph) -> dict:
    """Every field of the JAX class at its JAX default, with sizes, the edge
    set and the dtype filled in for the port."""
    jax_cls, _, edges = LAYERS[name]
    kwargs = {f.name: f.default for f in dataclasses.fields(jax_cls)
              if f.name not in ("parent", "name") and f.default is not dataclasses.MISSING}
    sizes = dict(num_layers=2, window_size=4, num_channels=16, hidden_dim=16, num_heads=4, in_channels_src=5,
                 in_channels_dst=3, out_channels_dst=4, dtype=torch.float32)
    kwargs.update({k: v for k, v in sizes.items() if k in {f.name for f in dataclasses.fields(jax_cls)}})
    if edges is not None:
        src, dst = edges
        kwargs.update(sub_graph=graph[(src, "to", dst)], src_grid_size=graph[src].num_nodes,
                      dst_grid_size=graph[dst].num_nodes)
    return kwargs


# the TPU-only fields each class takes, at a value off the JAX default
TPU_ONLY_VALUES = {
    "TransformerProcessor": {"layer_scan": True},
    "GNNProcessor": {"layer_scan": True},
    "GraphTransformerProcessor": {"kv_src_gather": "wide", "layer_scan": True},
    "GraphTransformerForwardMapper": {"plan_block_nodes": 128, "kv_src_gather": "narrow"},
    "GraphTransformerBackwardMapper": {"plan_slab_width": 8},
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_port_layers_take_every_jax_field(graph, name):
    """Each port mapper and processor builds from every field its JAX flax
    class declares, at the JAX defaults (``cpu_offload`` and ``num_chunks``
    on the GraphTransformer mappers among them), and with cpu_offload on; a
    TPU-only field away from its JAX default is refused by name, with
    ROADMAP's reason, never ignored."""
    jax_cls, port_cls, _ = LAYERS[name]
    kwargs = _layer_kwargs(name, graph)
    assert {f.name for f in dataclasses.fields(jax_cls)} - {"parent", "name"} <= set(kwargs)
    port_cls(**kwargs)
    layer = port_cls(**{**kwargs, "cpu_offload": True})
    units = [m for m in layer.modules() if getattr(m, "cpu_offload", False)]
    assert units, f"{name} keeps no cpu_offload"
    for field, value in TPU_ONLY_VALUES.get(name, {}).items():
        with pytest.raises(ValueError, match=f"{field}.*Do not port"):
            port_cls(**{**kwargs, field: value})


# ---------------------------------------------------------------------------
# the four policies: gradients, the mapper blocks' remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavor", FLAVORS)
def test_every_policy_gives_the_same_gradients(graph, setup, flavor):
    """remat "full", "save_dots", "none" and cpu_offload (on both mappers and
    the processor, batch 2, so expanded edge tensors go through the host):
    the loss and every gradient bit for bit alike, and within 5e-4 of the
    JAX model's under ``JAX_POLICY[flavor]`` (its cpu_offload runs on the
    CPU, as ``tests/layers/test_composite_layers.py`` runs it). Each
    mapper's block runs twice a step (the forward, and again in the
    backward) under every remat policy, once under cpu_offload, whose
    saved activations go to host memory, and once without gradients."""
    s = setup[flavor]
    runs = {}
    for policy in POLICIES:
        model = _port_model(flavor, policy, graph, s)
        calls = {"encoder": 0, "decoder": 0}
        for part in calls:
            getattr(model, part).proc.register_forward_pre_hook(
                lambda *_, part=part: calls.__setitem__(part, calls[part] + 1))
        remat.OFFLOADED.update(tensors=0, bytes=0)
        runs[policy] = _port_grads(model, s)
        blocks = 1 if policy == "cpu_offload" else 2
        assert calls == {"encoder": blocks, "decoder": blocks}, policy
        assert (remat.OFFLOADED["bytes"] > 0) == (policy == "cpu_offload"), policy
        with torch.no_grad():
            model(torch.from_numpy(s["x"]))
        assert calls == {"encoder": blocks + 1, "decoder": blocks + 1}, policy
    for policy, (loss, grads) in runs.items():
        assert loss == runs["full"][0], policy
        for k, g in runs["full"][1].items():
            assert torch.equal(grads[k], g), f"{policy}: {k}"

    jmodel = JaxModel(model_config=_config(flavor, JAX_POLICY[flavor]), data_indices=s["di"], graph_data=graph)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jax_weighted_mse(jmodel.apply(p, jnp.asarray(s["x"])), jnp.asarray(s["y"]))))(s["params"])
    np.testing.assert_allclose(runs["full"][0], float(loss_ref), rtol=2e-5, atol=2e-5)
    want, got = _flat(grads_ref), _flat(to_flax_params(runs["full"][1]))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **GRAD)


def test_save_dots_keeps_only_2d_products(graph, setup, monkeypatch):
    """The "save_dots" policy, counted, in each flavor: it keeps (MUST_SAVE)
    every ``aten.mm`` / ``aten.addmm`` and nothing else, at least one in
    each chunk's forward; ``bmm`` and every other op are recomputed."""
    seen = []
    chunk = [None]

    def counted(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        seen.append((chunk[0], ctx.is_recompute, op, decision))
        return decision

    policy = remat.save_dots_policy
    monkeypatch.setattr(remat, "save_dots_policy", counted)
    for flavor in FLAVORS:
        seen.clear()
        model = _port_model(flavor, "save_dots", graph, setup[flavor])
        for i, unit in enumerate(model.processor.proc):
            unit.register_forward_pre_hook(lambda *_, i=i: chunk.__setitem__(0, i))
        _port_grads(model, setup[flavor])
        saved = {op for _, _, op, d in seen if d == remat.CheckpointPolicy.MUST_SAVE}
        assert saved <= set(remat.SAVED_DOTS), flavor
        assert all(d == remat.CheckpointPolicy.MUST_SAVE for _, _, op, d in seen if op in remat.SAVED_DOTS), flavor
        forward = {c for c, recompute, _, d in seen if not recompute and d == remat.CheckpointPolicy.MUST_SAVE}
        assert forward == set(range(len(model.processor.proc))), flavor


class _Saves(torch.autograd.Function):
    """y = sum of its inputs' products with w; records the strides of the
    saved tensors its backward reads."""

    strides: list = []

    @staticmethod
    def forward(ctx, a, b, w):
        ctx.save_for_backward(a, b, w)
        return (a * b) @ w

    @staticmethod
    def backward(ctx, g):
        a, b, w = ctx.saved_tensors
        _Saves.strides[:] = [a.stride(), b.stride(), w.stride()]
        gab = g @ w.t()
        return gab * b, gab * a, (a * b).transpose(-1, -2) @ g


def test_offload_keeps_parameters_strides_and_broadcasts():
    """cpu_offload's hooks: a parameter (and a view of it) stays on its
    device, uncopied; a transposed and an expanded tensor come back with
    their strides, the expanded one copied once; the gradients are the
    unhooked ones bit for bit."""
    lin = torch.nn.Linear(6, 4)
    x = torch.randn(6, 5, requires_grad=True)
    e = torch.randn(1, 6, requires_grad=True)

    def run():  # a transposed (5, 6), an expanded (5, 6), a view of the parameter
        return _Saves.apply(x.t(), e.expand(5, 6), lin.weight.t()).sum()

    run().backward()
    want = [t.grad.clone() for t in (x, e, lin.weight)]
    want_strides = list(_Saves.strides)
    for t in (x, e, lin.weight):
        t.grad = None
    remat.OFFLOADED.update(tensors=0, bytes=0)
    with remat.offload_saved(lin):
        loss = run()
    assert remat.OFFLOADED == {"tensors": 2, "bytes": (5 * 6 + 6) * 4}
    loss.backward()
    assert _Saves.strides == want_strides
    assert _Saves.strides[:2] == [(1, 5), (0, 1)]
    for t, g in zip((x, e, lin.weight), want):
        assert torch.equal(t.grad, g)


# ---------------------------------------------------------------------------
# remat_policy="auto"
# ---------------------------------------------------------------------------


def _shapes(graph, s):
    n = graph["data"].num_nodes
    return (1, 2, 1, n, s["x"].shape[-1]), (1, 1, n, s["y"].shape[-1])


def test_resolve_remat_policy_limits(graph, setup):
    """The resolver keys off the estimated peak against the budget: a huge
    one keeps "none", a tiny one, 0, or the CPU with no budget give "full";
    every answer is logged."""
    model = _port_model("graphtransformer", "none", graph, setup["graphtransformer"])
    x_shape, y_shape = _shapes(graph, setup["graphtransformer"])
    msgs = []
    got = [resolve_remat_policy(model, None, x_shape, y_shape, limit_bytes=limit, log=msgs.append)
           for limit in (1 << 40, 1 << 10, 0, None)]
    assert got == ["none", "full", "full", "full"]
    assert len(msgs) == 4 and all(m.startswith("remat auto:") for m in msgs)
    assert "-> none" in msgs[0] and "-> full" in msgs[1]
    assert all(p.grad is None for p in model.parameters())  # the estimate ran no backward


def test_estimate_grows_with_the_step_variant(graph, setup):
    """The estimate counts the step variant the run executes: it grows with
    the rollout, the ensemble axis and the EMA (by exactly one copy of the
    parameters), and a rollout needs the IndexCollection."""
    s = setup["graphtransformer"]
    model = _port_model("graphtransformer", "none", graph, s)
    x_shape, y_shape = _shapes(graph, s)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    base = estimate_step_bytes(model, opt, x_shape, y_shape)
    rollout = estimate_step_bytes(model, opt, x_shape, y_shape, indices=s["di"], rollout=2)
    area = torch.ones(graph["data"].num_nodes)
    ensemble = estimate_step_bytes(model, opt, x_shape, y_shape, ensemble=3, loss_fn=WeightedCRPSLoss(area))
    ema = estimate_step_bytes(model, opt, x_shape, y_shape, ema=True)
    assert base < rollout and base < ensemble
    assert ema - base == sum(p.numel() * 4 for p in model.parameters())
    with pytest.raises(ValueError, match="indices"):
        estimate_step_bytes(model, opt, x_shape, y_shape, rollout=2)
    full = _port_model("graphtransformer", "full", graph, s)  # the count ignores the model's own policy
    assert estimate_step_bytes(full, opt, x_shape, y_shape) == base


@pytest.mark.parametrize("limit, chosen", [(1 << 40, "none"), (1 << 10, "full")])
def test_train_run_auto_resolves_the_run_variant(monkeypatch, limit, chosen):
    """``train_run(remat_policy="auto")`` under a budget (the CPU has none, so
    the resolver is handed one): it estimates the variant the run executes
    (the curriculum's longest rollout, 2 members, CRPS, EMA), keeps the
    model built with "none" when that fits and rebuilds it with "full" when
    it does not, and the run trains (``tests/training/test_run.py``'s
    rollout + ensemble + EMA case)."""
    from anemoi_models_tpu_torch.graphs.build import latlon_grid_nodes

    seen = []

    def resolve(*args, **kwargs):
        seen.append(kwargs)
        return resolve_remat_policy(*args, **{**kwargs, "limit_bytes": limit})

    monkeypatch.setattr(port_run, "resolve_remat_policy", resolve)
    msgs = []
    out = train_run(SyntheticSource(latlon_grid_nodes(8).coords, num_vars=4, num_steps=16, seed=0),
                    forcing=("var_0",), mesh_refinements=1, steps=2, batch_size=1, seed=0, log_every=1,
                    model_kwargs=dict(num_channels=16, num_layers=2, num_heads=4, num_chunks=1, remat_policy="auto"),
                    rollout_schedule=[(0, 1), (1, 2)], ensemble=2, loss="crps", ema_decay=0.99, log=msgs.append,
                    device="cpu", handle_signals=False)
    assert [(k["rollout"], k["ensemble"], k["ema"], type(k["loss_fn"])) for k in seen] == [(2, 2, True, WeightedCRPSLoss)]
    assert [m for m in msgs if m.startswith("remat auto:")][0].endswith(f"-> {chosen}")
    assert [chunk.remat_policy for chunk in out["model"].processor.proc] == [chosen]
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
