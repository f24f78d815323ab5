"""PyTorch port, whole model: ``AnemoiModelEncProcDec`` forward and
``AnemoiModelInterface.predict_step`` against the JAX package on the CPU, the
parameter loader, and the port's independence from jax.

Sizes are those of the fp64 oracle (``tests/models/test_torch_e2e_parity.py``):
``grid_lat=6, mesh_refinements=2``, ``make_config("graphtransformer")``,
C=16, 2 processor layers. Bound: max abs error <= 1e-4 * max(1, mean |ref|)
in fp32, 20x tighter than the oracle's.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config, make_statistics
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.interface import AnemoiModelInterface as JaxInterface
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.layers.attention import MultiHeadSelfAttention
from anemoi_models_tpu_torch.layers.mapper import GNNBackwardMapper, GNNForwardMapper, GraphTransformerForwardMapper
from anemoi_models_tpu_torch.layers.mlp import MLP
from anemoi_models_tpu_torch.layers.processor import GNNProcessor, GraphTransformerProcessor, TransformerProcessor
from anemoi_models_tpu_torch.ops.attention import dot_product_attention
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec
from anemoi_models_tpu_torch.utils import DotDict, resolve_target
from anemoi_models_tpu_torch.weights import init_params, load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bound(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).mean()))


@pytest.fixture(scope="module")
def setup():
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    model = JaxModel(model_config=cfg, data_indices=di, graph_data=graph)
    n_grid = graph["data"].num_nodes
    x = np.random.RandomState(0).randn(1, 2, 1, n_grid, len(di.internal_model.input)).astype(np.float32)
    params = jax.jit(model.init)(jax.random.key(0), jnp.asarray(x))
    # zero-init trainables carry no signal: perturb every parameter
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params
    )
    return graph, di, x, params


def _port_model(cfg, di, graph, params):
    model = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph, device="cpu")
    model.load_state_dict(load_flax_params(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("graph_impl", ["pallas", "dense"])
def test_forward_matches_jax(setup, graph_impl):
    graph, di, x, params = setup
    cfg = make_config("graphtransformer")
    cfg.model.processor.graph_impl = graph_impl
    ref = np.asarray(jax.jit(JaxModel(model_config=cfg, data_indices=di, graph_data=graph).apply)(
        params, jnp.asarray(x)
    ))
    with torch.no_grad():
        out = _port_model(cfg, di, graph, params)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 1, x.shape[3], len(di.internal_model.output))
    np.testing.assert_allclose(out, ref, rtol=0, atol=_bound(ref))


def test_predict_step_matches_jax(setup):
    graph, di, x, params = setup
    cfg = make_config("graphtransformer")
    stats = make_statistics()
    n_in = len(di.data.input.full)
    batch = (stats["mean"][:n_in] + stats["stdev"][:n_in]
             * np.random.RandomState(2).randn(1, 3, x.shape[3], n_in)).astype(np.float32)

    jax_iface = JaxInterface(config=cfg, graph_data=graph, statistics=stats, data_indices=di)
    ref = np.asarray(jax_iface.make_predict_fn()(params, jnp.asarray(batch)))
    iface = AnemoiModelInterface(config=cfg, graph_data=graph, statistics=stats, data_indices=di, device="cpu")
    iface.load_params(params)
    out = iface.predict_step(torch.from_numpy(batch)).numpy()
    assert out.shape == ref.shape == (1, 1, x.shape[3], len(di.data.output.full))
    np.testing.assert_allclose(out, ref, rtol=0, atol=_bound(ref))


def test_loader_layouts_and_seeded_init(setup):
    """Both places of ``emb_nodes_src`` load alike; the port has exactly the
    JAX model's parameter count; ``init_params`` is a function of the seed."""
    graph, di, _, params = setup
    cfg = make_config("graphtransformer")
    tree = jax.tree_util.tree_map(np.asarray, params)["params"]
    wide = dict(tree, encoder=dict(tree["encoder"]))
    wide["encoder"]["proc"] = dict(tree["encoder"]["proc"])
    wide["encoder"]["emb_nodes_src"] = wide["encoder"]["proc"].pop("emb_nodes_src")
    a, b = load_flax_params({"params": tree}), load_flax_params(wide)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    model = _port_model(cfg, di, graph, params)
    n_jax = sum(np.size(v) for v in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax

    states = []
    for _ in range(2):
        init_params(model, torch.Generator().manual_seed(7))
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    w = states[0]["processor.proc.0.blocks.0.lin_kv.weight"]
    assert 0.5 < float(w.std() * w.shape[1] ** 0.5) < 1.5  # lecun-normal scale
    assert torch.count_nonzero(states[0]["encoder.trainable.trainable"]) == 0


def test_config_targets_resolve_to_port_classes(setup):
    graph, _, _, _ = setup
    assert resolve_target("anemoi.models.layers.mapper.GraphTransformerForwardMapper") is GraphTransformerForwardMapper
    assert resolve_target("anemoi.models.layers.processor.GraphTransformerProcessor") is GraphTransformerProcessor
    for target, cls in [
        ("anemoi.models.layers.processor.TransformerProcessor", TransformerProcessor),
        ("anemoi.models.layers.processor.GNNProcessor", GNNProcessor),
        ("anemoi.models.layers.mapper.GNNForwardMapper", GNNForwardMapper),
        ("anemoi.models.layers.mapper.GNNBackwardMapper", GNNBackwardMapper),
        ("anemoi.models.layers.mlp.MLP", MLP),
        ("anemoi.models.layers.attention.MultiHeadSelfAttention", MultiHeadSelfAttention),
    ]:
        assert resolve_target(target) is cls, target
    with pytest.raises(ValueError, match="graph_impl"):  # the JAX GNN mappers take dense | segment
        GNNForwardMapper(
            in_channels_src=8, in_channels_dst=8, hidden_dim=16, trainable_size=2,
            sub_graph=graph[("data", "to", "hidden")], src_grid_size=graph["data"].num_nodes,
            dst_grid_size=graph["hidden"].num_nodes, graph_impl="pallas",
        )
    with pytest.raises(ValueError, match="graph_impl"):
        GraphTransformerProcessor(
            2, num_channels=16, num_heads=4, trainable_size=2,
            sub_graph=graph[("hidden", "to", "hidden")], src_grid_size=graph["hidden"].num_nodes,
            dst_grid_size=graph["hidden"].num_nodes, graph_impl="segment",
        )
    # boundings, the hierarchical model and the AIFS processors resolve to the port's classes, and a
    # config with boundings builds (it raised before they were ported)
    from anemoi_models_tpu_torch.layers.bounding import ReluBounding
    from anemoi_models_tpu_torch.models import AnemoiModelEncProcDecHierarchical
    from anemoi_models_tpu_torch.preprocessing.imputer import InputImputer
    from anemoi_models_tpu_torch.preprocessing.remapper import Remapper

    for target, cls in [
        ("anemoi.models.layers.bounding.ReluBounding", ReluBounding),
        ("anemoi.models.models.hierarchical.AnemoiModelEncProcDecHierarchical", AnemoiModelEncProcDecHierarchical),
        ("anemoi.models.preprocessing.imputer.InputImputer", InputImputer),
        ("anemoi.models.preprocessing.remapper.Remapper", Remapper),
    ]:
        assert resolve_target(target) is cls, target
    cfg = DotDict(make_config("graphtransformer").to_dict())
    cfg.model.bounding = [{"_target_": "anemoi.models.layers.bounding.ReluBounding", "variables": ["tp"]}]
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=setup[1], graph_data=graph, device="cpu")
    assert [type(b) for b in model.boundings] == [ReluBounding]


def test_unported_options_raise():
    """The halo attention raises before any device dispatch without a
    mesh, and for a causal mask, which it has none of; attention-weight
    dropout, now ported, raises the same way when it is asked for without
    a dropout key, in the op and in a Transformer
    processor built non-deterministic with dropout_p > 0. (A GraphConv with
    mlp_extra_layers > 0 raises on a CUDA tensor only: the CPU runs the plain
    version at any depth; tests/test_torch_port_cuda.py holds that case.)"""
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="dropout_key"):
        dot_product_attention(q, q, q, window_size=2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="impl"):
        dot_product_attention(q, q, q, impl="halo")
    proc = TransformerProcessor(2, window_size=2, num_channels=16, num_chunks=1, num_heads=2, dropout_p=0.1,
                                deterministic=False, device="cpu")
    with pytest.raises(ValueError, match="dropout_key"):
        proc(torch.randn(1, 8, 16))
    with pytest.raises(NotImplementedError, match="halo"):
        MultiHeadSelfAttention(2, 16, window_size=2, is_causal=True, attention_impl="halo")
    with pytest.raises(ValueError, match="halo"):
        MultiHeadSelfAttention(2, 16, window_size=2, attention_impl="halo")(torch.randn(1, 8, 16))


def test_port_runs_without_jax():
    """Importing the port, serving a CPU forward and taking a CPU train step
    of each flavor leave jax, flax and the JAX package out of sys.modules
    (the card's machine has neither)."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from anemoi_models_tpu_torch.data_indices import IndexCollection
        from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
        from anemoi_models_tpu_torch.interface import AnemoiModelInterface
        from anemoi_models_tpu_torch.training import make_optimizer, make_train_step
        from anemoi_models_tpu_torch.utils import DotDict

        edges = {"trainable_size": 2, "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
        gt = {**edges, "num_heads": 4}
        layers = "anemoi.models.layers."
        flavors = {
            "graphtransformer": ("GraphTransformer", {"_target_": layers + "processor.GraphTransformerProcessor", **gt}),
            "gnn": ("GNN", {"_target_": layers + "processor.GNNProcessor", **edges}),
            "transformer": ("GraphTransformer", {"_target_": layers + "processor.TransformerProcessor",
                                                 "num_heads": 4, "window_size": 8, "dropout_p": 0.0}),
        }
        graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
        n2i = {"lsm": 0, "z_500": 1, "t_850": 2, "t2m": 3, "tp": 4}
        stats = {"mean": np.zeros(5), "stdev": np.ones(5), "minimum": np.zeros(5), "maximum": np.ones(5)}
        n = graph["data"].num_nodes
        for mapper, processor in flavors.values():
            mkw = gt if mapper == "GraphTransformer" else edges
            cfg = DotDict({
                "data": {"forcing": ["lsm"], "diagnostic": ["tp"], "processors": {"normalizer": {
                    "_target_": "anemoi.models.preprocessing.normalizer.InputNormalizer",
                    "config": {"default": "mean-std"}}}},
                "graph": {"data": "data", "hidden": "hidden"},
                "training": {"multistep_input": 2},
                "model": {
                    "num_channels": 16, "trainable_parameters": {"hidden": 4},
                    "model": {"_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"},
                    "encoder": {"_target_": layers + f"mapper.{mapper}ForwardMapper", **mkw},
                    "processor": {"num_layers": 2, "num_chunks": 1, **processor},
                    "decoder": {"_target_": layers + f"mapper.{mapper}BackwardMapper", **mkw},
                },
            })
            iface = AnemoiModelInterface(config=cfg, graph_data=graph, statistics=stats,
                                         data_indices=IndexCollection(cfg, n2i), device="cpu")
            iface.init_params(torch.Generator().manual_seed(0))
            y = iface.predict_step(torch.randn(1, 2, n, 4))
            assert y.shape == (1, 1, n, 4) and bool(torch.isfinite(y).all())
            step = make_train_step(iface.model, make_optimizer(iface.model.parameters(), warmup_steps=1))
            loss = step(torch.randn(1, 2, 1, n, 4), torch.randn(1, 1, n, 4))
            assert bool(torch.isfinite(loss))
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "anemoi_models_tpu"))
        print("LEAKED", leaked)
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout
