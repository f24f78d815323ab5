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

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.interface import AnemoiModelInterface as JaxInterface
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.layers.mapper import GraphTransformerForwardMapper
from anemoi_models_tpu_torch.layers.processor import GraphTransformerProcessor
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
    model = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph)
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
    iface = AnemoiModelInterface(config=cfg, graph_data=graph, statistics=stats, data_indices=di)
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
    with pytest.raises(ValueError, match="graph_impl"):
        GraphTransformerProcessor(
            2, num_channels=16, num_heads=4, trainable_size=2,
            sub_graph=graph[("hidden", "to", "hidden")], src_grid_size=graph["hidden"].num_nodes,
            dst_grid_size=graph["hidden"].num_nodes, graph_impl="segment",
        )
    cfg = DotDict(make_config("graphtransformer").to_dict())
    cfg.model.bounding = [{"_target_": "anemoi.models.layers.bounding.ReluBounding", "variables": ["tp"]}]
    with pytest.raises(NotImplementedError, match="bounding"):
        AnemoiModelEncProcDec(model_config=cfg, data_indices=setup[1], graph_data=graph)


def test_port_runs_without_jax():
    """Importing the port and serving a CPU forward leaves jax and flax out of
    sys.modules (the card's machine has neither)."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from anemoi_models_tpu_torch.data_indices import IndexCollection
        from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
        from anemoi_models_tpu_torch.interface import AnemoiModelInterface
        from anemoi_models_tpu_torch.utils import DotDict

        mapper = {"trainable_size": 2, "num_heads": 4, "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
        cfg = DotDict({
            "data": {"forcing": ["lsm"], "diagnostic": ["tp"], "processors": {"normalizer": {
                "_target_": "anemoi.models.preprocessing.normalizer.InputNormalizer",
                "config": {"default": "mean-std"}}}},
            "graph": {"data": "data", "hidden": "hidden"},
            "training": {"multistep_input": 2},
            "model": {
                "num_channels": 16, "trainable_parameters": {"hidden": 4},
                "model": {"_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"},
                "encoder": {"_target_": "anemoi.models.layers.mapper.GraphTransformerForwardMapper", **mapper},
                "processor": {"_target_": "anemoi.models.layers.processor.GraphTransformerProcessor",
                              "num_layers": 2, "num_chunks": 1, **mapper},
                "decoder": {"_target_": "anemoi.models.layers.mapper.GraphTransformerBackwardMapper", **mapper},
            },
        })
        graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
        n2i = {"lsm": 0, "z_500": 1, "t_850": 2, "t2m": 3, "tp": 4}
        stats = {"mean": np.zeros(5), "stdev": np.ones(5), "minimum": np.zeros(5), "maximum": np.ones(5)}
        iface = AnemoiModelInterface(config=cfg, graph_data=graph, statistics=stats,
                                     data_indices=IndexCollection(cfg, n2i), device="cpu")
        iface.init_params(torch.Generator().manual_seed(0))
        y = iface.predict_step(torch.randn(1, 2, graph["data"].num_nodes, 4))
        assert y.shape == (1, 1, graph["data"].num_nodes, 4) and bool(torch.isfinite(y).all())
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
        print("LEAKED", leaked)
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout
