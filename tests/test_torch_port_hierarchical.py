"""PyTorch port, the hierarchical model against the JAX package on the CPU:
the level-pyramid graph builder (and ``nodes_from_coords``), the
``AnemoiModelEncProcDecHierarchical`` forward with and without level
processors, every parameter's gradient, ``predict_step`` through the
interface, the flax tree both ways, and a checkpoint round trip with the
hidden levels as a list.

The graph is 3 levels on ``grid_lat=6, mesh_refinements=2`` (r2 / r1 / r0),
built by both packages' numpy code paths (the JAX builders' native helper
off: its coordinates differ in the last bit of some, which flips knn ties
between the levels' coincident nodes). The model is
``helpers_models.make_config``'s GraphTransformer at C = 8 (8 / 16 / 32 over
the levels, 4 heads) with the JAX model's initialisation, perturbed.
Tolerances: forward 2e-5 (``tests/layers/test_commuted.py``), fp32 gradients
5e-4 (the same file's gradient checks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config, make_statistics
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu import native
from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build as jax_build
from anemoi_models_tpu.interface import AnemoiModelInterface as JaxInterface
from anemoi_models_tpu.models import AnemoiModelEncProcDecHierarchical as JaxHierarchical
from anemoi_models_tpu.training.loss import weighted_mse as jax_weighted_mse
from anemoi_models_tpu_torch.graphs import build_hierarchical_graph, nodes_from_coords
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDecHierarchical
from anemoi_models_tpu_torch.training import weighted_mse
from anemoi_models_tpu_torch.weights import load_flax_params, to_flax_params

OUT = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)
GRAPH_KW = dict(grid_lat=6, mesh_refinements=2, num_levels=3)


def _jax_graph():
    saved = native._lib
    native._lib = lambda: None  # the numpy code path, as the port's builder
    try:
        return jax_build.build_hierarchical_graph(**GRAPH_KW)
    finally:
        native._lib = saved


def hier_config(hidden_names, level_process=True):
    cfg = make_config("graphtransformer", num_channels=8)
    cfg.graph.hidden = list(hidden_names)
    cfg.model.model._target_ = "anemoi.models.models.hierarchical.AnemoiModelEncProcDecHierarchical"
    cfg.model.enable_hierarchical_level_processing = level_process
    cfg.model.level_process_num_layers = 2
    return cfg


@pytest.fixture(scope="module")
def setup():
    jgraph, names = _jax_graph()
    graph, port_names = build_hierarchical_graph(**GRAPH_KW)
    assert port_names == names
    di = IndexCollection(hier_config(names), dict(VARS))
    n_grid, n_in = graph["data"].num_nodes, len(di.internal_model.input)
    rng = np.random.RandomState(60)
    x = rng.randn(1, 2, 1, n_grid, n_in).astype(np.float32)
    y = rng.randn(1, 1, n_grid, len(di.internal_model.output)).astype(np.float32)
    params = {}
    for level_process in (True, False):
        jmodel = JaxHierarchical(model_config=hier_config(names, level_process), data_indices=di, graph_data=jgraph)
        p = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x))
        params[level_process] = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), p)
    return dict(jgraph=jgraph, graph=graph, names=names, di=di, x=x, y=y, params=params)


def _models(s, level_process=True):
    cfg = hier_config(s["names"], level_process)
    jmodel = JaxHierarchical(model_config=cfg, data_indices=s["di"], graph_data=s["jgraph"])
    model = AnemoiModelEncProcDecHierarchical(model_config=cfg.to_dict(), data_indices=s["di"],
                                              graph_data=s["graph"], device="cpu")
    model.load_state_dict(load_flax_params(s["params"][level_process]), strict=True)
    return jmodel, model


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_hierarchical_graph_matches_jax(setup):
    """Every level's nodes, and every edge set (encoder, each level's own
    mesh, downscale and upscale knn, decoder) with its attributes and CSR
    offsets, equal to the JAX builder's."""
    jgraph, graph = setup["jgraph"], setup["graph"]
    assert list(graph.nodes) == list(jgraph.nodes) and list(graph.edges) == list(jgraph.edges)
    for name, ns in jgraph.node_items():
        np.testing.assert_array_equal(graph[name].coords, ns.coords)
        for key, value in ns.attrs.items():
            np.testing.assert_array_equal(graph[name].attrs[key], value)
    for key, es in jgraph.edge_items():
        np.testing.assert_array_equal(graph[key].edge_index, es.edge_index, err_msg=str(key))
        np.testing.assert_array_equal(graph[key].dst_ptr, es.dst_ptr)
        for name, value in es.attrs.items():
            np.testing.assert_array_equal(graph[key].attrs[name], value, err_msg=f"{key} {name}")


def test_nodes_from_coords_matches_jax():
    rng = np.random.RandomState(61)
    coords = np.stack([rng.uniform(-1.5, 1.5, 50), rng.uniform(-np.pi, np.pi, 50)], axis=-1)
    for weights in (None, rng.rand(50)):
        got, want = nodes_from_coords(coords, weights), jax_build.nodes_from_coords(coords, weights)
        np.testing.assert_array_equal(got.coords, want.coords)
        np.testing.assert_array_equal(got.attrs["area_weight"], want.attrs["area_weight"])
    with pytest.raises(ValueError, match="lat/lon"):
        nodes_from_coords(coords[:, :1])


@pytest.mark.parametrize("level_process", [True, False])
def test_hierarchical_forward_matches_jax(setup, level_process):
    """The forward within 2e-5, with the level processors and without."""
    s = setup
    jmodel, model = _models(s, level_process)
    want = np.asarray(jax.jit(jmodel.apply)(s["params"][level_process], jnp.asarray(s["x"])))
    with torch.no_grad():
        got = model(torch.from_numpy(s["x"])).numpy()
    np.testing.assert_allclose(got, want, **OUT)
    assert bool(model.down_level_processor) == level_process


def test_hierarchical_gradients_match_jax(setup):
    """Every parameter's gradient of the MSE loss against jax.grad, leaf by
    leaf through to_flax_params (the per-level ModuleDicts map to flax's
    down_level_processor_<h>, up_level_processor_<h>, downscale_<h> and
    upscale_<h>)."""
    s = setup
    jmodel, model = _models(s)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jax_weighted_mse(jmodel.apply(p, jnp.asarray(s["x"])), jnp.asarray(s["y"]))))(s["params"][True])
    loss = weighted_mse(model(torch.from_numpy(s["x"])), torch.from_numpy(s["y"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), **OUT)
    want = _flat(grads_ref)
    got = _flat(to_flax_params({k: p.grad for k, p in model.named_parameters()}))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **GRAD)


def test_hierarchical_predict_step_and_flax_round_trip(setup):
    """predict_step through the interface against JAX's, and the flax tree
    through load_flax_params and to_flax_params unchanged."""
    s = setup
    cfg = hier_config(s["names"])
    stats = make_statistics()
    n_in = len(s["di"].data.input.full)
    batch = (stats["mean"][:n_in] + stats["stdev"][:n_in]
             * np.random.RandomState(62).randn(1, 3, s["x"].shape[3], n_in)).astype(np.float32)
    ref = JaxInterface(config=cfg, graph_data=s["jgraph"], statistics=stats, data_indices=s["di"])
    want = np.asarray(ref.make_predict_fn()(s["params"][True], jnp.asarray(batch)))
    iface = AnemoiModelInterface(config=cfg, graph_data=s["graph"], statistics=stats, data_indices=s["di"],
                                 device="cpu")
    iface.load_params(s["params"][True])
    np.testing.assert_allclose(iface.predict_step(torch.from_numpy(batch)).numpy(), want, **OUT)
    back, ref_tree = _flat(to_flax_params(load_flax_params(s["params"][True]))), _flat(s["params"][True])
    assert back.keys() == ref_tree.keys()
    for name in ref_tree:
        np.testing.assert_array_equal(back[name], ref_tree[name], err_msg=name)


def test_hierarchical_checkpoint_round_trip(setup, tmp_path):
    """The port's checkpoint of a hierarchical model: the graph's several
    hidden node sets and the config's list of hidden names survive, and the
    restored interface serves bit for bit."""
    s = setup
    cfg = hier_config(s["names"])
    stats = make_statistics()
    iface = AnemoiModelInterface(config=cfg, graph_data=s["graph"], statistics=stats, data_indices=s["di"],
                                 device="cpu")
    iface.load_params(s["params"][True])
    n_in = len(s["di"].data.input.full)
    batch = torch.from_numpy(np.random.RandomState(63).randn(1, 2, s["x"].shape[3], n_in).astype(np.float32))
    again = AnemoiModelInterface.from_checkpoint(iface.save(str(tmp_path / "ckpt")), device="cpu")
    assert list(again.config.graph.hidden) == s["names"]
    assert list(again.graph_data.nodes) == list(s["graph"].nodes)
    assert isinstance(again.model, AnemoiModelEncProcDecHierarchical)
    torch.testing.assert_close(again.predict_step(batch), iface.predict_step(batch), rtol=0, atol=0)


def test_hierarchical_refuses_levels_smaller_than_the_model_axis(setup):
    """Under a model-sharded mesh every node set splits into the ranks'
    rows; a level with fewer rows than the model axis has ranks is refused
    by name, with the counts, before any collective (the JAX equal-pad split
    has the same limit)."""
    from types import SimpleNamespace

    from anemoi_models_tpu_torch.parallel import use_mesh

    _, model = _models(setup)
    coarsest = setup["names"][-1]
    n = setup["graph"][coarsest].num_nodes
    stub = SimpleNamespace(shape={"data": 1, "model": n + 1}, coords={"data": 0, "model": 0}, rank=0)
    with use_mesh(stub), pytest.raises(ValueError, match=f"{coarsest}.*{n} rows.*{n + 1} model ranks"):
        model(torch.from_numpy(setup["x"]))
