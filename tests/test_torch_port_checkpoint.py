"""PyTorch port, checkpoints and the graph container against the JAX package
on the CPU: a checkpoint the JAX package wrote (format 2, and the format-1
layout) served from the port, the port's own save and load, ``graph.npz``
both ways, the refusals, and that reading a JAX checkpoint needs no JAX.

The model is the GraphTransformer of ``helpers_models.make_config`` on
``grid_lat=6, mesh_refinements=2`` with the JAX model's initialisation,
perturbed. Tolerance: ``predict_step`` 2e-5 (``tests/layers/test_commuted.py``);
the port's own round trip is bit for bit.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config, make_statistics
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import HeteroGraph as JaxGraph
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.interface import AnemoiModelInterface as JaxInterface
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from anemoi_models_tpu_torch.graphs import HeteroGraph
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.training import make_optimizer

OUT = dict(atol=2e-5, rtol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METADATA = {"dataset": {"resolution": "o6"}, "version": "unit"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    stats = make_statistics()
    rng = np.random.RandomState(50)
    n_grid, n_in = graph["data"].num_nodes, len(di.data.input.full)
    x = jnp.zeros((1, 2, 1, n_grid, len(di.internal_model.input)))
    params = jax.jit(JaxModel(model_config=cfg, data_indices=di, graph_data=graph).init)(jax.random.key(0), x)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    batch = (stats["mean"][:n_in] + stats["stdev"][:n_in] * rng.randn(1, 3, n_grid, n_in)).astype(np.float32)
    jax_iface = JaxInterface(config=cfg, graph_data=graph, statistics=stats, data_indices=di, metadata=METADATA,
                             supporting_arrays={"latitudes": np.linspace(-90, 90, n_grid)})
    jax_iface.params = params
    want = np.asarray(jax_iface.make_predict_fn()(params, jnp.asarray(batch)))
    path = jax_iface.save(str(tmp_path_factory.mktemp("jax") / "ckpt"), step=5)
    return dict(graph=graph, cfg=cfg, di=di, stats=stats, params=params, batch=batch, jax_iface=jax_iface,
                want=want, path=path, tmp=tmp_path_factory)


def _predict(iface, batch):
    return iface.predict_step(torch.from_numpy(batch)).numpy()


def test_jax_checkpoint_serves_from_port(setup):
    """JAX AnemoiModelInterface.save (graph included) -> the port's
    from_checkpoint: predict_step within 2e-5 of JAX's, with the same
    metadata, supporting arrays and id."""
    s = setup
    iface = AnemoiModelInterface.from_checkpoint(s["path"], device="cpu")
    np.testing.assert_allclose(_predict(iface, s["batch"]), s["want"], **OUT)
    assert iface.metadata == METADATA
    assert iface.id == s["jax_iface"].id
    assert iface.supporting_arrays.keys() == {"latitudes"}
    np.testing.assert_array_equal(iface.supporting_arrays["latitudes"], s["jax_iface"].supporting_arrays["latitudes"])
    restored = load_checkpoint(s["path"])
    assert restored["step"] == 5 and restored["format_version"] == 2


def test_jax_format1_checkpoint_loads(setup):
    """The format-1 layout (the forward mapper's emb_nodes_src in the mapper
    scope, as the wide kv_src_gather stores it) loads into the same port
    parameters as format 2, and serves within 2e-5."""
    s = setup
    old = {"params": dict(s["params"]["params"])}
    encoder = dict(old["params"]["encoder"])
    proc = dict(encoder["proc"])
    encoder["emb_nodes_src"] = proc.pop("emb_nodes_src")
    encoder["proc"] = proc
    old["params"]["encoder"] = encoder
    path = s["tmp"].mktemp("fmt1") / "ckpt"
    meta = {"name_to_index": dict(s["di"].name_to_index), "statistics": {k: v.tolist() for k, v in s["stats"].items()}}
    jax_save_checkpoint(str(path), params=old, metadata=meta, config=s["cfg"].to_dict(),
                        supporting_arrays={f"graph::{k}": v for k, v in s["graph"].to_arrays().items()})
    with open(path / "meta.json") as fh:
        sidecar = json.load(fh)
    with open(path / "meta.json", "w") as fh:
        json.dump({**sidecar, "format_version": 1}, fh)
    iface = AnemoiModelInterface.from_checkpoint(str(path), device="cpu")
    ref = AnemoiModelInterface.from_checkpoint(s["path"], device="cpu")
    for name, value in ref.model.state_dict().items():
        torch.testing.assert_close(iface.model.state_dict()[name], value, rtol=0, atol=0, msg=name)
    np.testing.assert_allclose(_predict(iface, s["batch"]), s["want"], **OUT)


@pytest.mark.parametrize("include_graph", [True, False])
def test_port_round_trip(setup, include_graph):
    """The port's save -> load: the state dict, the optimizer's state and
    predict_step bit for bit; without the graph, from a graph.npz beside the
    checkpoint."""
    s = setup
    src = AnemoiModelInterface.from_checkpoint(s["path"], device="cpu")
    opt = make_optimizer(src.model.parameters(), 1e-3)
    opt.count = 3
    root = s["tmp"].mktemp("port")
    path = src.save(str(root / "ckpt"), optimizer=opt, step=7, include_graph=include_graph)
    if not include_graph:
        with pytest.raises(ValueError, match="graph.npz"):
            AnemoiModelInterface.from_checkpoint(path, device="cpu")
        src.graph_data.save(str(root / "graph.npz"))
    back = AnemoiModelInterface.from_checkpoint(path, device="cpu")
    for name, value in src.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[name], value), name
    np.testing.assert_array_equal(_predict(back, s["batch"]), _predict(src, s["batch"]))
    assert back.id == src.id and back.metadata == src.metadata
    restored = load_checkpoint(path)
    assert restored["step"] == 7 and restored["opt_state"]["count"] == 3
    opt2 = make_optimizer(back.model.parameters(), 1e-3)
    opt2.load_state_dict(restored["opt_state"])
    assert opt2.count == 3
    assert ("graph::node::data::coords" in restored["supporting_arrays"]) == include_graph


def test_graph_npz_both_ways(setup, tmp_path):
    """A graph.npz written by either package loads in the other with the
    same keys and arrays."""
    s = setup
    arrays = s["graph"].to_arrays()
    port_graph = HeteroGraph.from_arrays(arrays)
    for writer, reader in ((JaxGraph.from_arrays(arrays), HeteroGraph), (port_graph, JaxGraph)):
        path = writer.save(str(tmp_path / f"{type(writer).__module__.split('.')[0]}.npz"))
        got = reader.load(path).to_arrays()
        assert got.keys() == arrays.keys()
        for key, value in arrays.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_checkpoint_without_variable_table_raises(setup, tmp_path):
    s = setup
    src = AnemoiModelInterface.from_checkpoint(s["path"], device="cpu")
    path = save_checkpoint(str(tmp_path / "bare"), params=src.model.state_dict(), config=dict(s["cfg"]))
    with pytest.raises(ValueError, match="variable"):
        AnemoiModelInterface.from_checkpoint(path, device="cpu")


def test_jax_checkpoint_reads_without_jax(setup):
    """Reading a JAX checkpoint in a fresh process imports neither JAX nor
    orbax nor the JAX package."""
    code = (
        "import sys\n"
        "from anemoi_models_tpu_torch.checkpoint import load_checkpoint\n"
        f"r = load_checkpoint({setup['path']!r})\n"
        "assert 'params' in r and r['metadata']['name_to_index']\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',"
        " 'anemoi_models_tpu'))\n"
        "print('leaked', leaked)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "leaked []" in out.stdout, out.stdout
