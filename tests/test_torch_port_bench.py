"""PyTorch port, the ``bench`` command and the last public names, on the CPU.

``python -m anemoi_models_tpu_torch bench --device cpu`` at a tiny size
(O6 grid, r2 mesh, C = 32, 2 layers, 2 calls a window) for each flavor and
the hierarchical model, forward and train: its last line is bench.py's JSON
line, its metric string bench.py's format letter for letter. The TPU-only
knobs raise. The configs it shares with ``chip_smoke.py``
(``configs.flagship``, ``configs.flagship_hierarchical``) give the JAX
entry point's parameter tree (names and shapes, through
``weights.to_flax_params``; ``jax.eval_shape``, no compile). The FLOP count
(``ops/cost.py``) of a GraphTransformer forward repeats exactly, its kernel
part is the formulas over the graph's edge sets, and two more processor
layers add the same count each time. The bench's forward is bit for bit
``predict_step``'s model call. Then ``make_predict_fn``, ``as_dotdict`` /
``register`` / ``DotDict.to_dict``, ``morton_order`` and ``gather_nodes``
against the JAX package's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

import __graft_entry__ as graft
from anemoi_models_tpu import native
from anemoi_models_tpu.graphs import build as jax_build
from anemoi_models_tpu.ops.segment import gather_nodes as jax_gather_nodes
from anemoi_models_tpu.utils import config as jax_config
from anemoi_models_tpu_torch import configs
from anemoi_models_tpu_torch.commands import bench, main
from anemoi_models_tpu_torch.data_indices import IndexCollection
from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu_torch.graphs.build import morton_order
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.ops import cost
from anemoi_models_tpu_torch.ops.segment import gather_nodes
from anemoi_models_tpu_torch.utils import config as port_config
from anemoi_models_tpu_torch.weights import to_flax_params

TINY = dict(grid_lat=6, refinements=2, channels=32)
TINY_ARGS = ["--device", "cpu", "--grid-lat", "6", "--refinements", "2", "--channels", "32", "--layers", "2",
             "--iters", "2"]
A2 = 3 + 4 + 1  # edge_length, edge_dirs (2), 4 trainable features and the ones column


@pytest.fixture(scope="module")
def tiny_graph():
    return build_enc_proc_dec_graph(grid_lat=6, grid="octahedral", mesh_refinements=2)


def _bench_line(capsys, argv):
    assert main(["bench", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("model,flavor", [("encprocdec", "graphtransformer"), ("encprocdec", "gnn"),
                                          ("encprocdec", "transformer"), ("hierarchical", "graphtransformer")])
@pytest.mark.parametrize("mode", ["forward", "train"])
def test_bench_prints_bench_py_line(capsys, tiny_graph, model, flavor, mode):
    line = _bench_line(capsys, [*TINY_ARGS, "--model", model, "--flavor", flavor, "--mode", mode])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}  # mfu_frac only on the card
    # bench.py:312-324 and :381-396, with its variables at this configuration
    grid, batch, dtype, n_grid = "O6", 1, "bfloat16", tiny_graph["data"].num_nodes
    step = "train-step" if mode == "train" else "fwd"
    if model == "hierarchical":
        want = (f"hierarchical[3-level] {step} grid-points/s/chip ({grid} grid={n_grid}, B={batch}, mesh_r2, "
                f"C=32, {dtype})")
    else:
        want = (f"enc-proc-dec[{flavor}] {step} grid-points/s/chip ({grid} grid={n_grid}, B={batch}, mesh_r2, "
                f"C=32, L=2, {dtype})")
    assert line["metric"] == want
    assert line["value"] > 0 and line["unit"] == "grid-points/s" and line["vs_baseline"] is None


@pytest.mark.parametrize("name", ["BENCH_GRAPH_IMPL", "BENCH_ATTN_IMPL"])
def test_tpu_only_knobs_raise(monkeypatch, name):
    monkeypatch.setenv(name, "pallas")
    with pytest.raises(ValueError, match="Do not port"):
        main(["bench", *TINY_ARGS])


def _jax_layout(model, x) -> dict:
    shapes = jax.eval_shape(model.init, jax.random.key(0), x)
    return {"/".join(str(k.key) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("model", ["graphtransformer", "hierarchical"])
def test_flagship_configs_give_the_jax_entry_points_tree(monkeypatch, model):
    """configs.flagship / flagship_hierarchical, as the bench builds them, have
    the parameter names and shapes of __graft_entry__._build /
    _build_hierarchical at the same size (both graphs on the numpy path)."""
    monkeypatch.setattr(native, "_lib", lambda: None)
    kw = dict(grid_lat=6, mesh_refinements=2, num_channels=32, num_layers=2, dtype="float32", grid="octahedral")
    if model == "hierarchical":
        jmodel, x, _ = graft._build_hierarchical(num_levels=3, **kw)
    else:
        jmodel, x, _ = graft._build(**kw)
    setup = bench.build(model="hierarchical" if model == "hierarchical" else "encprocdec", layers=2,
                        dtype="float32", device="cpu", **TINY)
    port = {"/".join(("params",) + path): v.shape
            for path, v in _flat(to_flax_params(setup.model.state_dict())["params"]).items()}
    assert port == _jax_layout(jmodel, x)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _gt_forward_count(layers: int) -> cost.FlopCount:
    setup = bench.build(layers=layers, device="cpu", **TINY)
    return bench.flop_count(bench.make_call(setup, "forward"), setup.x)


def test_flop_count_of_a_forward(tiny_graph):
    """Positive, the same twice; the kernel part is the formulas over the
    encoder's, processor's and decoder's edge sets; 2 -> 4 -> 6 layers adds
    the same count each time, two processor layers' worth of kernels."""
    c, h = 32, 4
    counts = {layers: _gt_forward_count(layers) for layers in (2, 4, 6)}
    again = _gt_forward_count(2)
    assert counts[2].total > 0 and counts[2].aten > 0
    assert (again.aten, again.kernels) == (counts[2].aten, counts[2].kernels)

    def node_count(name):
        return tiny_graph[name].num_nodes

    def edges(src, dst):
        return tiny_graph[(src, "to", dst)].edge_index.shape[1]

    def layer(src, dst):  # one GraphTransformer conv: [k|v] of the sources, attention over the edges
        return (cost.kv_proj_flops(node_count(src), c, 2 * c),
                cost.edge_attn_flops(1, edges(src, dst), node_count(dst), c, h, A2))

    sets = [("data", "hidden"), ("hidden", "hidden"), ("hidden", "hidden"), ("hidden", "data")]
    kv, attn = (sum(layer(*s)[i] for s in sets) for i in (0, 1))
    assert counts[2].kernels == {"kv_proj": (4, kv), "edge_attn_csr": (4, attn)}
    one = sum(layer("hidden", "hidden"))
    step = counts[4].total - counts[2].total
    assert step == counts[6].total - counts[4].total
    kernel_step = sum(f for _, f in counts[4].kernels.values()) - sum(f for _, f in counts[2].kernels.values())
    assert kernel_step == 2 * one and step > kernel_step


def test_bench_forward_is_predict_steps_model_call(tiny_graph):
    """The bench's call (no grad, and inside the FLOP counter) gives the bits
    of the model call inside predict_step."""
    cfg = configs.flagship(32, 2, 2, "float32")
    stats = {"mean": np.arange(6.0), "stdev": np.ones(6) + 0.5, "minimum": np.zeros(6), "maximum": np.ones(6) * 9}
    iface = AnemoiModelInterface(config=cfg, graph_data=tiny_graph, statistics=stats,
                                 data_indices=IndexCollection(cfg, bench.NAME_TO_INDEX), device="cpu")
    iface.init_params(torch.Generator().manual_seed(1))
    seen = {}
    hook = iface.model.register_forward_hook(lambda _m, inp, out: seen.update(x=inp[0].clone(), y=out.clone()))
    n_in = len(iface.data_indices.data.input.full)
    iface.predict_step(torch.randn(1, 2, tiny_graph["data"].num_nodes, n_in, generator=torch.Generator().manual_seed(2)))
    hook.remove()
    x = seen["x"].clone()
    with torch.no_grad():
        plain_call = iface.model(x)
        with cost.FlopCount():
            counted_call = iface.model(x)
    assert torch.equal(plain_call, seen["y"]) and torch.equal(counted_call, seen["y"])


def test_make_predict_fn_is_predict_step(tiny_graph):
    cfg = configs.flagship(32, 2, 2, "float32", flavor="gnn")
    stats = {"mean": np.arange(6.0), "stdev": np.ones(6) + 0.5, "minimum": np.zeros(6), "maximum": np.ones(6) * 9}
    iface = AnemoiModelInterface(config=cfg, graph_data=tiny_graph, statistics=stats,
                                 data_indices=IndexCollection(cfg, bench.NAME_TO_INDEX), device="cpu")
    iface.init_params(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    batch = torch.randn(1, 2, tiny_graph["data"].num_nodes, len(iface.data_indices.data.input.full), generator=gen)
    fn = iface.make_predict_fn(donate=True)
    own = {k: v.detach().clone() for k, v in iface.model.named_parameters()}
    assert torch.equal(fn(own, batch), iface.predict_step(batch))
    moved = {k: v + 0.05 * torch.randn(v.shape, generator=gen) for k, v in own.items()}
    got = fn(moved, batch)
    assert not torch.equal(got, iface.predict_step(batch))
    iface.model.load_state_dict(moved, strict=False)
    assert torch.equal(got, iface.predict_step(batch))


def test_config_helpers_match_jax():
    nested = {"a": {"b": [1, {"c": 2}], "t": (3, {"d": 4})}, "e": 5}
    got, want = port_config.as_dotdict(nested), jax_config.as_dotdict(nested)
    assert got.a.b[1].c == want.a.b[1].c == 2 and got.a.t[1].d == 4
    assert got.to_dict() == want.to_dict() == nested
    assert type(got.to_dict()["a"]["t"]) is tuple and type(got.to_dict()["a"]) is dict
    for module in (port_config, jax_config):
        module.register("bench_test.pair")(lambda k, j=0: (k, j))
        module.register("anemoi.models.bench_test.triple")(lambda k: (k, k, k))
    for target, kwargs in (("bench_test.pair", {"k": 1, "j": 2}), ("anemoi.models.bench_test.triple", {"k": 7})):
        cfg = {"_target_": target, **kwargs}
        assert port_config.instantiate(cfg) == jax_config.instantiate(cfg)


def test_morton_order_matches_jax():
    rng = np.random.RandomState(5)
    coords = np.stack([rng.uniform(-np.pi / 2, np.pi / 2, 500), rng.uniform(-np.pi, np.pi, 500)], axis=-1)
    coords[:20] = coords[20:40]  # ties keep their order
    for bits in (16, 10):
        assert np.array_equal(morton_order(coords, bits), jax_build.morton_order(coords, bits))


def test_gather_nodes_matches_jnp_take():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 7, 3).astype(np.float32)
    idx = rng.randint(0, 7, size=11).astype(np.int32)
    got = gather_nodes(torch.from_numpy(x), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), np.asarray(jax_gather_nodes(jnp.asarray(x), jnp.asarray(idx))))
