"""PyTorch port, ZeRO-1 / FSDP and ``train_run`` on a mesh, against the JAX
package on the CPU.

Four gloo ranks (``helpers_parallel``, spawned once in a module fixture) run
the port's ``train_run`` on a data = 2 x model = 2 mesh with the TINY config
of ``tests/parallel/test_fsdp.py`` (C = 16, 2 layers, an 8-row grid, 4 steps
at peak lr 2e-3, min size 64 on both sides, fp32), from the port's initial
parameters, which the JAX run takes too (written as a JAX checkpoint). The
JAX side runs once, in this process on the 8-device CPU mesh of
``tests/conftest.py``, with ``param_sharding="fsdp"`` on the same mesh
shape; its own tests hold its None / zero1 / fsdp runs to one another at the
tolerances used here (``test_fsdp.py:95``: losses rtol 6e-4, atol 2e-5;
``:109``: parameters atol 5e-3), so one JAX run stands for the three modes
(each JAX run of this size compiles for about a minute here). The ranks
also run zero1 with an EMA, an FSDP run checkpointed at step 2 and resumed
(``:126-143``: rtol 1e-5, atol 1e-6, and the checkpoint served unsharded)
and a hybrid (2, 1, 2) mesh's run (``tests/training/test_run.py:224-248``),
while a second spawn runs ``train --data-parallel 2`` under a torchrun-like
launch environment; the JAX run goes on meanwhile.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from helpers_parallel import cli_task, fsdp_task, start, tasks
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

import anemoi_models_tpu.parallel.fsdp as jax_fsdp
from anemoi_models_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from anemoi_models_tpu.graphs import latlon_grid_nodes
from anemoi_models_tpu.parallel import make_hybrid_mesh as jax_make_hybrid_mesh
from anemoi_models_tpu.parallel import make_mesh as jax_make_mesh
from anemoi_models_tpu.training import train_run as jax_train_run
from anemoi_models_tpu.training.dataset import SyntheticSource as JaxSource
from anemoi_models_tpu_torch.commands import main as port_main
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.parallel import hybrid_rank_grid
from anemoi_models_tpu_torch.parallel.fsdp import _leaf_spec, train_state_shardings
from anemoi_models_tpu_torch.training import SyntheticSource, train_run
from anemoi_models_tpu_torch.weights import to_flax_params

COMMON = dict(forcing=("var_0",), steps=4, peak_lr=2e-3, seed=0, mesh_refinements=1, batch_size=2, log_every=1,
              model_kwargs=dict(num_channels=16, num_layers=2, num_heads=2, num_chunks=1, trainable_hidden=2,
                                trainable_edges=2, compute_dtype="float32"))
MODES = ("None", "zero1", "fsdp")
LOSS = dict(rtol=6e-4, atol=2e-5)  # tests/parallel/test_fsdp.py:95
CLI_ARGS = ["--synthetic", "--grid-lat", "6", "--num-vars", "4", "--num-steps", "24", "--steps", "2",
            "--batch-size", "2", "--channels", "16", "--layers", "2", "--heads", "2", "--mesh-refinements", "1",
            "--device", "cpu"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    # the port's initial parameters: a run boxed at one step (the schedule's first update has lr 0)
    coords = latlon_grid_nodes(8).coords
    first = train_run(SyntheticSource(coords, num_vars=4, num_steps=48, seed=1), max_steps_this_run=1,
                      checkpoint_dir=str(root / "init"), device="cpu", log=lambda s: None, **COMMON)
    init = os.path.join(first["checkpoint"])
    jax_init = jax_save_checkpoint(str(root / "jax_init"), params=to_flax_params(first["model"].state_dict()))
    ranks = start(tasks, 4, str(root / "ranks"),
                  {"fsdp": (fsdp_task, ({"common": COMMON, "init": init, "root": str(root / "runs")},))})
    cli = start(cli_task, 2, str(root / "cli"),
                CLI_ARGS + ["--data-parallel", "2", "--backend", "gloo", "--checkpoint-dir", str(root / "cli_run")],
                init=False)
    saved = jax_fsdp.DEFAULT_MIN_SIZE
    jax_fsdp.DEFAULT_MIN_SIZE = 64  # as tests/parallel/test_fsdp.py:80-85 patches it
    try:
        want = jax_train_run(JaxSource(coords, num_vars=4, num_steps=48, seed=1), mesh=jax_make_mesh(data=2, model=2),
                             param_sharding="fsdp", init_from=jax_init, log=lambda s: None, **COMMON)
    finally:
        jax_fsdp.DEFAULT_MIN_SIZE = saved
    return {"ranks": ranks(), "cli": cli(), "jax": want, "root": root}


@pytest.mark.parametrize("shape,axis_size,min_size", [
    ((64, 256), 4, 1024), ((510, 256), 4, 1024), ((510, 255), 4, 1024), ((8, 8), 4, 1024),
    ((256, 256), 2, 2**15), ((3, 16, 16), 2, 64), ((16, 16, 3), 4, 64), ((1024,), 2, 64), ((2, 2), 8, 1),
])
def test_leaf_spec_matches_jax(shape, axis_size, min_size):
    """The leaf rule, as the JAX package's: the largest dimension the axis
    size divides, small or indivisible leaves replicated."""
    assert _leaf_spec(shape, axis_size, "data", min_size) == tuple(jax_fsdp._leaf_spec(shape, axis_size, "data",
                                                                                       min_size))


def test_train_state_shardings_rejects_other_modes():
    with pytest.raises(ValueError, match="zero1"):
        train_state_shardings(torch.nn.Linear(2, 2), None, mode="zero3")


@pytest.mark.parametrize("mode", MODES)
def test_sharded_train_run_matches_jax(runs, mode):
    """The port's 4-step run on the (2, 2) mesh under each mode: the JAX fsdp
    run's losses (rtol 6e-4, atol 2e-5) and its final parameters (atol
    5e-3), the same losses on every rank."""
    want = runs["jax"]
    got = [r["fsdp"][mode] for r in runs["ranks"]]
    assert all(g["losses"] == got[0]["losses"] for g in got)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], **LOSS)
    flat_got = _flat(to_flax_params({k: torch.from_numpy(v) for k, v in got[0]["params"].items()}))
    flat_want = _flat(jax.tree_util.tree_map(np.asarray, want["state"].params))
    assert flat_got.keys() == flat_want.keys()
    for name, value in flat_want.items():
        np.testing.assert_allclose(flat_got[name], value, rtol=0, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_moments_and_parameters_are_sharded(runs, mode):
    """Each rank holds half of every sharded leaf's moments under zero1 and
    fsdp, and of its parameter under fsdp only; None shards nothing."""
    layout = runs["ranks"][0]["fsdp"][mode]["layout"]
    full = runs["ranks"][0]["fsdp"]["None"]["layout"]
    moments = [k for k, v in layout.items() if v["mu"] != full[k]["param"]]
    params = [k for k, v in layout.items() if v["param"] != full[k]["param"]]
    if mode == "None":
        assert not moments and not params
        return
    assert moments, "the moments must be sharded"
    for k in moments:
        assert np.prod(layout[k]["mu"]) * 2 == np.prod(full[k]["param"]), k
    assert (params == moments) if mode == "fsdp" else not params


def test_zero1_with_ema(runs):
    """zero1 with an EMA: finite losses, sharded moments, the EMA whole."""
    for rank in runs["ranks"]:
        got, full = rank["fsdp"]["zero1_ema"], rank["fsdp"]["None"]["layout"]
        assert np.isfinite(got["losses"]).all()
        assert any(v["mu"] != full[k]["param"] for k, v in got["layout"].items())
        assert all(v["ema"] == full[k]["param"] for k, v in got["layout"].items())


def test_fsdp_checkpoint_round_trip(runs):
    """An FSDP run saved at step 2 and resumed to 4 gives the uninterrupted
    run's parameters; the checkpoint is the unsharded format, served by an
    unsharded interface with the gathered parameters."""
    for rank in runs["ranks"]:
        rt = rank["fsdp"]["roundtrip"]
        assert rt["steps"] == 4
        for name, value in rt["full"].items():
            np.testing.assert_allclose(rt["resumed"][name], value, rtol=1e-5, atol=1e-6, err_msg=name)
    rt = runs["ranks"][0]["fsdp"]["roundtrip"]
    served = AnemoiModelInterface.from_checkpoint(rt["checkpoint"], device="cpu")
    for name, p in served.model.named_parameters():
        assert np.array_equal(p.detach().numpy(), rt["full"][name]), name


def test_hybrid_mesh_rank_grid_matches_jax():
    """make_hybrid_mesh's ranks, as the JAX package orders its devices where
    they have no slice topology: consecutive ranks in a model group."""
    want = np.vectorize(lambda d: d.id)(jax_make_hybrid_mesh(2, 2, 2).devices)
    np.testing.assert_array_equal(hybrid_rank_grid(2, 2, 2), want)


def test_hybrid_mesh_run_writes_metrics(runs):
    """A (2, 1, 2) hybrid mesh trains, and rank 0 alone writes
    metrics.jsonl with steps [1, 2]."""
    for r, rank in enumerate(runs["ranks"]):
        got = rank["fsdp"]["hybrid"]
        assert got["shape"] == {"data": 2, "model": 2} and got["coords"] == {"data": r // 2, "model": r % 2}
        assert got["steps"] == 2 and np.isfinite(got["losses"]).all()
    with open(runs["root"] / "runs" / "hybrid" / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    assert [r["step"] for r in records] == [1, 2]


def test_ranks_import_no_jax(runs):
    assert all(not rank["leaked"] for rank in runs["ranks"])
    assert all(not rank["leaked"] for rank in runs["cli"])


def test_cli_data_parallel(runs):
    """``train --data-parallel 2`` in two ranks of a torchrun-like launch
    environment: both finish, rank 0 reports and checkpoints, the process
    group is left."""
    out = runs["cli"]
    assert [r["rc"] for r in out] == [0, 0] and all(r["group_left"] for r in out)
    assert "loss: first" in out[0]["printed"] and "checkpoint:" in out[0]["printed"]
    served = AnemoiModelInterface.from_checkpoint(str(runs["root"] / "cli_run" / "latest"), device="cpu")
    assert served.model is not None


@pytest.mark.parametrize("env,args,match", [
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}, ["--backend", "gloo"], "RANK"),
    ({"RANK": "0", "WORLD_SIZE": "3", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}, ["--backend", "gloo"],
     "WORLD_SIZE is 3"),
    ({"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}, [], "--backend"),
])
def test_cli_data_parallel_refusals(monkeypatch, env, args, match):
    """No launch environment, a world of another size, or no backend: the
    command refuses by name, before it joins any process group."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(SystemExit, match=match):
        port_main(["train", *CLI_ARGS, "--data-parallel", "2", *args])
