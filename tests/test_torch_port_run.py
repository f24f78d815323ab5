"""PyTorch port, the training driver on the CPU: ``train_run`` against the
JAX package's ``train_run`` (a 3-step MSE run from the same parameters:
losses within rtol 6e-4, ``tests/parallel/test_fsdp.py:95``; eval scores
within 2e-5 x max(1, mean |ref|)), a JAX run's checkpoint resumed in the port
(its optax moments mapped onto the port's AdamW: one more step, parameters
within 2e-5), exact resume (4 steps against 2 + 2, bit for bit), the ensemble
perturbation and a CRPS run through the curriculum, SIGTERM and the warm
start, and the CLI (train, predict, evaluate).

Sizes are those of ``tests/training/test_run.py`` (a 6-row lat/lon grid,
``mesh_refinements=1``, C = 16, 2 layers), in fp32, where the algorithm and
not bf16's rounding is the point.
"""

import os
import shutil
import signal

import numpy as np
import pytest
import torch

from helpers_torch import one_torch_thread  # noqa: F401 (autouse)
from anemoi_models_tpu.graphs import latlon_grid_nodes
from anemoi_models_tpu.training import train_run as jax_train_run
from anemoi_models_tpu.training.dataset import SyntheticSource as JaxSource
from anemoi_models_tpu_torch.checkpoint import load_checkpoint
from anemoi_models_tpu_torch.training import SyntheticSource, train_run
from anemoi_models_tpu_torch.training.run import perturb_members
from anemoi_models_tpu_torch.weights import to_flax_params

TINY = dict(
    mesh_refinements=1,
    model_kwargs=dict(num_channels=16, num_layers=2, num_heads=2, num_chunks=1, trainable_hidden=2,
                      trainable_edges=2, compute_dtype="float32"),
    batch_size=2,
    log_every=1,
    forcing=("var_0",),
    peak_lr=5e-3,
    seed=2,
)
PORT = dict(TINY, device="cpu", log=lambda s: None)


def _source(cls=SyntheticSource):
    return cls(latlon_grid_nodes(6).coords, num_vars=4, num_steps=24, seed=1)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One 3-step JAX run that saves every step, keeping the checkpoints of
    steps 1 (the initial parameters: the schedule's first update has lr 0)
    and 2 as they were when the next step logged."""
    root = tmp_path_factory.mktemp("jax_run")
    kept = {}

    def log(msg):
        for step, name in (("2", "ck1"), ("3", "ck2")):
            if msg.startswith(f"step {step:>6}"):
                shutil.copytree(root / "run" / "latest", root / name / "latest")
                shutil.copy(root / "run" / "graph.npz", root / name / "graph.npz")
                kept[name] = str(root / name)

    result = jax_train_run(_source(JaxSource), steps=3, save_every=1, eval_every=3, eval_rollout=2,
                           checkpoint_dir=str(root / "run"), log=log, **TINY)
    assert set(kept) == {"ck1", "ck2"}
    return result, kept


def test_train_run_matches_jax(jax_run):
    """From the JAX run's initial parameters (``init_from``), the port's
    3-step run gives JAX's losses and its held-out rollout scores."""
    want, kept = jax_run
    got = train_run(_source(), steps=3, eval_every=3, eval_rollout=2,
                    init_from=os.path.join(kept["ck1"], "latest"), **PORT)
    assert got["steps_done"] == 3 and len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=6e-4)
    (g_eval,), (w_eval,) = got["eval"], want["eval"]
    assert g_eval["step"] == w_eval["step"] == 3
    ref = np.asarray(w_eval["rmse"])
    np.testing.assert_allclose(g_eval["rmse"], ref, rtol=0, atol=2e-5 * max(1.0, float(np.abs(ref).mean())))


def test_remat_auto_run_matches_jax(jax_run):
    """``remat_policy="auto"``: the CPU has no memory budget, so it resolves
    to "full" (logged), as the JAX package's does there, and the run gives
    the JAX run's losses (the JAX run trains under "full")."""
    want, kept = jax_run
    msgs = []
    got = train_run(_source(), steps=3, eval_every=3, eval_rollout=2, init_from=os.path.join(kept["ck1"], "latest"),
                    **dict(PORT, model_kwargs=dict(TINY["model_kwargs"], remat_policy="auto"), log=msgs.append))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=6e-4)
    assert "remat auto: unknown device memory budget; using 'full'" in msgs
    assert [chunk.remat_policy for chunk in got["model"].processor.proc] == ["full"]


def _key_bias(name: str, value: np.ndarray) -> slice | None:
    """The key columns of an attention bias (``lin_kv``: [k | v];
    ``lin_qkvs``: [q | k | v | s]). A key bias shifts every logit of a
    destination's softmax alike, so the loss does not depend on it: its
    gradient is zero up to rounding, and Adam's normalization turns that
    rounding into steps of about the learning rate."""
    if name.endswith("lin_kv/bias"):
        return slice(0, value.size // 2)
    if name.endswith("lin_qkvs/bias"):
        return slice(value.size // 4, value.size // 2)
    return None


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    """A JAX run's step-2 checkpoint (parameters, optax moments and count,
    sampler) resumes in the port: one more step gives the JAX run's
    step-3 parameters within 2e-5, but for the key biases, which the loss
    does not depend on (``_key_bias``): they are held to no value."""
    want, kept = jax_run
    ckpt = tmp_path / "resume"
    shutil.copytree(kept["ck2"], ckpt)
    got = train_run(_source(), steps=3, resume=True, checkpoint_dir=str(ckpt), eval_every=3, eval_rollout=2,
                    **PORT)
    assert got["steps_done"] == 3 and got["optimizer"].count == 3
    np.testing.assert_allclose(got["losses"], want["losses"][2:], rtol=6e-4)
    flat_got = _flat(to_flax_params(got["model"].state_dict()))
    flat_want = _flat(want["state"].params)
    assert flat_got.keys() == flat_want.keys()
    for name, value in flat_want.items():
        got_v = flat_got[name].copy()
        if (keys := _key_bias(name, value)) is not None:
            got_v[keys] = value[keys]
        np.testing.assert_allclose(got_v, value, rtol=0, atol=2e-5, err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_resume_is_exact(tmp_path):
    """4 steps against 2 (boxed by max_steps_this_run) + a resume for 2 more:
    the same losses, evals, parameters, AdamW moments and count, EMA and
    metrics, bit for bit; a third call has nothing to do."""
    common = dict(steps=4, ema_decay=0.99, save_every=2, eval_every=2, eval_rollout=2, **PORT)
    full = train_run(_source(), checkpoint_dir=str(tmp_path / "a"), **common)
    part = train_run(_source(), checkpoint_dir=str(tmp_path / "b"), max_steps_this_run=2, **common)
    rest = train_run(_source(), checkpoint_dir=str(tmp_path / "b"), resume=True, **common)
    assert part["steps_done"] == 2 and rest["steps_done"] == 4
    assert part["losses"] + rest["losses"] == full["losses"]
    assert [e["rmse"] for e in part["eval"] + rest["eval"]] == [e["rmse"] for e in full["eval"]]
    a, b = dict(full["model"].named_parameters()), dict(rest["model"].named_parameters())
    for name, p in a.items():
        assert torch.equal(p, b[name]), name
        assert torch.equal(full["ema"][name], rest["ema"][name]), name
        sa, sb = full["optimizer"].state[p], rest["optimizer"].state[b[name]]
        assert torch.equal(sa["mu"], sb["mu"]) and torch.equal(sa["nu"], sb["nu"]), name
    assert full["optimizer"].count == rest["optimizer"].count == 4
    lines = [open(tmp_path / d / "metrics.jsonl").read().splitlines() for d in ("a", "b")]
    assert [ln.split('"steps_per_s"')[0] for ln in lines[0]] == [ln.split('"steps_per_s"')[0] for ln in lines[1]]
    assert os.path.exists(tmp_path / "b" / "graph.npz")
    again = train_run(_source(), checkpoint_dir=str(tmp_path / "b"), resume=True, **common)
    assert again["steps_done"] == 4 and again["losses"] == []


def test_ensemble_crps_curriculum_run():
    """Ensemble members: the noise has std perturb_sigma, leaves the forcing
    columns at truth, follows the step and repeats for the same step; a
    2-member CRPS run through the rollout curriculum with EMA trains."""
    x0 = torch.zeros(1, 2, 1, 500, 4)
    x0[..., 0] = 3.0
    got = perturb_members(x0, 4, 0.05, 7, 5, np.asarray([0]))
    assert got.shape == (1, 2, 4, 500, 4)
    assert torch.equal(got[..., 0], torch.full_like(got[..., 0], 3.0))
    assert abs(float(got[..., 1:].std()) - 0.05) < 0.05 * 0.05
    assert torch.equal(got, perturb_members(x0, 4, 0.05, 7, 5, np.asarray([0])))
    assert not torch.equal(got, perturb_members(x0, 4, 0.05, 7, 6, np.asarray([0])))
    run = train_run(_source(), steps=4, ensemble=2, loss="crps", rollout_schedule=[(0, 1), (2, 2)], ema_decay=0.9,
                    **PORT)
    assert run["steps_done"] == 4 and np.isfinite(run["losses"]).all()
    with pytest.raises(ValueError, match="needs a mesh|pass mesh="):
        train_run(_source(), steps=1, param_sharding="zero1", **PORT)


def test_steps_per_call_changes_no_number(tmp_path):
    """steps_per_call is accepted and runs every step as its own call: 4
    steps at steps_per_call = 2 (a save every 2 steps) give the losses,
    logged steps, parameters and checkpoint of steps_per_call = 1 bit for
    bit."""
    runs = {}
    for spc in (1, 2):
        lines = []
        run = train_run(_source(), steps=4, steps_per_call=spc, save_every=2, checkpoint_dir=str(tmp_path / str(spc)),
                        **{**PORT, "log": lines.append})
        runs[spc] = (run, [int(line.split()[1]) for line in lines if line.startswith("step ")])
    (base, logged), (run, got) = runs[1], runs[2]
    assert logged == [1, 2, 3, 4] and got == logged and base["steps_done"] == run["steps_done"] == 4
    assert run["losses"] == base["losses"]
    for name, p in base["model"].named_parameters():
        assert torch.equal(dict(run["model"].named_parameters())[name], p), name
    assert load_checkpoint(str(tmp_path / "2" / "latest"))["step"] == 4


def test_sigterm_checkpoints_and_init_from_warm_starts(tmp_path):
    """SIGTERM during step 2 finishes it, checkpoints at step 2 and returns
    interrupted; a new run warm-started from that checkpoint begins from
    its parameters with a fresh optimizer."""

    def log(msg):
        if msg.startswith("step      2"):
            os.kill(os.getpid(), signal.SIGTERM)

    run = train_run(_source(), steps=6, checkpoint_dir=str(tmp_path / "a"), overlap_calls=False, **{**PORT, "log": log})
    assert run.get("interrupted") and run["steps_done"] == 2
    saved = load_checkpoint(str(tmp_path / "a" / "latest"))
    assert saved["step"] == 2 and saved["metadata"]["sampler"]["position"] == 2
    warm = train_run(_source(), steps=1, init_from=str(tmp_path / "a" / "latest"), **PORT)
    for name, p in warm["model"].named_parameters():  # the first update has lr 0: the donor's parameters
        assert torch.equal(p, saved["params"][name]), name
    assert warm["optimizer"].count == 1


def test_cli_train_predict_evaluate(tmp_path, capsys):
    """``python -m anemoi_models_tpu_torch`` train -> predict -> evaluate on
    the CPU, on a synthetic run and a zarr store the port wrote."""
    from anemoi_models_tpu_torch.commands import main
    from anemoi_models_tpu_torch.training import save_zarr_dataset

    ck = str(tmp_path / "ck")
    assert main(["train", "--synthetic", "--grid-lat", "6", "--num-vars", "4", "--num-steps", "24", "--steps", "2",
                 "--channels", "16", "--layers", "2", "--heads", "2", "--mesh-refinements", "1", "--forcing",
                 "var_0", "--checkpoint-dir", ck, "--device", "cpu", "--seed", "1"]) == 0
    src = _source()
    store = str(tmp_path / "ds.zarr")
    save_zarr_dataset(store, np.stack([src.window(t, 1)[0] for t in range(len(src))]), src.variables, src.coords,
                      src.statistics)
    out = str(tmp_path / "fc.npz")
    assert main(["predict", os.path.join(ck, "latest"), store, "--steps", "2", "--output", out, "--device", "cpu"]) == 0
    fc = np.load(out)["forecast"]
    assert fc.shape == (2, src.coords.shape[0], 3) and np.isfinite(fc).all()
    capsys.readouterr()
    assert main(["evaluate", os.path.join(ck, "latest"), store, "--rollout", "2", "--device", "cpu", "--json"]) == 0
    import json

    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(scores["rmse"]).all() and len(scores["rmse"]) == 2


def test_hierarchical_run_serves_and_evaluates(tmp_path):
    """The hierarchical architecture through train_run (its graph from the
    source's coordinates, variable loss weights), its checkpoint served by
    ``from_checkpoint`` from the graph-once layout and scored with ACC and
    a 3-member ensemble (CRPS, spread)."""
    from anemoi_models_tpu_torch.interface import AnemoiModelInterface
    from anemoi_models_tpu_torch.training import evaluate_interface

    run = train_run(_source(), architecture="hierarchical", num_hidden_levels=2, steps=2,
                    variable_loss_weights={"var_1": 2.0}, checkpoint_dir=str(tmp_path), **PORT)
    assert run["steps_done"] == 2 and np.isfinite(run["losses"]).all()
    with pytest.raises(ValueError, match="non-output"):
        train_run(_source(), steps=1, variable_loss_weights={"nope": 1.0}, **PORT)
    served = AnemoiModelInterface.from_checkpoint(str(tmp_path / "latest"), device="cpu")
    scores = evaluate_interface(served, _source(), n_steps=2, acc=True, ensemble=3)
    assert scores["rmse"].shape == scores["acc"].shape == (2, 3) and scores["crps"].shape == (2,)
    assert all(np.isfinite(v).all() for v in scores.values())
