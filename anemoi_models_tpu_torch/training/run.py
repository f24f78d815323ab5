"""End-to-end training driver: dataset -> graph -> model -> training loop.

Counterpart of ``anemoi_models_tpu/training/run.py:train_run``, with the
same arguments and the same run on the card:

- the graph is built from the dataset's own coordinates
  (``nodes_from_coords``), for either architecture;
- a background ``BatchLoader`` and ``device_prefetch`` (pinned buffers, a
  side CUDA stream) keep the card fed;
- single-step or rollout training (the curriculum ``rollout_schedule``),
  the preprocessing on the card;
- AdamW with warmup and cosine decay, parameter EMA, periodic rollout
  evaluation on a held-out tail, ``metrics.jsonl``;
- checkpoints in the graph-once layout (``graph.npz`` beside ``latest``)
  with exact resume: parameters, AdamW moments and count, EMA, the
  sampler's position. A checkpoint the JAX package's ``train_run`` wrote
  resumes here too (its optax moments map onto the port's AdamW,
  ``checkpoint.load_jax_opt_state``);
- on a (data, model) ``mesh`` of ranks (``parallel.make_mesh``): each rank
  trains on its rows of every batch (the batch rows its ``data`` index owns,
  in the unsharded run's sample order, and its grid rows of the ``model``
  axis), with ``param_sharding`` ``"zero1"`` or ``"fsdp"`` over
  ``param_sharding_axis`` (``parallel.fsdp``). Rank 0 writes the logs,
  ``metrics.jsonl`` and the checkpoints, in the unsharded format;
  evaluations run whole on every rank.

``remat_policy="auto"`` in ``model_kwargs`` builds the model with
``"none"``, estimates the memory of the step variant the run executes
(``training.step.resolve_remat_policy``: the longest curriculum rollout, the
ensemble axis, the run's loss, the EMA) and rebuilds it with ``"full"``
where that does not fit the card, as the JAX package's ``train_run`` does;
with a ``config`` given, ``"auto"`` in ``model_kwargs`` means ``"full"``.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from anemoi_models_tpu_torch.ops.flash_attention import fold_key
from anemoi_models_tpu_torch.parallel.api import use_mesh
from anemoi_models_tpu_torch.parallel.fsdp import check_mode, shard_train_state
from anemoi_models_tpu_torch.training.evaluate import evaluate_interface
from anemoi_models_tpu_torch.training.loader import BatchLoader, WindowSampler, device_prefetch
from anemoi_models_tpu_torch.training.loss import WeightedCRPSLoss, WeightedMSELoss, loss_mask
from anemoi_models_tpu_torch.training.optim import ema_update, make_optimizer
from anemoi_models_tpu_torch.training.step import (
    dropout_twin,
    make_rollout_train_step,
    make_train_step,
    resolve_remat_policy,
)

__all__ = ["perturb_members", "train_run"]


def _wants_dropout(model_config) -> bool:
    """True if any sub-config under config.model declares dropout_p > 0."""

    def walk(node) -> bool:
        if isinstance(node, dict):
            for key, value in node.items():
                if key == "dropout_p" and float(value or 0.0) > 0.0:
                    return True
                if walk(value):
                    return True
        return False

    return walk(model_config)


def _params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {name: p.detach() for name, p in model.named_parameters()}


def train_run(
    source,
    *,
    config=None,
    forcing: tuple = (),
    diagnostic: tuple = (),
    flavor: str = "graphtransformer",
    architecture: str = "enc_proc_dec",
    num_hidden_levels: int = 2,
    mesh_refinements: int = 3,
    model_kwargs: Optional[dict] = None,
    steps: int = 100,
    max_steps_this_run: Optional[int] = None,
    batch_size: int = 2,
    rollout: int = 1,
    rollout_schedule=None,
    variable_loss_weights: Optional[dict] = None,
    ensemble: int = 1,
    perturb_sigma: float = 0.05,
    loss: str = "mse",
    peak_lr: float = 1e-3,
    warmup_steps: Optional[int] = None,
    weight_decay: float = 0.0,
    ema_decay: Optional[float] = None,
    checkpoint_dir: Optional[str] = None,
    save_every: int = 0,
    resume: bool = False,
    init_from: Optional[str] = None,
    eval_every: int = 0,
    eval_rollout: int = 4,
    mesh=None,
    param_sharding: Optional[str] = None,
    param_sharding_axis: str = "data",
    seed: int = 0,
    log_every: int = 10,
    log: Callable[[str], None] = print,
    loader_depth: int = 4,
    loader_workers: int = 1,
    prefetch: int = 2,
    steps_per_call: int = 1,
    overlap_calls: bool = True,
    handle_signals: bool = True,
    profile_dir: Optional[str] = None,
    profile_steps: tuple = (10, 13),
    device="cuda",
) -> dict:
    """Train a forecast model on ``source``; returns a run summary dict.

    The arguments are the JAX package's (see its ``train_run``), plus
    ``device`` (the card unless the caller names another). ``rollout`` > 1
    trains through that many autoregressive steps per update;
    ``rollout_schedule`` ``[(0, 1), (5000, 2)]`` is the curriculum.
    ``ensemble`` > 1 trains M members on the model's ensemble axis from
    normalized-space perturbations of the prognostic inputs
    (``perturb_sigma``, forcing columns pinned, drawn by a CPU
    ``torch.Generator`` seeded from ``(seed + 1, step)``, so a resumed run
    draws the noise the uninterrupted one would); ``loss="crps"`` is the
    fair ensemble CRPS. A config with ``dropout_p`` > 0 trains the dropout
    twin of the serving model (the same parameters). ``init_from``
    warm-starts parameters and processor state; ``resume`` continues a run
    exactly from ``checkpoint_dir/latest``. SIGTERM and SIGINT (main thread,
    ``handle_signals``) finish the update in flight, checkpoint and return.
    ``max_steps_this_run`` boxes the updates of this call. ``profile_dir``
    writes a ``torch.profiler`` trace of the steps ``[start, stop)`` of
    ``profile_steps``. ``steps_per_call`` is accepted and every step is its
    own call: the dispatch amortisation it buys the JAX package waits for
    CUDA graphs (ROADMAP Queue 1 #4). With ``overlap_calls`` a step's loss is
    read after the next step is queued, so the host never waits on the card
    for it.
    ``mesh`` (a ``parallel.Mesh`` over the ranks of the default process
    group, every rank calling ``train_run`` with the same arguments) trains
    each rank on its rows of each batch; ``param_sharding`` (which needs a
    mesh) shards the AdamW moments (``"zero1"``) or the parameters, moments
    and EMA too (``"fsdp"``) over ``param_sharding_axis``.

    Returns ``{"interface", "model", "optimizer", "ema", "graph", "losses",
    "eval", "steps_done", "checkpoint", "loader_wait_s", "step_ms", "plan"}``
    (and ``"interrupted"`` after a signal); ``step_ms`` are the CUDA-event
    times of the steps on the card (empty on the CPU); ``plan`` the shard
    plan (None without ``param_sharding``); under it the model, optimizer
    and EMA hold this rank's slices.
    """
    from anemoi_models_tpu_torch import configs
    from anemoi_models_tpu_torch.checkpoint import load_checkpoint, load_jax_opt_state
    from anemoi_models_tpu_torch.data_indices import IndexCollection
    from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph, build_hierarchical_graph, nodes_from_coords
    from anemoi_models_tpu_torch.interface import AnemoiModelInterface

    if param_sharding is not None and mesh is None:
        raise ValueError(f"param_sharding={param_sharding!r} shards the train state over a mesh: pass mesh= "
                         "(parallel.make_mesh)")
    if param_sharding is not None:
        check_mode(param_sharding)
    if mesh is not None and batch_size % mesh.shape["data"]:
        raise ValueError(f"batch_size {batch_size} does not split over the mesh's {mesh.shape['data']} data ranks")
    model_kwargs = dict(model_kwargs or {})
    # remat_policy="auto": build with "none", then keep it if the step's memory fits the card
    auto_remat = model_kwargs.get("remat_policy") == "auto" and config is None
    if model_kwargs.get("remat_policy") == "auto":
        model_kwargs["remat_policy"] = "none" if auto_remat else "full"
    if loss not in ("mse", "crps"):
        raise ValueError(f"loss must be 'mse' or 'crps', got {loss!r}")
    if architecture not in ("enc_proc_dec", "hierarchical"):
        raise ValueError(f"unknown architecture {architecture!r}")

    lead = mesh is None or mesh.rank == 0  # the rank that logs and writes
    if not lead:
        log = _quiet
    data_nodes = nodes_from_coords(np.asarray(source.coords, np.float64))
    if architecture == "hierarchical":
        graph, hidden_names = build_hierarchical_graph(
            data_nodes=data_nodes, mesh_refinements=mesh_refinements, num_levels=num_hidden_levels,
        )

        def make_config(kwargs):
            return configs.hierarchical(forcing=tuple(forcing), diagnostic=tuple(diagnostic),
                                        hidden_names=hidden_names, flavor=flavor, **kwargs)
    else:
        graph = build_enc_proc_dec_graph(data_nodes=data_nodes, mesh_refinements=mesh_refinements)

        def make_config(kwargs):
            return configs.enc_proc_dec(forcing=tuple(forcing), diagnostic=tuple(diagnostic), flavor=flavor,
                                        **kwargs)
    if config is None:
        config = make_config(model_kwargs)

    def make_iface(cfg):
        idx = IndexCollection(cfg, source.name_to_index)
        return idx, AnemoiModelInterface(
            config=cfg, graph_data=graph, statistics=source.statistics, data_indices=idx,
            metadata={"dataset": getattr(source, "path", type(source).__name__)}, device=device,
        )

    indices, iface = make_iface(config)
    dev = iface.device
    if mesh is not None and mesh.device != dev:
        raise ValueError(f"the mesh's ranks hold their tensors on {mesh.device}, train_run's device is {dev}")
    if auto_remat:
        chosen = _resolve_auto(iface, indices, graph, config, mesh, batch_size, rollout, rollout_schedule,
                               ensemble, loss, ema_decay is not None, log)
        if chosen != "none":
            model_kwargs["remat_policy"] = chosen
            config = make_config(model_kwargs)
            indices, iface = make_iface(config)
    iface.init_params(torch.Generator().manual_seed(seed))
    model = iface.model

    multi_step = int(config.training.multistep_input)
    sched = sorted((int(u), int(r)) for u, r in rollout_schedule) if rollout_schedule else [(0, rollout)]
    if sched[0][0] != 0:
        raise ValueError("rollout_schedule must define a length from step 0")
    max_rollout = max(r for _, r in sched)

    def rollout_at(step_no: int) -> int:
        return max(r for u, r in sched if u <= step_no)

    window = multi_step + max_rollout
    # dataset rows -> graph order (the graph builder's mesh-locality permutation)
    src_idx = graph["data"].attrs.get("source_index")
    grid_perm = None if src_idx is None else np.ascontiguousarray(src_idx[:, 0])
    data_in = torch.as_tensor(np.asarray(indices.internal_data.input.full), device=dev)
    data_out = torch.as_tensor(np.asarray(indices.internal_data.output.full), device=dev)

    # keep an eval tail the sampler never sees
    eval_window = (multi_step + eval_rollout) if eval_every else 0
    sampler = WindowSampler(len(source) - eval_window, window, batch_size, seed=seed)

    def ingest(raw: np.ndarray) -> np.ndarray:
        return raw[:, :, grid_perm, :] if grid_perm is not None else raw

    # fit stateful processors (imputer masks) on the first window
    first = ingest(source.window(0, window)[None])
    iface.fit_processors(torch.as_tensor(np.ascontiguousarray(first), device=dev))

    warm = None
    if init_from:
        # the donor's parameters and fitted processor state; the optimizer,
        # schedule and sampler start fresh
        warm = load_checkpoint(init_from)
        if warm.get("processor_state"):
            iface.pre_processors.load_state_dict(warm["processor_state"])
            iface.post_processors.load_state_dict(warm["processor_state"])

    area = torch.as_tensor(graph["data"].attrs["area_weight"][:, 0], dtype=torch.float32, device=dev)
    var_w = None
    if variable_loss_weights:
        out_n2i = indices.internal_model.output.name_to_index
        unknown = sorted(set(variable_loss_weights) - set(out_n2i))
        if unknown:
            raise ValueError(f"variable_loss_weights for non-output variables: {unknown}")
        var_w = torch.ones(len(out_n2i), dtype=torch.float32)
        for name, wgt in variable_loss_weights.items():
            var_w[out_n2i[name]] = wgt
        var_w = var_w.to(dev)
    loss_cls = WeightedCRPSLoss if loss == "crps" else WeightedMSELoss
    loss_fn = loss_cls(node_weights=area, variable_weights=var_w, loss_mask=loss_mask(iface.pre_processors))
    optimizer = make_optimizer(
        model.parameters(), peak_lr,
        warmup_steps=min(warmup_steps if warmup_steps is not None else max(steps // 10, 1), steps),
        total_steps=steps, weight_decay=weight_decay,
    )
    # the dropout twin shares the serving model's parameters, so checkpoints,
    # EMA and serving stay interchangeable
    train_model = dropout_twin(model) if _wants_dropout(config.model) else model
    cores: dict = {}

    def core_for(r: int):
        if r not in cores:
            cores[r] = (make_train_step(train_model, optimizer, loss_fn, dropout_seed=seed + 3, plan=plan) if r == 1
                        else make_rollout_train_step(train_model, indices, optimizer, r, loss_fn,
                                                     dropout_seed=seed + 3, plan=plan))
        return cores[r]

    forcing_in = np.asarray(indices.internal_model.input.forcing)

    def prep(raw: torch.Tensor, step: int):
        pre = iface.pre_processors(raw, in_place=False)  # (b, window, grid, vars)
        x0 = pre[:, :multi_step, None][..., data_in]
        if ensemble > 1:
            x0 = perturb_members(x0, ensemble, perturb_sigma, seed + 1, step, forcing_in)
        future = pre[:, multi_step:, None]  # (b, rollout, 1, grid, vars)
        return x0, future[..., data_in].movedim(1, 0), future[..., data_out].movedim(1, 0)

    def rank_rows(t: torch.Tensor, batch_axis: int) -> torch.Tensor:
        """This rank's rows of a whole batch: its data index's batch rows and
        its grid rows (axis -2) of the model axis."""
        if mesh is None:
            return t
        n = t.shape[batch_axis] // mesh.shape["data"]
        t = t.narrow(batch_axis, mesh.coords["data"] * n, n)
        lo, hi = mesh.rows(t.shape[-2])
        return t.narrow(-2, lo, hi - lo)

    def run_step(raw: torch.Tensor, r: int) -> torch.Tensor:
        # the whole batch's inputs, noise and targets, then this rank's rows of them
        x0, truth_in, targets = prep(raw, optimizer.count)
        x0, truth_in, targets = rank_rows(x0, 0), rank_rows(truth_in, 1), rank_rows(targets, 1)
        if r == 1:
            return core_for(1)(x0, targets[0])
        return core_for(r)(x0, truth_in[:r], targets[:r])

    ckpt_path = os.path.join(checkpoint_dir, "latest") if checkpoint_dir else None
    metrics_path = os.path.join(checkpoint_dir, "metrics.jsonl") if checkpoint_dir else None
    if checkpoint_dir:
        # graph-once layout: the graph is immutable across a run, so it is
        # written once beside the periodic checkpoints
        graph_path = os.path.join(checkpoint_dir, "graph.npz")
        if lead:
            os.makedirs(checkpoint_dir, exist_ok=True)
            if not os.path.exists(graph_path):
                graph.save(graph_path)

    def log_metrics(record: dict) -> None:
        if metrics_path and lead:
            with open(metrics_path, "a") as fh:
                fh.write(json.dumps(record) + "\n")

    ema = None
    start_step = 0
    resuming = bool(resume and ckpt_path and os.path.exists(ckpt_path))
    if warm is not None and not resuming:
        iface.load_params(warm["params"])
        log(f"warm-started parameters from {init_from}")
    if ema_decay is not None:
        ema = {k: v.clone() for k, v in _params(model).items()}
    if resuming:
        restored = iface.load(ckpt_path)  # parameters and processor state, either package's checkpoint
        start_step = int(restored.get("step") or 0)
        opt_state = dict(restored.get("opt_state") or {})
        if "opt" in opt_state:  # the JAX package's {"opt": optax state, "ema": flax tree}
            load_jax_opt_state(optimizer, model, opt_state["opt"])
            saved_ema = opt_state.get("ema")
            if saved_ema is not None:
                from anemoi_models_tpu_torch.weights import load_flax_params

                saved_ema = load_flax_params(saved_ema)
        else:
            saved_ema = opt_state.pop("ema", None)
            optimizer.load_state_dict(opt_state)
        if ema_decay is not None and saved_ema is not None:
            ema = {k: torch.as_tensor(saved_ema[k]).to(dev, v.dtype) for k, v in ema.items()}
        samp = (restored.get("metadata") or {}).get("sampler")
        if samp:
            sampler.restore(samp)
        log(f"resumed from {ckpt_path} at step {start_step}")

    # the background loader pulls ahead of training, so sampler.state()
    # overshoots mid-run saves by the queue depth; the exact position for a
    # trained-step count comes from the pre-loader base
    base_epoch, base_pos = sampler.epoch, sampler.position
    bpe = sampler.batches_per_epoch

    def sampler_state_at(consumed: int) -> dict:
        total = base_epoch * bpe + base_pos + consumed
        return {"epoch": total // bpe, "position": total % bpe, "seed": sampler.seed}

    # ZeRO-1 / FSDP: the state as the checkpoint left it (whole), then cut to this rank's slices
    plan = None
    if param_sharding is not None:
        plan, ema = shard_train_state(model, optimizer, mesh, param_sharding, param_sharding_axis, ema=ema)
        if train_model is not model:
            plan.attach(train_model)
        log(f"parameter sharding: {param_sharding} over the '{param_sharding_axis}' axis "
            f"({mesh.shape[param_sharding_axis]}-way)")

    def whole_state():
        """The run's state whole (every rank: the gathers are collectives):
        yields the EMA as the unsharded run holds it."""
        return plan.gathered(optimizer, ema) if plan is not None else contextlib.nullcontext(ema)

    def save(step_no: int) -> None:
        if not ckpt_path:
            return
        iface.metadata["sampler"] = sampler_state_at(step_no - start_step)
        with whole_state() as whole_ema:
            if lead:
                iface.save(ckpt_path, optimizer=optimizer, step=step_no, include_graph=False, ema=whole_ema)
        if mesh is not None:
            dist.barrier()  # every rank sees the checkpoint before it goes on

    remaining = steps - start_step
    if max_steps_this_run is not None:
        remaining = min(remaining, max_steps_this_run)
    losses: list[float] = []
    evals: list[dict] = []
    step_events: list = []
    loader_wait = 0.0
    if remaining <= 0:
        log(f"checkpoint already at step {start_step} >= steps={steps}; nothing to do")

    stop_requested: list = []
    prev_handlers: dict = {}
    if handle_signals and threading.current_thread() is threading.main_thread():
        def _request_stop(signum, frame):
            log(f"signal {signum}: finishing the update in flight, then checkpointing and stopping")
            stop_requested.append(signum)

        prev_handlers = {sig: signal.signal(sig, _request_stop) for sig in (signal.SIGTERM, signal.SIGINT)}

    loader = BatchLoader(source, sampler, depth=loader_depth, max_batches=max(remaining, 0), workers=loader_workers)
    t_seg, i_seg = time.perf_counter(), 0
    profiler = None
    pending = None  # (step, loss tensor) whose value is read after the next step is queued
    step_no = start_step
    interrupted = False

    def flush(step: int, value: torch.Tensor) -> None:
        nonlocal t_seg, i_seg
        if not (step % max(log_every, 1) == 0 or step == steps):
            return
        lv = float(value)  # waits for the step's kernels
        now = time.perf_counter()
        rate = (step - start_step - i_seg) / max(now - t_seg, 1e-9)
        t_seg, i_seg = now, step - start_step
        losses.append(lv)
        log(f"step {step:6d}  loss {lv:.5f}  ({rate:.2f} steps/s)")
        log_metrics({"step": step, "loss": lv, "steps_per_s": round(rate, 4)})

    mesh_scope = use_mesh(mesh)
    mesh_scope.__enter__()
    try:
        stream = device_prefetch((ingest(b) for b in loader), prefetch=prefetch, device=dev)
        cur_rollout = None
        while True:
            t0 = time.perf_counter()
            raw = next(stream, None)
            loader_wait += time.perf_counter() - t0
            if raw is None:
                break
            step_no += 1
            r = rollout_at(step_no)
            if r != cur_rollout:
                if cur_rollout is not None:
                    log(f"rollout curriculum: {cur_rollout} -> {r} at step {step_no}")
                cur_rollout = r
            if profile_dir and lead and step_no - start_step == profile_steps[0] + 1:
                profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else []))
                profiler.__enter__()
            events = None
            if dev.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                events[0].record()
            loss_t = run_step(raw, r)
            if ema is not None:
                ema = ema_update(ema, _params(model), ema_decay)
            if events is not None:
                events[1].record()
                step_events.append(events)
            # the previous step's loss, read now that this step is queued
            if pending is not None:
                flush(*pending)
                pending = None
            eval_now = bool(eval_every and step_no % eval_every == 0)
            save_now = bool(save_every and ckpt_path and step_no % save_every == 0)
            last = step_no >= start_step + remaining
            if overlap_calls and not (eval_now or save_now or last or stop_requested):
                pending = (step_no, loss_t)
            else:
                flush(step_no, loss_t)
            if eval_now:
                with whole_state() as whole_ema, use_mesh(None):  # every rank scores the whole grid
                    scores = _eval_tail(iface, source, eval_rollout, whole_ema)
                evals.append({"step": step_no, **scores})
                log_metrics({"step": step_no, "eval_rmse": scores["rmse_mean"], "eval_skill": scores["skill_mean"]})
                log(f"eval @ {step_no}: rollout-{eval_rollout} rmse {scores['rmse_mean']:.5f}  "
                    f"skill vs persistence {scores['skill_mean']:+.3f}")
            if save_now:
                save(step_no)
            if profiler is not None and step_no - start_step >= profile_steps[1]:
                _stop_profile(profiler, profile_dir, dev)
                profiler = None
                log(f"profile trace written to {profile_dir}")
            # under a mesh with signals handled, a stop any rank was asked for stops every rank
            if _any_rank(bool(stop_requested), mesh if prev_handlers else None, dev):
                save(step_no)
                log(f"stopped at step {step_no} on request; checkpoint saved")
                interrupted = True
                break
    finally:
        mesh_scope.__exit__(None, None, None)
        if profiler is not None:  # the run ended inside the window
            _stop_profile(profiler, profile_dir, dev)
        loader.close()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)

    if pending is not None:
        flush(*pending)
    if not interrupted:
        step_no = start_step + max(remaining, 0)
        if ckpt_path and remaining > 0:
            save(step_no)
    if step_events:
        torch.cuda.synchronize(dev)
    out = {
        "interface": iface, "model": model, "optimizer": optimizer, "ema": ema, "graph": graph,
        "losses": losses, "eval": evals, "steps_done": step_no, "checkpoint": ckpt_path,
        "loader_wait_s": loader_wait, "step_ms": [a.elapsed_time(b) for a, b in step_events], "plan": plan,
    }
    if interrupted:
        out["interrupted"] = True
    return out


def _quiet(msg: str) -> None:
    """The log of a rank other than the first."""


def _resolve_auto(iface, indices, graph, config, mesh, batch_size: int, rollout: int, rollout_schedule,
                  ensemble: int, loss: str, ema: bool, log) -> str:
    """``remat_policy="auto"``'s answer for ``iface``'s model (built with
    ``"none"``): :func:`resolve_remat_policy` on the step variant the run
    executes, on this rank's rows under a mesh, where every rank takes
    ``"full"`` if any rank's step does not fit."""
    dev = iface.device
    n_grid = graph["data"].num_nodes
    rows, batch = n_grid, batch_size
    if mesh is not None:
        lo, hi = mesh.rows(n_grid)
        rows, batch = hi - lo, batch_size // mesh.shape["data"]
    multi_step = int(config.training.multistep_input)
    max_rollout = max((int(r) for _, r in rollout_schedule), default=rollout) if rollout_schedule else rollout
    area = torch.as_tensor(graph["data"].attrs["area_weight"][:, 0], dtype=torch.float32, device=dev)
    loss_fn = (WeightedCRPSLoss if loss == "crps" else WeightedMSELoss)(node_weights=area)
    model = dropout_twin(iface.model) if _wants_dropout(config.model) else iface.model
    with use_mesh(mesh):
        chosen = resolve_remat_policy(
            model, None,
            (batch, multi_step, 1, rows, len(indices.internal_model.input)),
            (batch, 1, rows, len(indices.internal_model.output)),
            indices=indices, rollout=max_rollout, ensemble=ensemble, loss_fn=loss_fn, ema=ema, log=log,
        )
    return "full" if _any_rank(chosen == "full", mesh, dev) else "none"


def _any_rank(flag: bool, mesh, dev: torch.device) -> bool:
    """``flag`` of any rank (a stop request), so every rank stops at one
    step: a sum over the default group under a mesh, else ``flag``."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device=dev)
    mesh.check_device(t)
    dist.all_reduce(t)
    return bool(t.item())


def perturb_members(x0: torch.Tensor, members: int, sigma: float, seed: int, step: int,
                    forcing: np.ndarray) -> torch.Tensor:
    """``members`` copies of the window ``x0`` (batch, time, 1, grid, vars)
    on its ensemble axis, each plus normalized-space noise of std ``sigma``
    but in the ``forcing`` columns, which stay at truth. The noise is drawn
    by a CPU ``torch.Generator`` seeded from ``(seed, step)``: fresh for
    every update, the same on any device and after a resume."""
    x0 = x0.repeat_interleave(members, dim=2)
    gen = torch.Generator().manual_seed(fold_key(seed, step) >> 1)
    noise = sigma * torch.randn(x0.shape, generator=gen, dtype=torch.float32)
    if forcing.size:
        noise[..., torch.as_tensor(forcing)] = 0.0
    return x0 + noise.to(x0.device, x0.dtype)


def _stop_profile(profiler, profile_dir: str, dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    profiler.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "train_run_trace.json"))


def _eval_tail(iface, source, eval_rollout: int, params: Optional[dict]) -> dict:
    """Score an autoregressive rollout on the held-out dataset tail."""
    scores = evaluate_interface(iface, source, n_steps=eval_rollout, params=params)
    return {
        "rmse_mean": float(np.mean(scores["rmse"])),
        "skill_mean": float(np.mean(scores["skill_vs_persistence"])),
        "rmse": scores["rmse"].tolist(),
    }
