"""Rollout evaluation: per-variable, per-lead-time skill scores.

Counterpart of ``anemoi_models_tpu/training/evaluate.py``: run the
autoregressive rollout against held-out truth and report area-weighted RMSE
(and anomaly correlation) per variable and lead time, plus the persistence
baseline every forecast must beat, and for an ensemble the fair CRPS and the
spread/skill ratio. The rollout is the port's :func:`make_rollout_fn`, on the
interface's device.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from anemoi_models_tpu_torch.training.loss import crps_ensemble
from anemoi_models_tpu_torch.training.rollout import make_rollout_fn

__all__ = ["rollout_scores", "evaluate_rollout", "evaluate_interface"]


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor], dims) -> torch.Tensor:
    if w is None:
        return x.mean(dims)
    w = w[..., None].expand(x.shape)
    return (x * w).sum(dims) / w.sum(dims)


def rollout_scores(
    preds: torch.Tensor,
    truth: torch.Tensor,
    node_weights: Optional[torch.Tensor] = None,
    climatology: Optional[torch.Tensor] = None,
) -> dict[str, np.ndarray]:
    """Scores for rollout predictions vs truth.

    preds/truth: (steps, batch, ensemble, grid, vars); node_weights: (grid,);
    climatology: (grid, vars) for anomaly correlation. Returns per
    (step, var) arrays: rmse, mae, and acc when climatology given.
    """
    err = preds.float() - truth.float()
    dims = (1, 2, 3)
    out = {
        "rmse": torch.sqrt(_wmean(err**2, node_weights, dims)).cpu().numpy(),
        "mae": _wmean(err.abs(), node_weights, dims).cpu().numpy(),
    }
    if climatology is not None:
        pa = preds.float() - climatology
        ta = truth.float() - climatology
        num = _wmean(pa * ta, node_weights, dims)
        den = torch.sqrt(_wmean(pa**2, node_weights, dims) * _wmean(ta**2, node_weights, dims))
        out["acc"] = (num / den.clamp_min(1e-12)).cpu().numpy()
    return out


def _with_params(model: Any, params: Optional[Mapping[str, torch.Tensor]]):
    """``model``, or a callable that runs it with ``params`` (e.g. an EMA of
    its parameters) in place of its own."""
    if params is None:
        return model
    return lambda x: torch.func.functional_call(model, dict(params), (x,))


@torch.no_grad()
def evaluate_interface(
    iface: Any,
    source: Any,
    n_steps: int = 4,
    start: Optional[int] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    acc: bool = False,
    ensemble: int = 1,
    perturb_sigma: float = 0.05,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Score an interface on a window of a ``DataSource``.

    Rolls ``n_steps`` from ``start`` (default: the dataset tail) and returns
    :func:`evaluate_rollout`'s model-vs-persistence scores, handling the
    dataset->graph grid permutation and preprocessing. ``params`` (named
    parameters, e.g. an EMA) replace the model's own for the rollout.
    ``acc=True`` adds anomaly correlation against a climatology estimated
    from the dataset (time mean over up to 64 evenly spaced steps).
    ``ensemble`` > 1 rolls M members from perturbed initial conditions
    (normalized-space noise on prognostic inputs, forcings pinned, drawn by a
    CPU ``torch.Generator`` seeded with ``seed``) and adds per-lead-time fair
    CRPS, ensemble spread and the spread/skill ratio.
    """
    indices = iface.data_indices
    graph = iface.graph_data
    data_node = iface.config.graph.get("data", "data")
    multi_step = iface.multi_step
    dev = iface.device
    if start is None:
        start = len(source) - (multi_step + n_steps)
    src_idx = graph[data_node].attrs.get("source_index")
    perm = None if src_idx is None else np.ascontiguousarray(src_idx[:, 0])

    def pre_windows(raw: np.ndarray) -> torch.Tensor:
        if perm is not None:
            raw = raw[:, :, perm, :]
        return iface.pre_processors(torch.as_tensor(np.ascontiguousarray(raw), device=dev), in_place=False)

    pre = pre_windows(source.window(start, multi_step + n_steps)[None])
    data_in = torch.as_tensor(np.asarray(indices.internal_data.input.full), device=dev)
    x0 = pre[:, :multi_step, None][..., data_in]
    truth_in = pre[:, multi_step:, None][..., data_in].movedim(1, 0)
    area = torch.as_tensor(np.asarray(graph[data_node].attrs["area_weight"][:, 0]), device=dev, dtype=torch.float32)
    prog_in = torch.as_tensor(np.asarray(indices.internal_model.input.prognostic), device=dev)

    climatology = None
    if acc:
        sample = np.unique(np.linspace(0, len(source) - 1, 64).astype(int))
        stacked = np.stack([source.window(int(t), 1) for t in sample])
        mean = pre_windows(stacked).mean(dim=(0, 1))
        climatology = mean[:, data_in][:, prog_in]

    model = _with_params(iface.model, params)
    scores = evaluate_rollout(model, indices, x0, truth_in, node_weights=area, climatology=climatology)
    if ensemble > 1:
        prog_out = torch.as_tensor(np.asarray(indices.internal_model.output.prognostic), device=dev)
        forcing_in = np.asarray(indices.internal_model.input.forcing)
        x0_m = x0.repeat_interleave(ensemble, dim=2)
        gen = torch.Generator().manual_seed(seed)
        noise = perturb_sigma * torch.randn(x0_m.shape, generator=gen, dtype=torch.float32).to(dev, x0_m.dtype)
        if forcing_in.size:
            noise[..., torch.as_tensor(forcing_in, device=dev)] = 0.0
        forcings = truth_in[..., torch.as_tensor(forcing_in, device=dev)] if forcing_in.size else None
        _, preds = make_rollout_fn(model, indices, n_steps)(x0_m + noise, forcings)
        members = preds[..., prog_out].float()  # (steps, b, M, grid, vp)
        truth = truth_in[..., prog_in].float()
        crps = np.asarray([float(crps_ensemble(members[t], truth[t], node_weights=area)) for t in range(n_steps)])
        # fair (ddof=1) member variance, area-weighted over the grid
        w = area / area.sum()
        var = members.var(dim=2, correction=1)  # (steps, b, grid, vp)
        spread = torch.sqrt((var * w[:, None]).sum(dim=2).mean(dim=(1, 2))).cpu().numpy()
        mean_rmse = rollout_scores(members.mean(dim=2, keepdim=True), truth, node_weights=area)["rmse"].mean(axis=1)
        scores["crps"] = crps
        scores["spread"] = spread
        scores["spread_skill_ratio"] = spread / np.maximum(mean_rmse, 1e-12)
        scores["ens_mean_rmse"] = mean_rmse
    return scores


@torch.no_grad()
def evaluate_rollout(
    model: Any,
    data_indices: Any,
    x0: torch.Tensor,
    truth_inputs: torch.Tensor,
    node_weights: Optional[torch.Tensor] = None,
    climatology: Optional[torch.Tensor] = None,
) -> dict[str, np.ndarray]:
    """Roll the model forward against truth and score it vs persistence.

    - ``x0``: (batch, multi_step, ensemble, grid, n_in) initial window;
    - ``truth_inputs``: (steps, batch, ensemble, grid, n_in) future states at
      the internal-model input width (forcings are read from it);
    - ``climatology``: optional (grid, n_prognostic) reference state for
      anomaly correlation.

    Returns rmse/mae (and acc when climatology is given) per (step,
    prognostic var) for the model and for the persistence forecast.
    """
    dev = x0.device
    n_steps = truth_inputs.shape[0]
    prog_in = torch.as_tensor(np.asarray(data_indices.internal_model.input.prognostic), device=dev)
    prog_out = torch.as_tensor(np.asarray(data_indices.internal_model.output.prognostic), device=dev)
    forcing_in = np.asarray(data_indices.internal_model.input.forcing)
    forcings = truth_inputs[..., torch.as_tensor(forcing_in, device=dev)] if forcing_in.size else None
    _, preds = make_rollout_fn(model, data_indices, n_steps)(x0, forcings)

    truth_prog = truth_inputs[..., prog_in]
    model_scores = rollout_scores(preds[..., prog_out], truth_prog, node_weights, climatology)
    persistence = x0[:, -1][None][..., prog_in].expand(truth_prog.shape)
    persist_scores = rollout_scores(persistence, truth_prog, node_weights, climatology)
    out = {
        "rmse": model_scores["rmse"],
        "mae": model_scores["mae"],
        "persistence_rmse": persist_scores["rmse"],
        "skill_vs_persistence": 1.0 - model_scores["rmse"] / np.maximum(persist_scores["rmse"], 1e-12),
    }
    if climatology is not None:
        out["acc"] = model_scores["acc"]
        out["persistence_acc"] = persist_scores["acc"]
    return out
