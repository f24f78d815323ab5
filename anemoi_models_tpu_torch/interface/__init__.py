"""AnemoiModelInterface: pre-process -> model -> post-process.

Counterpart of ``anemoi_models_tpu/interface/__init__.py``, the
anemoi-inference serving surface: the constructor (with the checkpoint's
``metadata``, ``supporting_arrays`` and a ``uuid4`` ``id``), ``to``,
``init_params``, ``load_params``, ``example_input``, ``forward``,
``fit_processors`` (a stateful processor's state, an imputer's NaN mask,
from a sample batch), ``predict_step`` through the whole pipeline (and
``make_predict_fn``, its ``(params, batch)`` closure)
(normalizer, imputers, remappers, then the model and its boundings), the
multi-step forecast (``make_rollout_fn``,
``predict_rollout``) and checkpoints (``save``, ``load``,
``from_checkpoint``, which also reads the JAX package's checkpoints). The
model is an ``nn.Module`` that owns its parameters; train it with
``anemoi_models_tpu_torch.training``. Everything is built on the card
(``device="cuda"``) unless the caller names another device; without a card
that raises.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Mapping, Optional

import numpy as np
import torch

from anemoi_models_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from anemoi_models_tpu_torch.data_indices import IndexCollection
from anemoi_models_tpu_torch.graphs import HeteroGraph
from anemoi_models_tpu_torch.models.encoder_processor_decoder import resolve_device
from anemoi_models_tpu_torch.preprocessing import Processors
from anemoi_models_tpu_torch.training.rollout import make_rollout_fn
from anemoi_models_tpu_torch.utils import DotDict
from anemoi_models_tpu_torch.utils.config import instantiate
from anemoi_models_tpu_torch.weights import init_params, load_flax_params

__all__ = ["AnemoiModelInterface"]

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class AnemoiModelInterface:
    """Wraps an Anemoi model with pre- and post-processing steps."""

    def __init__(self, *, config: Any, graph_data: Any, statistics: dict, data_indices: Any,
                 metadata: Optional[dict] = None, supporting_arrays: Optional[dict] = None,
                 device="cuda") -> None:
        self.config = config
        self.id = str(uuid.uuid4())
        self.multi_step = config.training.multistep_input
        self.graph_data = graph_data
        self.statistics = statistics
        self.metadata = metadata or {}
        self.supporting_arrays = supporting_arrays if supporting_arrays is not None else {}
        self.data_indices = data_indices
        self.device = resolve_device(device)

        processors = [
            [name, instantiate(processor, data_indices=data_indices, statistics=statistics)]
            for name, processor in config.data.processors.items()
        ]
        self.pre_processors = Processors(processors).to(self.device)
        self.post_processors = Processors(processors, inverse=True).to(self.device)
        self.model = instantiate(
            config.model.model,
            model_config=config,
            data_indices=data_indices,
            graph_data=graph_data,
            dtype=_COMPUTE_DTYPES[config.model.get("compute_dtype", "float32")],
            device=self.device,
        )
        self.model.eval()

    def to(self, device) -> "AnemoiModelInterface":
        self.device = resolve_device(device)
        self.model.to(self.device)
        self.pre_processors.to(self.device)
        self.post_processors.to(self.device)
        return self

    # -- parameters ------------------------------------------------------
    def example_input(self, batch_size: int = 1, ensemble_size: int = 1) -> torch.Tensor:
        """Zeros of the model-forward input shape (internal input width)."""
        grid = self.graph_data[self.config.graph.data].num_nodes
        n_in = len(self.data_indices.internal_model.input)
        return torch.zeros((batch_size, self.multi_step, ensemble_size, grid, n_in), device=self.device)

    def init_params(self, generator: torch.Generator) -> None:
        """Flax-equivalent initialisation, drawn from a CPU ``generator``."""
        init_params(self.model, generator)

    def load_params(self, tree: Mapping[str, Any]) -> None:
        """Load parameters: the port's state dict, or a JAX parameter tree
        (nested dicts of arrays)."""
        flat = all(isinstance(v, torch.Tensor) for v in tree.values())
        self.model.load_state_dict(dict(tree) if flat else load_flax_params(tree), strict=True)

    # -- forward paths ---------------------------------------------------
    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (batch, time, ensemble, grid, vars) -> (batch, ensemble, grid, vars_out)."""
        return self.model(x)

    @torch.no_grad()
    def fit_processors(self, batch: torch.Tensor) -> None:
        """Fit the stateful processors (an imputer's first-batch NaN mask and
        loss mask) on a sample batch, threading it through the pipeline."""
        self.pre_processors.fit(batch)

    @torch.inference_mode()
    def predict_step(self, batch: torch.Tensor, params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """Pre-process -> forward -> post-process one (batch, time, grid, vars)
        batch, at the model-input or the data variable width. ``params``
        (name -> tensor, as ``model.named_parameters()`` names them) replace
        the model's own for this call (``torch.func.functional_call``)."""
        if batch.dim() != 4:
            raise ValueError(
                f"predict_step expects a (batch, time, grid, vars) 4-D tensor; received shape {tuple(batch.shape)}"
            )
        batch = self.pre_processors(batch, in_place=False)
        x = batch[:, 0 : self.multi_step, None, ...]  # add the ensemble dim
        y = self.model(x) if params is None else torch.func.functional_call(self.model, dict(params), (x,))
        return self.post_processors(y, in_place=False)

    def make_predict_fn(self, donate: bool = False):
        """Return a ``(params, batch) -> prediction`` closure: :meth:`predict_step`
        with ``params`` (name -> tensor) in place of the model's own, under
        ``torch.no_grad()``. Stateful processors are fitted first
        (:meth:`fit_processors`). ``donate`` (the JAX package's buffer
        donation to XLA) is accepted and has no effect in eager PyTorch."""
        del donate

        def fn(params: Mapping[str, torch.Tensor], batch: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                return self.predict_step(batch, params=params)

        return fn

    def make_rollout_fn(self, n_steps: int):
        """``training.make_rollout_fn`` bound to this interface's model."""
        return make_rollout_fn(self.model, self.data_indices, n_steps)

    @torch.inference_mode()
    def predict_rollout(self, batch: torch.Tensor, n_steps: int,
                        forcings: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Multi-step forecast: pre-process -> autoregressive rollout ->
        post-process every lead time at once.

        ``batch``: (batch, time, grid, vars) initial window; ``forcings``:
        (n_steps, batch, 1, grid, n_forcing) *pre-processed* per-step
        forcings, or None. Returns (n_steps, batch, ensemble, grid, vars_out)
        at the post-processed (physical) level.
        """
        pre = self.pre_processors(batch, in_place=False)
        x0 = pre[:, 0 : self.multi_step, None, ...]
        _, preds = self.make_rollout_fn(n_steps)(x0, forcings)
        # every post-processor is per (grid, variable) and broadcasts over the leading dims
        return self.post_processors(preds, in_place=False)

    # -- checkpoints -----------------------------------------------------
    def save(self, path: str, optimizer: Optional[torch.optim.Optimizer] = None, step: Optional[int] = None,
             include_graph: bool = True, ema: Optional[Mapping[str, torch.Tensor]] = None) -> str:
        """Write the parameters, the processor state, the optimizer's state
        (if given; with ``ema``, an EMA of the parameters by name, under its
        ``"ema"`` key) and the metadata to a checkpoint directory; returns its
        path. With ``include_graph`` the graph, the statistics and the
        variable table all ride along, so :meth:`from_checkpoint` rebuilds
        the serving interface from the directory alone; without it, keep the
        graph beside it as ``graph.npz`` (``HeteroGraph.save``)."""
        supporting = dict(self.supporting_arrays)
        if include_graph:
            supporting.update({f"graph::{k}": v for k, v in self.graph_data.to_arrays().items()})
        metadata = dict(self.metadata)
        metadata["name_to_index"] = dict(self.data_indices.name_to_index)
        metadata["statistics"] = {k: np.asarray(v).tolist() for k, v in self.statistics.items()}
        return save_checkpoint(
            path,
            params=self.model.state_dict(),
            processor_state=self.pre_processors.state_dict(),
            opt_state=_opt_state(optimizer, ema),
            step=step,
            metadata=metadata,
            config=dict(self.config),
            supporting_arrays=supporting,
            run_id=self.id,
        )

    def _restore(self, restored: dict) -> None:
        self.load_params(restored["params"])
        if restored.get("processor_state"):
            self.pre_processors.load_state_dict(restored["processor_state"])
            self.post_processors.load_state_dict(restored["processor_state"])
        if restored.get("run_id"):
            self.id = restored["run_id"]

    def load(self, path: str) -> dict:
        """Restore the parameters and the processor state from a checkpoint
        of either package; returns the whole checkpoint dict."""
        restored = load_checkpoint(path)
        self._restore(restored)
        return restored

    @classmethod
    def from_checkpoint(cls, path: str, graph_data: Any = None, device="cuda") -> "AnemoiModelInterface":
        """Rebuild a ready-to-serve interface from a checkpoint directory that
        either package wrote: config, variable table, statistics, graph
        (unless given: from the ``graph::`` supporting arrays, else a
        ``graph.npz`` in or beside the directory), parameters and processor
        state, the anemoi-inference load path in one call."""
        restored = load_checkpoint(path)
        meta = dict(restored.get("metadata") or {})
        n2i = meta.pop("name_to_index", None)
        stats = meta.pop("statistics", None)
        if n2i is None or stats is None:
            raise ValueError(
                f"checkpoint {path!r} predates self-contained saves (no variable "
                "table/statistics in its metadata); rebuild the interface by hand "
                "and use load() instead"
            )
        supporting = dict(restored.get("supporting_arrays") or {})
        graph_arrays = {k[len("graph::"):]: supporting.pop(k) for k in list(supporting) if k.startswith("graph::")}
        if graph_data is None:
            if graph_arrays:
                graph_data = HeteroGraph.from_arrays(graph_arrays)
            else:
                # the graph-once layout: a run keeps the (immutable) graph as a
                # graph.npz beside its periodic checkpoints
                for cand in (os.path.join(path, "graph.npz"),
                             os.path.join(os.path.dirname(os.path.abspath(path)), "graph.npz")):
                    if os.path.exists(cand):
                        graph_data = HeteroGraph.load(cand)
                        break
                else:
                    raise ValueError(
                        f"checkpoint {path!r} was saved with include_graph=False and "
                        "no sibling graph.npz exists; pass graph_data= "
                        "(e.g. HeteroGraph.load(...))"
                    )
        config = DotDict(restored.get("config") or {})
        # float64, as the JSON holds them: the normalizer builds its tables in
        # float64 before casting
        statistics = {k: np.asarray(v, np.float64) for k, v in stats.items()}
        iface = cls(
            config=config,
            graph_data=graph_data,
            statistics=statistics,
            data_indices=IndexCollection(config, {k: int(v) for k, v in n2i.items()}),
            metadata=meta,
            supporting_arrays=supporting,
            device=device,
        )
        iface._restore(restored)
        return iface


def _opt_state(optimizer: Optional[torch.optim.Optimizer], ema: Optional[Mapping[str, torch.Tensor]]) -> Optional[dict]:
    """The checkpoint's optimizer state: the optimizer's ``state_dict()`` and,
    with an EMA, its tensors (on the CPU) under ``"ema"``."""
    if optimizer is None and ema is None:
        return None
    state = dict(optimizer.state_dict()) if optimizer is not None else {}
    if ema is not None:
        state["ema"] = {k: v.detach().cpu() for k, v in ema.items()}
    return state
