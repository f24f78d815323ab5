"""AnemoiModelInterface: pre-process -> model -> post-process.

Counterpart of ``anemoi_models_tpu/interface/__init__.py`` for serving: the
constructor, ``to``, ``init_params``, ``load_params``, ``forward`` and
``predict_step``. The model is an ``nn.Module`` that owns its parameters;
the device is explicit (``device=`` at construction, or ``to``).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from anemoi_models_tpu_torch.preprocessing import Processors
from anemoi_models_tpu_torch.utils.config import instantiate
from anemoi_models_tpu_torch.weights import init_params, load_flax_params

__all__ = ["AnemoiModelInterface"]

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class AnemoiModelInterface:
    """Wraps an Anemoi model with pre- and post-processing steps."""

    def __init__(self, *, config: Any, graph_data: Any, statistics: dict, data_indices: Any,
                 device="cpu") -> None:
        self.config = config
        self.multi_step = config.training.multistep_input
        self.graph_data = graph_data
        self.statistics = statistics
        self.data_indices = data_indices
        self.device = torch.device(device)

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
        self.device = torch.device(device)
        self.model.to(self.device)
        self.pre_processors.to(self.device)
        self.post_processors.to(self.device)
        return self

    def init_params(self, generator: torch.Generator) -> None:
        """Flax-equivalent initialisation, drawn from a CPU ``generator``."""
        init_params(self.model, generator)

    def load_params(self, tree: Mapping[str, Any]) -> None:
        """Load a JAX parameter tree (nested dicts of numpy arrays)."""
        self.model.load_state_dict(load_flax_params(tree), strict=True)

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (batch, time, ensemble, grid, vars) -> (batch, ensemble, grid, vars_out)."""
        return self.model(x)

    @torch.inference_mode()
    def predict_step(self, batch: torch.Tensor) -> torch.Tensor:
        """Pre-process -> forward -> post-process one (batch, time, grid, vars)
        batch, at the model-input or the data variable width."""
        if batch.dim() != 4:
            raise ValueError(
                f"predict_step expects a (batch, time, grid, vars) 4-D tensor; received shape {tuple(batch.shape)}"
            )
        batch = self.pre_processors(batch, in_place=False)
        x = batch[:, 0 : self.multi_step, None, ...]  # add the ensemble dim
        return self.post_processors(self.model(x), in_place=False)
