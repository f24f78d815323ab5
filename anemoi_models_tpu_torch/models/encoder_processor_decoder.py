"""Encoder-processor-decoder graph model.

Counterpart of ``anemoi_models_tpu/models/encoder_processor_decoder.py``: the
state on the data grid is encoded onto the hidden mesh, processed, decoded
back, with a residual connection for the prognostic variables and the
config's output boundings applied in config order. Encoder, processor and
decoder are built from the config's ``_target_`` entries.

Input layout: (batch, time, ensemble, grid, vars), as in the JAX package;
batch and ensemble merge into one leading axis inside. The model is built on
the card (``device="cuda"``) unless the caller names another device.
"""

from __future__ import annotations

import inspect
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from anemoi_models_tpu_torch.layers.graph import NamedNodesAttributes
from anemoi_models_tpu_torch.parallel.api import model_sharded
from anemoi_models_tpu_torch.utils.config import DotDict, instantiate, resolve_target

__all__ = ["AnemoiModelEncProcDec", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA on a machine without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: build the model with device='cpu' to run it on the CPU")
    return device


class AnemoiModelEncProcDec(nn.Module):
    """Message passing graph neural network (enc-proc-dec)."""

    def __init__(self, *, model_config: Any, data_indices: Any, graph_data: Any,
                 dtype: torch.dtype = torch.float32, device="cuda", deterministic: bool = True) -> None:
        super().__init__()
        device = resolve_device(device)
        # deterministic=False: the Transformer processor drops attention
        # weights under the dropout_key the forward is given
        self.deterministic = deterministic
        cfg = DotDict(model_config)
        name_data, name_hidden = cfg.graph.data, cfg.graph.hidden
        self._graph_name_data, self._graph_name_hidden = name_data, name_hidden
        self._check_indices(data_indices, device)
        self.boundings = _boundings(cfg, data_indices)

        self.multi_step = cfg.training.multistep_input
        self.num_channels = cfg.model.num_channels
        self.node_attributes = NamedNodesAttributes(
            cfg.model.trainable_parameters.hidden, graph_data, device=device
        )
        num_nodes = self.node_attributes.num_nodes
        attr_ndims = self.node_attributes.attr_ndims
        input_dim = self.multi_step * self.num_input_channels + attr_ndims[name_data]
        common = dict(deterministic=deterministic, dtype=dtype, device=device)

        self.encoder = instantiate(
            cfg.model.encoder,
            in_channels_src=input_dim,
            in_channels_dst=attr_ndims[name_hidden],
            hidden_dim=self.num_channels,
            sub_graph=graph_data[(name_data, "to", name_hidden)],
            src_grid_size=num_nodes[name_data],
            dst_grid_size=num_nodes[name_hidden],
            **_accepted(cfg.model.encoder, common),
        )
        # the Transformer processor attends over mesh positions: no graph
        self.processor = instantiate(
            cfg.model.processor,
            num_channels=self.num_channels,
            **_accepted(cfg.model.processor, {
                **common,
                "sub_graph": graph_data[(name_hidden, "to", name_hidden)],
                "src_grid_size": num_nodes[name_hidden],
                "dst_grid_size": num_nodes[name_hidden],
            }),
        )
        self.decoder = instantiate(
            cfg.model.decoder,
            in_channels_src=self.num_channels,
            in_channels_dst=input_dim,
            hidden_dim=self.num_channels,
            out_channels_dst=self.num_output_channels,
            sub_graph=graph_data[(name_hidden, "to", name_data)],
            src_grid_size=num_nodes[name_hidden],
            dst_grid_size=num_nodes[name_data],
            **_accepted(cfg.model.decoder, common),
        )

    def _check_indices(self, data_indices: Any, device: torch.device) -> None:
        """The channel counts and the prognostic routing, with the JAX
        model's checks (raised as ValueError, which ``python -O`` keeps)."""
        self.num_input_channels = len(data_indices.internal_model.input)
        self.num_output_channels = len(data_indices.internal_model.output)
        prog_in = np.asarray(data_indices.internal_model.input.prognostic)
        prog_out = np.asarray(data_indices.internal_model.output.prognostic)
        routed = len(data_indices.internal_model.output.full) - len(data_indices.internal_model.output.diagnostic)
        if len(prog_out) != routed:
            raise ValueError(
                f"routing-table width check failed: {len(prog_out)} internal prognostic outputs vs {routed} "
                "internal outputs that are not diagnostic"
            )
        if len(prog_in) != len(prog_out):
            raise ValueError(f"prognostic input/output indices diverge: {prog_in} vs {prog_out}")
        self.register_buffer("_internal_input_idx", torch.as_tensor(prog_in, device=device), persistent=False)
        self.register_buffer("_internal_output_idx", torch.as_tensor(prog_out, device=device), persistent=False)

    def _rank_rows(self, names: list, grid: int) -> dict:
        """Per node set of ``names`` (the data grid first), this rank's
        ``(lo, hi)`` under a model-sharded mesh, None without one; raises
        where a node set has fewer rows than the model axis has ranks (the
        JAX equal-pad split has the same limit), or the input's ``grid`` is
        not the rank's grid rows."""
        mesh = model_sharded()
        if mesh is None:
            return dict.fromkeys(names)
        num_nodes = self.node_attributes.num_nodes
        for name in names:
            if num_nodes[name] < mesh.shape["model"]:
                raise ValueError(f"node set {name!r} has {num_nodes[name]} rows, fewer than the mesh's "
                                 f"{mesh.shape['model']} model ranks")
        rows = {name: mesh.rows(num_nodes[name]) for name in names}
        lo, hi = rows[names[0]]
        if grid != hi - lo:
            raise ValueError(f"rank {mesh.rank} holds grid rows [{lo}, {hi}); the input has {grid}")
        return rows

    def _finish(self, x_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The residual connection for the prognostic variables, then the
        boundings in config order."""
        residual = x[:, -1].index_select(-1, self._internal_input_idx)
        x_out = x_out.index_add(-1, self._internal_output_idx, residual)
        for bounding in self.boundings:
            x_out = bounding(x_out)
        return x_out

    def forward(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        """x (batch, time, ensemble, grid, vars) -> (batch, ensemble, grid, vars_out).
        ``dropout_key``: the attention-dropout key of a ``deterministic=False``
        model (``training.step``). Under a mesh whose ``model`` axis is larger
        than 1 (``parallel.use_mesh``), ``grid`` is this rank's rows of the
        data grid (``mesh.rows``) and so is the output."""
        batch_size, _, ensemble_size, grid, _ = x.shape
        bse = batch_size * ensemble_size
        rows = self._rank_rows([self._graph_name_data, self._graph_name_hidden], grid)
        x_flat = x.permute(0, 2, 3, 1, 4).reshape(bse, grid, -1)
        x_data_latent = torch.cat(
            [x_flat, self.node_attributes(self._graph_name_data, bse, rows[self._graph_name_data]).to(x_flat.dtype)],
            dim=-1,
        )
        x_hidden_latent = self.node_attributes(self._graph_name_hidden, bse, rows[self._graph_name_hidden])

        x_data_latent, x_latent = self.encoder((x_data_latent, x_hidden_latent))
        x_latent_proc = self.processor(x_latent, dropout_key) + x_latent  # hidden skip connection
        x_out = self.decoder((x_latent_proc, x_data_latent))

        x_out = x_out.reshape(batch_size, ensemble_size, grid, self.num_output_channels).to(x.dtype)
        return self._finish(x_out, x)


def _boundings(cfg: Any, data_indices: Any) -> list:
    """The config's output boundings, in config order, over the internal
    model output's variable table."""
    name_to_index = data_indices.internal_model.output.name_to_index
    return [instantiate(b, name_to_index=name_to_index) for b in cfg.model.get("bounding", [])]


def _accepted(cfg: Any, extra: dict) -> dict:
    """The entries of ``extra`` that the config's target takes: the
    parameters of its ``__init__`` and, through ``**kwargs``, its bases'."""
    names: set[str] = set()
    for klass in inspect.getmro(resolve_target(cfg["_target_"])):
        if "__init__" not in vars(klass):
            continue
        params = inspect.signature(klass.__init__).parameters
        names |= set(params)
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
            break
    return {k: v for k, v in extra.items() if k in names}
