"""Encoder-processor-decoder graph model.

Counterpart of ``anemoi_models_tpu/models/encoder_processor_decoder.py``: the
state on the data grid is encoded onto the hidden mesh, processed, decoded
back, with a residual connection for the prognostic variables. Encoder,
processor and decoder are built from the config's ``_target_`` entries.

Input layout: (batch, time, ensemble, grid, vars), as in the JAX package;
batch and ensemble merge into one leading axis inside.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from anemoi_models_tpu_torch.layers.graph import NamedNodesAttributes
from anemoi_models_tpu_torch.utils.config import DotDict, instantiate

__all__ = ["AnemoiModelEncProcDec"]


class AnemoiModelEncProcDec(nn.Module):
    """Message passing graph neural network (enc-proc-dec)."""

    def __init__(self, *, model_config: Any, data_indices: Any, graph_data: Any,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        cfg = DotDict(model_config)
        name_data, name_hidden = cfg.graph.data, cfg.graph.hidden
        self._graph_name_data, self._graph_name_hidden = name_data, name_hidden
        if cfg.model.get("bounding"):
            raise NotImplementedError("output boundings (layers/bounding.py) are not ported yet")

        self.num_input_channels = len(data_indices.internal_model.input)
        self.num_output_channels = len(data_indices.internal_model.output)
        prog_in = np.asarray(data_indices.internal_model.input.prognostic)
        prog_out = np.asarray(data_indices.internal_model.output.prognostic)
        if len(prog_in) != len(prog_out):
            raise ValueError(f"prognostic input/output indices diverge: {prog_in} vs {prog_out}")
        self.register_buffer("_internal_input_idx", torch.as_tensor(prog_in, device=device), persistent=False)
        self.register_buffer("_internal_output_idx", torch.as_tensor(prog_out, device=device), persistent=False)

        self.multi_step = cfg.training.multistep_input
        self.num_channels = cfg.model.num_channels
        self.node_attributes = NamedNodesAttributes(
            cfg.model.trainable_parameters.hidden, graph_data, device=device
        )
        num_nodes = self.node_attributes.num_nodes
        attr_ndims = self.node_attributes.attr_ndims
        input_dim = self.multi_step * self.num_input_channels + attr_ndims[name_data]
        common = dict(dtype=dtype, device=device)

        self.encoder = instantiate(
            cfg.model.encoder,
            in_channels_src=input_dim,
            in_channels_dst=attr_ndims[name_hidden],
            hidden_dim=self.num_channels,
            sub_graph=graph_data[(name_data, "to", name_hidden)],
            src_grid_size=num_nodes[name_data],
            dst_grid_size=num_nodes[name_hidden],
            **common,
        )
        self.processor = instantiate(
            cfg.model.processor,
            num_channels=self.num_channels,
            sub_graph=graph_data[(name_hidden, "to", name_hidden)],
            src_grid_size=num_nodes[name_hidden],
            dst_grid_size=num_nodes[name_hidden],
            **common,
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
            **common,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (batch, time, ensemble, grid, vars) -> (batch, ensemble, grid, vars_out)."""
        batch_size, _, ensemble_size, grid, _ = x.shape
        bse = batch_size * ensemble_size
        x_flat = x.permute(0, 2, 3, 1, 4).reshape(bse, grid, -1)
        x_data_latent = torch.cat(
            [x_flat, self.node_attributes(self._graph_name_data, bse).to(x_flat.dtype)], dim=-1
        )
        x_hidden_latent = self.node_attributes(self._graph_name_hidden, bse)

        x_data_latent, x_latent = self.encoder((x_data_latent, x_hidden_latent))
        x_latent_proc = self.processor(x_latent) + x_latent  # hidden skip connection
        x_out = self.decoder((x_latent_proc, x_data_latent))

        x_out = x_out.reshape(batch_size, ensemble_size, grid, self.num_output_channels).to(x.dtype)
        # residual connection for the prognostic variables only
        residual = x[:, -1].index_select(-1, self._internal_input_idx)
        return x_out.index_add(-1, self._internal_output_idx, residual)
