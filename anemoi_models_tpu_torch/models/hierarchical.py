"""Hierarchical encoder-processor-decoder over a pyramid of hidden meshes.

Counterpart of ``anemoi_models_tpu/models/hierarchical.py``: hidden meshes
ordered fine to coarse (``cfg.graph.hidden`` a list), ``hidden_dims =
num_channels * 2^i``, an encoder onto the finest level, downscale mappers
(encoder-type) and upscale mappers (decoder-type) between consecutive
levels, optional processors per level on the way down and up (none on the
coarsest level on the way up), skip connections on the way up, a decoder
from the finest level, the prognostic residual and the boundings. The
per-level modules sit in ``nn.ModuleDict``s keyed by the level's name; the
JAX package names them ``down_level_processor_<name>``,
``up_level_processor_<name>``, ``downscale_<name>`` and ``upscale_<name>``
(``weights.py`` maps the two).

Under a mesh whose ``model`` axis is larger than 1 each rank holds its rows
of the data grid and of every hidden level (``mesh.rows``, the ceil split):
the encoder, decoder and the level mappers take the destination-sharded
path, each level processor its own halo path planned from its level's
edges, and the skip connections add the rank's rows of their level, as the
JAX model runs under GSPMD.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from anemoi_models_tpu_torch.layers.graph import NamedNodesAttributes
from anemoi_models_tpu_torch.ops.flash_attention import fold_key
from anemoi_models_tpu_torch.models.encoder_processor_decoder import (
    AnemoiModelEncProcDec,
    _accepted,
    _boundings,
    resolve_device,
)
from anemoi_models_tpu_torch.utils.config import DotDict, instantiate

__all__ = ["AnemoiModelEncProcDecHierarchical"]


class AnemoiModelEncProcDecHierarchical(AnemoiModelEncProcDec):
    """Multi-resolution enc-proc-dec: a pyramid of hidden meshes with skip links."""

    def __init__(self, *, model_config: Any, data_indices: Any, graph_data: Any,
                 dtype: torch.dtype = torch.float32, device="cuda", deterministic: bool = True) -> None:
        nn.Module.__init__(self)
        device = resolve_device(device)
        self.deterministic = deterministic
        cfg = DotDict(model_config)
        self._graph_name_data = cfg.graph.data
        names = list(cfg.graph.hidden)
        self._graph_hidden_names = names
        self.num_hidden = len(names)
        self.level_process = cfg.model.get("enable_hierarchical_level_processing", True)
        # the feature width doubles with depth
        self.hidden_dims = {name: cfg.model.num_channels * 2**i for i, name in enumerate(names)}
        self._check_indices(data_indices, device)
        self.boundings = _boundings(cfg, data_indices)

        self.multi_step = cfg.training.multistep_input
        self.node_attributes = NamedNodesAttributes(
            cfg.model.trainable_parameters.hidden, graph_data, device=device
        )
        num_nodes = self.node_attributes.num_nodes
        attr_ndims = self.node_attributes.attr_ndims
        name_data = self._graph_name_data
        input_dim = self.multi_step * self.num_input_channels + attr_ndims[name_data]
        common = dict(deterministic=deterministic, dtype=dtype, device=device)

        def graph_kw(src: str, dst: str) -> dict:
            return dict(sub_graph=graph_data[(src, "to", dst)], src_grid_size=num_nodes[src],
                        dst_grid_size=num_nodes[dst])

        h0 = names[0]
        self.encoder = instantiate(
            cfg.model.encoder,
            in_channels_src=input_dim,
            in_channels_dst=attr_ndims[h0],
            hidden_dim=self.hidden_dims[h0],
            **graph_kw(name_data, h0),
            **_accepted(cfg.model.encoder, common),
        )

        def level_processor(name: str) -> nn.Module:
            return instantiate(
                cfg.model.processor,
                num_channels=self.hidden_dims[name],
                num_layers=cfg.model.level_process_num_layers,
                **_accepted(cfg.model.processor, {**common, **graph_kw(name, name)}),
            )

        # processors per level on the way down, and up except on the coarsest level
        self.down_level_processor = nn.ModuleDict(
            {name: level_processor(name) for name in names} if self.level_process else {}
        )
        self.up_level_processor = nn.ModuleDict(
            {name: level_processor(name) for name in names[:-1]} if self.level_process else {}
        )
        self.downscale = nn.ModuleDict({
            src: instantiate(
                cfg.model.encoder,
                in_channels_src=self.hidden_dims[src],
                in_channels_dst=attr_ndims[dst],
                hidden_dim=self.hidden_dims[dst],
                **graph_kw(src, dst),
                **_accepted(cfg.model.encoder, common),
            )
            for src, dst in zip(names[:-1], names[1:])
        })
        self.upscale = nn.ModuleDict({
            src: instantiate(
                cfg.model.decoder,
                in_channels_src=self.hidden_dims[src],
                in_channels_dst=self.hidden_dims[dst],
                hidden_dim=self.hidden_dims[src],
                out_channels_dst=self.hidden_dims[dst],
                **graph_kw(src, dst),
                **_accepted(cfg.model.decoder, common),
            )
            for src, dst in zip(names[1:], names[:-1])
        })
        self.decoder = instantiate(
            cfg.model.decoder,
            in_channels_src=self.hidden_dims[h0],
            in_channels_dst=input_dim,
            hidden_dim=self.hidden_dims[h0],
            out_channels_dst=self.num_output_channels,
            **graph_kw(h0, name_data),
            **_accepted(cfg.model.decoder, common),
        )

    def forward(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        """x (batch, time, ensemble, grid, vars) -> (batch, ensemble, grid, vars_out).
        ``dropout_key``: the attention-dropout key of a ``deterministic=False``
        model; the down and up processors of level l fold in 2 l and 2 l + 1.
        Under a model-sharded mesh ``grid`` is this rank's rows of the data
        grid, and so is the output."""

        def key(i: int) -> Optional[int]:
            return None if dropout_key is None else fold_key(dropout_key, i)

        batch_size, _, ensemble_size, grid, _ = x.shape
        bse = batch_size * ensemble_size
        names, name_data = self._graph_hidden_names, self._graph_name_data
        rows = self._rank_rows([name_data, *names], grid)
        x_flat = x.permute(0, 2, 3, 1, 4).reshape(bse, grid, -1)
        x_trainable_data = torch.cat(
            [x_flat, self.node_attributes(name_data, bse, rows[name_data]).to(x_flat.dtype)], dim=-1
        )
        x_trainable_hiddens = {name: self.node_attributes(name, bse, rows[name]) for name in names}

        x_data_latent, curr_latent = self.encoder((x_trainable_data, x_trainable_hiddens[names[0]]))

        # down the pyramid, keeping each level's latent for its skip connection
        x_encoded_latents, x_skip = {}, {}
        for level, (src, dst) in enumerate(zip(names[:-1], names[1:])):
            if self.level_process:
                curr_latent = self.down_level_processor[src](curr_latent, key(2 * level))
            x_skip[src] = curr_latent
            x_encoded_latents[src], curr_latent = self.downscale[src]((curr_latent, x_trainable_hiddens[dst]))

        if self.level_process:
            curr_latent = self.down_level_processor[names[-1]](curr_latent, key(2 * (len(names) - 1)))

        # up the pyramid, with the skip connections
        for src, dst in zip(names[:0:-1], names[-2::-1]):
            curr_latent = self.upscale[src]((curr_latent, x_encoded_latents[dst])) + x_skip[dst]
            if self.level_process:
                curr_latent = self.up_level_processor[dst](curr_latent, key(2 * names.index(dst) + 1))

        x_out = self.decoder((curr_latent, x_data_latent))
        x_out = x_out.reshape(batch_size, ensemble_size, grid, self.num_output_channels).to(x.dtype)
        return self._finish(x_out, x)
