"""Node- and edge-attribute layers: trainable tensors + sin/cos coordinates.

Counterpart of ``anemoi_models_tpu/layers/graph.py``. Node attributes keep
the explicit batch axis of the JAX layers, (batch, nodes, feat). Edge
attributes are batch-invariant (the trainable part is one parameter for every
batch element), and the edge-attention kernel reads them once for all batch
elements, so :class:`TrainableTensor` returns (rows, feat) without a batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

__all__ = ["TrainableTensor", "NamedNodesAttributes"]


class TrainableTensor(nn.Module):
    """Concatenate a zero-initialised trainable per-row embedding to x."""

    def __init__(self, tensor_size: int, trainable_size: int, *, device=None) -> None:
        super().__init__()
        self.trainable = (
            nn.Parameter(torch.zeros(tensor_size, trainable_size, device=device))
            if trainable_size > 0 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (rows, feat) -> (rows, feat + trainable_size), in x's dtype."""
        if self.trainable is None:
            return x
        return torch.cat([x, self.trainable.to(x.dtype)], dim=-1)


class NamedNodesAttributes(nn.Module):
    """Per-node-set attributes: sin/cos of coordinates + trainable embedding.

    ``attr_ndims[name] = 2 * coord_dim + num_trainable_params``.
    """

    def __init__(self, num_trainable_params: int, graph_data, *, device=None) -> None:
        super().__init__()
        self.num_nodes = {name: ns.num_nodes for name, ns in graph_data.node_items()}
        self.attr_ndims = {
            name: 2 * ns.coords.shape[1] + num_trainable_params
            for name, ns in graph_data.node_items()
        }
        for name, ns in graph_data.node_items():
            sincos = np.concatenate([np.sin(ns.coords), np.cos(ns.coords)], axis=-1)
            self.register_buffer(
                f"latlons_{name}", torch.as_tensor(sincos, dtype=torch.float32, device=device),
                persistent=False,
            )
        self.trainable = nn.ParameterDict(
            {
                name: nn.Parameter(torch.zeros(n, num_trainable_params, device=device))
                for name, n in self.num_nodes.items()
            }
            if num_trainable_params > 0 else {}
        )

    def forward(self, name: str, batch_size: int, rows: Optional[tuple[int, int]] = None) -> torch.Tensor:
        """(batch, num_nodes, attr_ndims[name]) fp32 node features; with
        ``rows`` = ``(lo, hi)``, those rows only (a rank's, under a mesh)."""
        x = getattr(self, f"latlons_{name}")
        if name in self.trainable:
            x = torch.cat([x, self.trainable[name]], dim=-1)
        if rows is not None:
            x = x[rows[0]:rows[1]]
        return x.unsqueeze(0).expand(batch_size, *x.shape)
