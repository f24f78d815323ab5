"""1-hop halo exchange over the ``model`` axis.

Counterpart of ``anemoi_models_tpu/parallel/halo.py``. Node rows are split
contiguously over the ``model`` axis, and each layer exchanges only the
*boundary pool*, the rows some other rank's edges read, with one all-gather
of O(boundary) payload instead of the reference's all-gather of every node
(``sync_tensor`` before each layer). The plan is
:func:`~anemoi_models_tpu_torch.graphs.partition.partition_1hop`'s; each
rank reads its part as a :class:`~anemoi_models_tpu_torch.graphs.partition.HaloShard`.

The JAX package runs the exchange inside ``shard_map`` on global arrays.
Here each rank holds only its rows: :func:`halo_exchange` takes them to
``[own rows | halo rows]``, and its adjoint returns each halo row's gradient
to the rank that owns the row (the all-gather's adjoint sums the ranks'
cotangents of the pool, the row takes' adjoints put them in place).
"""

from __future__ import annotations

import torch

from anemoi_models_tpu_torch.graphs.partition import HaloPartition, HaloShard
from anemoi_models_tpu_torch.parallel.primitives import sync_tensor

__all__ = ["halo_exchange", "pad_nodes", "unpad_nodes"]


def pad_nodes(x: torch.Tensor, part: HaloPartition) -> torch.Tensor:
    """Pad the node axis (-2) to ``num_shards * nodes_per_shard`` rows."""
    pad = part.num_shards * part.nodes_per_shard - x.shape[-2]
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, pad))


def unpad_nodes(x: torch.Tensor, part: HaloPartition) -> torch.Tensor:
    """Drop node-axis padding rows."""
    return x[..., : part.num_nodes, :]


def halo_exchange(x: torch.Tensor, shard: HaloShard) -> torch.Tensor:
    """(B, num_local, C) own rows -> (B, num_ext, C) ``[own | halo]``: the
    rank's boundary rows go into the pool by one all-gather over ``model``,
    and its halo rows are taken from the pool."""
    contrib = x.index_select(1, shard.contrib)  # (B, B_pad, C); padding slots repeat row 0, unread
    pool = sync_tensor(contrib, dim=1, axis="model", size=shard.num_shards * contrib.shape[1])
    return torch.cat([x, pool.index_select(1, shard.halo)], dim=1)

