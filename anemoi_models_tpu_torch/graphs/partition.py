"""Host-side plans for sharding an edge set over the ``model`` axis.

The port's copy of the parts of ``anemoi_models_tpu/graphs/partition.py``
that say which rank needs which rows, as plain numpy:

- :class:`HaloPartition` and :func:`partition_1hop`: the 1-hop halo plan of a
  self-graph (the processor's) over a contiguous split of its nodes.

Each rank then turns its part into the structures the port's kernels take:
a CSR list by destination and its :class:`CSRTranspose`
(:func:`halo_shard`; :func:`mapper_shard` for a bipartite (mapper) edge
set, split by destination as the JAX package's ``mapper_shard_tables``
splits it). The JAX package's bucketed, transpose-position and slot tables,
``mapper_shard_tables`` among them, are not ported: they exist because the
TPU cannot gather inside VMEM and serialises scatters, and a Hopper kernel
loads rows by index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from anemoi_models_tpu_torch.ops.edge_attention import CSRTranspose, csr_from_edge_index, csr_transpose

__all__ = [
    "HaloPartition",
    "HaloShard",
    "MapperShard",
    "halo_shard",
    "mapper_shard",
    "partition_1hop",
]


@dataclass
class HaloPartition:
    """Host-side plan for 1-hop halo exchange over a contiguous node split.

    Destination nodes are split contiguously over ``num_shards`` (every
    shard owns ``nodes_per_shard`` rows but the last). For each shard, the
    incoming edges are remapped so source positions index an extended
    per-shard tensor ``[local nodes | halo nodes]``; halo features come from
    a global *boundary pool*, assembled by one all-gather of each shard's
    boundary contribution.

    Arrays (S = num_shards):
    - ``local_edges``: (S, E_pad, 2) int32, per-shard [src_ext, dst_local]
      edge list, padded with (0, 0);
    - ``edge_mask``: (S, E_pad) bool;
    - ``boundary_contrib``: (S, B_pad) int32, the local node positions each
      shard contributes to the boundary pool (padded with 0);
    - ``halo_select``: (S, H_pad) int32, positions into the flattened
      (S * B_pad) boundary pool forming each shard's halo (padded with 0);
    - ``halo_mask``: (S, H_pad) bool;
    - ``edge_ids``: (S, E_pad) global edge id of each shard slot.
    """

    num_shards: int
    num_nodes: int
    nodes_per_shard: int
    local_edges: np.ndarray
    edge_mask: np.ndarray
    boundary_contrib: np.ndarray
    halo_select: np.ndarray
    halo_mask: np.ndarray
    edge_ids: np.ndarray = None

    @property
    def halo_width(self) -> int:
        return self.halo_select.shape[1]


def partition_1hop(edge_index: np.ndarray, num_nodes: int, num_shards: int) -> HaloPartition:
    """Build a :class:`HaloPartition` for a homogeneous edge set."""
    src, dst = np.asarray(edge_index, dtype=np.int64)
    nps = -(-num_nodes // num_shards)  # ceil: equal shards with tail padding

    shard_of = lambda n: np.minimum(n // nps, num_shards - 1)  # noqa: E731

    per_shard_edges: list[np.ndarray] = []
    per_shard_halo: list[np.ndarray] = []
    per_shard_edge_ids: list[np.ndarray] = []
    for s in range(num_shards):
        lo, hi = s * nps, min((s + 1) * nps, num_nodes)
        sel = (dst >= lo) & (dst < hi)
        e_src, e_dst = src[sel], dst[sel]
        remote = e_src[(e_src < lo) | (e_src >= hi)]
        per_shard_halo.append(np.unique(remote))
        per_shard_edges.append(np.stack([e_src, e_dst - lo], axis=1))
        per_shard_edge_ids.append(np.nonzero(sel)[0])

    # boundary pool: nodes needed by any other shard, grouped by owner
    needed = np.unique(np.concatenate(per_shard_halo)) if per_shard_halo else np.empty(0, np.int64)
    owner = shard_of(needed)
    b_pad = max(int(np.max(np.bincount(owner, minlength=num_shards))) if needed.size else 0, 1)
    boundary_contrib = np.zeros((num_shards, b_pad), dtype=np.int32)
    pool_pos = {}  # global node id -> position in the flattened boundary pool
    for s in range(num_shards):
        mine = needed[owner == s]
        boundary_contrib[s, : len(mine)] = (mine - s * nps).astype(np.int32)
        for i, n in enumerate(mine):
            pool_pos[int(n)] = s * b_pad + i

    h_pad = max(max((len(h) for h in per_shard_halo), default=0), 1)
    halo_select = np.zeros((num_shards, h_pad), dtype=np.int32)
    halo_mask = np.zeros((num_shards, h_pad), dtype=bool)
    e_pad = max(max((len(e) for e in per_shard_edges), default=0), 1)
    local_edges = np.zeros((num_shards, e_pad, 2), dtype=np.int32)
    edge_mask = np.zeros((num_shards, e_pad), dtype=bool)
    edge_ids = np.zeros((num_shards, e_pad), dtype=np.int64)

    for s in range(num_shards):
        lo = s * nps
        halo = per_shard_halo[s]
        halo_select[s, : len(halo)] = [pool_pos[int(n)] for n in halo]
        halo_mask[s, : len(halo)] = True
        # remap edge sources: local -> position, halo -> nps + halo_rank
        e = per_shard_edges[s]
        gsrc = e[:, 0]
        local = (gsrc >= lo) & (gsrc < lo + nps)
        src_ext = np.where(local, gsrc - lo, nps + np.searchsorted(halo, gsrc)).astype(np.int32)
        local_edges[s, : len(e), 0] = src_ext
        local_edges[s, : len(e), 1] = e[:, 1]
        edge_mask[s, : len(e)] = True
        edge_ids[s, : len(e)] = per_shard_edge_ids[s]

    return HaloPartition(
        num_shards=num_shards,
        num_nodes=num_nodes,
        nodes_per_shard=nps,
        local_edges=local_edges,
        edge_mask=edge_mask,
        boundary_contrib=boundary_contrib,
        halo_select=halo_select,
        halo_mask=halo_mask,
        edge_ids=edge_ids,
    )


# ---------------------------------------------------------------------------
# one rank's part, in the structures of the port's kernels
# ---------------------------------------------------------------------------


class HaloShard(NamedTuple):
    """Rank ``shard``'s part of a :class:`HaloPartition`, on a device.

    Its destinations are its ``num_local`` own rows; its sources index
    ``[own rows | halo rows]`` (``num_ext`` rows): the CSR ``rowptr``,
    ``src`` and its transpose ``csr_t``. Its edges are the global edges
    ``[edge_lo, edge_hi)`` (a contiguous range, as the global list is sorted
    by destination), in the same order. ``contrib`` (B_pad,) are the own rows
    it puts into the boundary pool, ``halo`` (H,) the pool rows of its halo."""

    shard: int
    num_shards: int
    num_local: int
    num_ext: int
    edge_lo: int
    edge_hi: int
    rowptr: torch.Tensor
    src: torch.Tensor
    csr_t: CSRTranspose
    contrib: torch.Tensor
    halo: torch.Tensor


def halo_shard(part: HaloPartition, shard: int, device) -> HaloShard:
    """Rank ``shard``'s :class:`HaloShard`. The partition's padding (own
    rows past the last real node, edge slots past the shard's edges, halo
    slots past its halo) has no counterpart: dead rows and edges are simply
    absent from the CSR, and a destination with no edge keeps the
    dead-destination contract of the kernels (m = -1e30, den = 0)."""
    nps = part.nodes_per_shard
    lo = min(shard * nps, part.num_nodes)
    num_local = min(lo + nps, part.num_nodes) - lo
    live = part.edge_mask[shard]
    edges = part.local_edges[shard][live].astype(np.int64)
    halo_n = int(part.halo_mask[shard].sum())
    # [own rows (nps, padded) | halo] -> [own rows (num_local) | halo]
    src_ext = np.where(edges[:, 0] < nps, edges[:, 0], edges[:, 0] - (nps - num_local))
    num_ext = num_local + halo_n
    rowptr, src = csr_from_edge_index(np.stack([src_ext, edges[:, 1]]), num_ext, num_local)
    ids = part.edge_ids[shard][live]
    edge_lo = int(ids[0]) if ids.size else 0
    if ids.size and not np.array_equal(ids, np.arange(edge_lo, edge_lo + ids.size)):
        raise ValueError("the shard's edges are not a contiguous range of a destination-sorted edge list")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=device)

    return HaloShard(
        shard=shard, num_shards=part.num_shards, num_local=num_local, num_ext=num_ext,
        edge_lo=edge_lo, edge_hi=edge_lo + int(ids.size), rowptr=t(rowptr), src=t(src),
        csr_t=CSRTranspose(*(t(a) for a in csr_transpose(rowptr, src, num_ext))),
        contrib=t(part.boundary_contrib[shard]).long(), halo=t(part.halo_select[shard][:halo_n]).long(),
    )


class MapperShard(NamedTuple):
    """Rank ``shard``'s part of a destination-sharded bipartite edge set, on
    a device: its destinations ``[dst_lo, dst_hi)`` of the bipartite set's
    ``num_src`` sources and its destinations, its edges ``[edge_lo,
    edge_hi)`` in the global order, the global source rows they read
    (``src_rows``, ascending) and the CSR over those rows (``rowptr``,
    ``src`` into ``src_rows``, ``csr_t``)."""

    shard: int
    num_shards: int
    num_src: int
    dst_lo: int
    dst_hi: int
    edge_lo: int
    edge_hi: int
    src_rows: torch.Tensor
    rowptr: torch.Tensor
    src: torch.Tensor
    csr_t: CSRTranspose


def mapper_shard(edge_index: np.ndarray, num_src: int, num_dst: int, shards: int, shard: int,
                 device) -> MapperShard:
    """Rank ``shard``'s :class:`MapperShard` of a destination-sorted edge set:
    the ceil split of the destinations, as the JAX package's
    ``mapper_shard_tables`` splits them."""
    rowptr, src = csr_from_edge_index(edge_index, num_src, num_dst)
    nps = -(-num_dst // shards)
    lo = min(shard * nps, num_dst)
    hi = min(lo + nps, num_dst)
    e_lo, e_hi = int(rowptr[lo]), int(rowptr[hi])
    rows, local_src = np.unique(src[e_lo:e_hi], return_inverse=True)
    local_rowptr = rowptr[lo:hi + 1] - rowptr[lo]
    local_src = local_src.astype(np.int32)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return MapperShard(
        shard=shard, num_shards=shards, num_src=num_src, dst_lo=lo, dst_hi=hi, edge_lo=e_lo, edge_hi=e_hi,
        src_rows=t(rows, torch.long), rowptr=t(local_rowptr), src=t(local_src),
        csr_t=CSRTranspose(*(t(a) for a in csr_transpose(local_rowptr, local_src, rows.size))),
    )
