"""K-hop edge utilities (host-side).

The port's copy of ``anemoi_models_tpu/graphs/khop.py`` (API parity with the
reference's ``distributed/khop_edges.py``): the k-hop closure and the
destination-range chunks of an edge set, computed once at build time with
scipy.sparse; runtime sharding uses ``graphs/partition.py:partition_1hop``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["get_k_hop_edges", "sort_edges_1hop_chunks"]


def get_k_hop_edges(edge_index: np.ndarray, num_nodes: int, num_hops: int) -> np.ndarray:
    """Edges of the k-hop closure: (u, v) if v is reachable from u in
    <= num_hops steps (k >= 1), deduplicated, CSR-sorted by destination."""
    src, dst = np.asarray(edge_index, dtype=np.int64)
    adj = sp.csr_matrix((np.ones(len(src), dtype=bool), (src, dst)), shape=(num_nodes, num_nodes))
    reach = adj.copy()
    power = adj
    for _ in range(num_hops - 1):
        power = (power @ adj).astype(bool)
        reach = (reach + power).astype(bool)
    coo = reach.tocoo()
    order = np.lexsort((coo.row, coo.col))
    return np.stack([coo.row[order], coo.col[order]]).astype(np.int32)


def sort_edges_1hop_chunks(
    edge_index: np.ndarray, num_dst: int, num_chunks: int
) -> list[np.ndarray]:
    """Split a CSR-sorted edge set into chunks along contiguous destination
    ranges (each chunk's destinations are disjoint — per-destination softmax
    normalization stays chunk-local, the property the reference's runtime
    re-sort establishes at ``khop_edges.py:88-105``).

    Returns per-chunk index arrays into the edge list.
    """
    dst = np.asarray(edge_index[1])
    assert np.all(np.diff(dst) >= 0), "edge_index must be CSR-sorted by destination"
    bounds = [round(i * num_dst / num_chunks) for i in range(num_chunks + 1)]
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sel = np.nonzero((dst >= lo) & (dst < hi))[0]
        out.append(sel.astype(np.int64))
    return out
