"""Static heterogeneous graph container.

The port's own copy of ``anemoi_models_tpu/graphs/container.py``, without
its ``.npz`` serialization and with the numpy sort only. Everything here is
host-side ``numpy``: the graph is static model-build-time data; the layers
copy edge indices and attributes to the device when they are built.

Node sets are named ("data", "hidden", ...); edge sets are keyed by
``(src_name, "to", dst_name)``. Edge indices are stored pre-sorted by
destination node (CSR order), the order the edge-attention kernels walk.
"""


from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

__all__ = ["NodeSet", "EdgeSet", "HeteroGraph"]


@dataclass
class NodeSet:
    """A named set of graph nodes.

    Attributes
    ----------
    coords : np.ndarray, shape (num_nodes, coord_dim)
        Node coordinates in radians (lat, lon). The model registers
        sin/cos features of these (reference ``layers/graph.py:90-93``).
    attrs : dict[str, np.ndarray]
        Additional per-node attributes (e.g. area weights).
    """

    coords: np.ndarray
    attrs: dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return int(self.coords.shape[0])

    @property
    def x(self) -> np.ndarray:
        """Alias matching the reference's ``nodes.x`` coordinate access."""
        return self.coords

    def __getitem__(self, key: str) -> np.ndarray:
        if key in ("x", "coords"):
            return self.coords
        return self.attrs[key]


@dataclass
class EdgeSet:
    """A named set of directed edges between two node sets.

    Attributes
    ----------
    edge_index : np.ndarray, shape (2, num_edges), int32
        Row 0 = source node ids, row 1 = destination node ids.
        Stored sorted by destination (ties broken by source) — CSR order.
    attrs : dict[str, np.ndarray]
        Per-edge attributes, each of shape (num_edges, d).
    dst_ptr : np.ndarray | None
        CSR row offsets into ``edge_index`` per destination node
        (len = num_dst_nodes + 1), if the edge set has been CSR-indexed.
    """

    edge_index: np.ndarray
    attrs: dict[str, np.ndarray] = field(default_factory=dict)
    dst_ptr: np.ndarray | None = None

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def __getitem__(self, key: str) -> np.ndarray:
        if key == "edge_index":
            return self.edge_index
        return self.attrs[key]

    def __contains__(self, key: str) -> bool:
        return key == "edge_index" or key in self.attrs

    def attr_tensor(self, names: list[str]) -> np.ndarray:
        """Concatenate named edge attributes along the feature axis."""
        return np.concatenate([np.asarray(self.attrs[n], dtype=np.float32) for n in names], axis=1)

    def sort_by_dst(self, num_dst: int) -> "EdgeSet":
        """Return a copy sorted by destination node with CSR offsets.

        Orders by (dst, src) with ``np.lexsort``.
        """
        src, dst = self.edge_index
        order = np.lexsort((src, dst))
        dst_ptr = np.zeros(num_dst + 1, dtype=np.int64)
        np.add.at(dst_ptr, dst.astype(np.int64) + 1, 1)
        dst_ptr = np.cumsum(dst_ptr)
        edge_index = self.edge_index[:, order].astype(np.int32)
        attrs = {k: v[order] for k, v in self.attrs.items()}
        return EdgeSet(edge_index=edge_index, attrs=attrs, dst_ptr=dst_ptr)


class HeteroGraph:
    """Named node sets plus directed edge sets between them."""

    def __init__(
        self,
        nodes: dict[str, NodeSet] | None = None,
        edges: dict[tuple[str, str, str], EdgeSet] | None = None,
    ) -> None:
        self.nodes: dict[str, NodeSet] = nodes or {}
        self.edges: dict[tuple[str, str, str], EdgeSet] = edges or {}

    # -- reference-HeteroData-compatible access ---------------------------
    def __getitem__(self, key):
        if isinstance(key, tuple):
            return self.edges[key]
        return self.nodes[key]

    def __setitem__(self, key, value) -> None:
        if isinstance(key, tuple):
            self.edges[key] = value
        else:
            self.nodes[key] = value

    def __contains__(self, key) -> bool:
        if isinstance(key, tuple):
            return key in self.edges
        return key in self.nodes

    @property
    def node_types(self) -> list[str]:
        return list(self.nodes.keys())

    def node_items(self) -> Iterator[tuple[str, NodeSet]]:
        return iter(self.nodes.items())

    def edge_items(self) -> Iterator[tuple[tuple[str, str, str], EdgeSet]]:
        return iter(self.edges.items())

    def sorted(self) -> "HeteroGraph":
        """Return a copy with every edge set sorted by destination (CSR)."""
        edges = {
            key: es.sort_by_dst(self.nodes[key[2]].num_nodes) for key, es in self.edges.items()
        }
        return HeteroGraph(nodes=dict(self.nodes), edges=edges)
