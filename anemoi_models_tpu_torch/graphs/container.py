"""Static heterogeneous graph container.

The port's own copy of ``anemoi_models_tpu/graphs/container.py``, its
``.npz`` serialization included (the same keys, so a ``graph.npz`` written
by either package loads in the other), with the numpy sort only. Everything here is
host-side ``numpy``: the graph is static model-build-time data; the layers
copy edge indices and attributes to the device when they are built.

Node sets are named ("data", "hidden", ...); edge sets are keyed by
``(src_name, "to", dst_name)``. Edge indices are stored pre-sorted by
destination node (CSR order), the order the edge-attention kernels walk.
"""


from __future__ import annotations

import os
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

    # -- serialization -----------------------------------------------------
    # A built graph round-trips through a flat dict of numpy arrays, so it can
    # ride an ``.npz`` file or a checkpoint's supporting arrays. Keys:
    # ``node::<name>::coords``, ``node::<name>::attr::<a>``,
    # ``edge::<src>::<rel>::<dst>::edge_index``, ``::dst_ptr``, ``::attr::<a>``.

    def to_arrays(self) -> dict[str, np.ndarray]:
        """Flatten to ``{key: array}``; inverse of :meth:`from_arrays`."""
        names = list(self.nodes) + [p for k in self.edges for p in k] + [
            a for ns in self.nodes.values() for a in ns.attrs
        ] + [a for es in self.edges.values() for a in es.attrs]
        bad = [n for n in names if "::" in str(n)]
        if bad:
            raise ValueError(f"graph names may not contain '::' (key separator): {bad}")
        out: dict[str, np.ndarray] = {}
        for name, ns in self.nodes.items():
            out[f"node::{name}::coords"] = ns.coords
            for a, v in ns.attrs.items():
                out[f"node::{name}::attr::{a}"] = v
        for (src, rel, dst), es in self.edges.items():
            base = f"edge::{src}::{rel}::{dst}"
            out[f"{base}::edge_index"] = es.edge_index
            if es.dst_ptr is not None:
                out[f"{base}::dst_ptr"] = es.dst_ptr
            for a, v in es.attrs.items():
                out[f"{base}::attr::{a}"] = v
        return out

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray]) -> "HeteroGraph":
        """Rebuild a graph flattened by :meth:`to_arrays`."""
        nodes: dict[str, NodeSet] = {}
        edges: dict[tuple[str, str, str], EdgeSet] = {}
        for key, value in arrays.items():
            parts = key.split("::")
            if parts[0] == "node":
                ns = nodes.setdefault(parts[1], NodeSet(coords=np.empty((0, 2))))
                if parts[2] == "coords":
                    ns.coords = np.asarray(value)
                else:
                    ns.attrs[parts[3]] = np.asarray(value)
            elif parts[0] == "edge":
                es = edges.setdefault((parts[1], parts[2], parts[3]), EdgeSet(edge_index=np.empty((2, 0), np.int32)))
                if parts[4] == "edge_index":
                    es.edge_index = np.asarray(value)
                elif parts[4] == "dst_ptr":
                    es.dst_ptr = np.asarray(value)
                else:
                    es.attrs[parts[5]] = np.asarray(value)
        return cls(nodes=nodes, edges=edges)

    def save(self, path: str) -> str:
        """Write the graph to an ``.npz`` file; returns the path. Atomic (a
        tmp file, then a rename): an interrupted save leaves no truncated
        file behind."""
        final = path if path.endswith(".npz") else path + ".npz"
        tmp = final + f".tmp-{os.getpid()}.npz"
        try:
            np.savez_compressed(tmp, **self.to_arrays())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return final

    @classmethod
    def load(cls, path: str) -> "HeteroGraph":
        """Read a graph written by :meth:`save` (of either package)."""
        with np.load(path) as z:
            return cls.from_arrays({k: z[k] for k in z.files})
