"""Host-side graph builders: grids, icosahedral meshes, and edge builders.

The port's own copy of ``anemoi_models_tpu/graphs/build.py``, limited to what
``build_enc_proc_dec_graph``, ``build_hierarchical_graph`` and
``nodes_from_coords`` run and to their numpy code paths (the mesh
subdivision in plain Python; the JAX package can also call a native helper
for O1280-scale builds, whose coordinates differ from these in the last bit
of some, which can flip the knn ties between the hierarchical levels'
coincident nodes). All construction is
``numpy``/``scipy`` at model-build time: graphs are static.

Conventions (matching what the reference's models expect of anemoi-graphs):
- node coords are (lat, lon) in **radians**, shape (N, 2)
- edge attribute ``edge_length``: normalized great-circle distance, shape (E, 1)
- edge attribute ``edge_dirs``: local tangent-plane displacement from source to
  destination (dlat, dlon*cos(lat_mid)), shape (E, 2)
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from anemoi_models_tpu_torch.graphs.container import EdgeSet, HeteroGraph, NodeSet

__all__ = [
    "latlon_grid_nodes",
    "octahedral_grid_nodes",
    "icosahedral_nodes",
    "morton_order",
    "rcm_order",
    "reorder_nodes",
    "knn_edges",
    "cutoff_edges",
    "multiscale_edges",
    "edge_attributes",
    "nodes_from_coords",
    "build_enc_proc_dec_graph",
    "build_hierarchical_graph",
]



def _latlon_to_xyz(latlon: np.ndarray) -> np.ndarray:
    lat, lon = latlon[:, 0], latlon[:, 1]
    return np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], axis=-1
    )


def _xyz_to_latlon(xyz: np.ndarray) -> np.ndarray:
    xyz = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    lat = np.arcsin(np.clip(xyz[:, 2], -1.0, 1.0))
    lon = np.arctan2(xyz[:, 1], xyz[:, 0])
    return np.stack([lat, lon], axis=-1)


def latlon_grid_nodes(num_lat: int, num_lon: int | None = None) -> NodeSet:
    """Regular equal-angle lat/lon grid (cell centers, poles excluded)."""
    if num_lon is None:
        num_lon = 2 * num_lat
    lats = np.linspace(np.pi / 2, -np.pi / 2, num_lat + 2)[1:-1]
    lons = np.linspace(-np.pi, np.pi, num_lon, endpoint=False)
    grid_lat, grid_lon = np.meshgrid(lats, lons, indexing="ij")
    coords = np.stack([grid_lat.ravel(), grid_lon.ravel()], axis=-1).astype(np.float64)
    # cos(lat) area weights, normalized to mean 1
    weights = np.cos(grid_lat.ravel())
    weights = weights / weights.mean()
    return NodeSet(coords=coords, attrs={"area_weight": weights[:, None].astype(np.float32)})


def octahedral_grid_nodes(resolution: int) -> NodeSet:
    """Octahedral reduced Gaussian grid O<resolution> (ECMWF-style).

    ``2 * resolution`` latitude rows at *true Gaussian latitudes* (Legendre
    roots of degree 2N: ``sin(lat_i)`` are the roots of P_2N, the quadrature
    nodes of the spectral transform grid); the row nearest each pole has 20
    points, growing by 4 per row toward the equator — so point density is
    near-uniform on the sphere (O96 = 40,320 points), unlike the equal-angle
    lat/lon grid whose polar rows over-sample longitude. Per-point area
    weights are the Gauss-Legendre quadrature weights split over the row.
    """
    from scipy.special import roots_legendre

    nrows = 2 * resolution
    sinlats, gauss_w = roots_legendre(nrows)
    order = np.argsort(-sinlats)  # north to south
    lats = np.arcsin(sinlats[order])
    gauss_w = gauss_w[order]

    rows_pts = []
    for i in range(nrows):
        # distance from nearer pole, 0-indexed
        k = i if i < resolution else nrows - 1 - i
        rows_pts.append(20 + 4 * k)

    coords = []
    weights = []
    for lat, npts, gw in zip(lats, rows_pts, gauss_w):
        lons = np.linspace(-np.pi, np.pi, npts, endpoint=False)
        coords.append(np.stack([np.full(npts, lat), lons], axis=-1))
        weights.append(np.full(npts, gw / npts))
    coords = np.concatenate(coords).astype(np.float64)
    w = np.concatenate(weights)
    w = w / w.mean()
    return NodeSet(coords=coords, attrs={"area_weight": w[:, None].astype(np.float32)})


def morton_order(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Spatial (Morton / Z-curve) ordering permutation of (lat, lon) nodes:
    the nodes sorted by the interleaved bits of their quantised latitude and
    longitude, so that a node's neighbours sit near it in index space. The
    graphs here order the mesh by :func:`rcm_order`, whose source spans are
    tighter; this is the alternative a caller can pass to
    :func:`reorder_nodes`."""
    lat = ((coords[:, 0] + np.pi / 2) / np.pi * ((1 << bits) - 1)).astype(np.uint64)
    lon = ((coords[:, 1] + np.pi) / (2 * np.pi) * ((1 << bits) - 1)).astype(np.uint64)

    def spread(v: np.ndarray) -> np.ndarray:
        v = v & np.uint64(0xFFFF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x33333333)
        v = (v | (v << np.uint64(1))) & np.uint64(0x55555555)
        return v

    key = (spread(lat) << np.uint64(1)) | spread(lon)
    return np.argsort(key, kind="stable")


def rcm_order(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Bandwidth-minimizing (reverse Cuthill-McKee) node ordering.

    Given an undirected-ish edge set (typically the *finest* mesh level —
    multiscale long-range edges would blow the bandwidth and are excluded),
    returns a permutation such that graph neighbors sit close in index space.
    This is what makes the fused edge-attention kernel's contiguous
    source-slab DMA possible: under fine-RCM, every 128-destination block of
    the refinement-5 mesh draws its 1-ring sources from a ≤512-row window
    (measured max span 450), versus ~5,000+ under a Z-curve.
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    src, dst = np.asarray(edge_index, dtype=np.int64)
    a = csr_matrix((np.ones(len(src)), (src, dst)), shape=(num_nodes, num_nodes))
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True), dtype=np.int64)


def reorder_nodes(nodes: NodeSet, perm: np.ndarray) -> tuple[NodeSet, np.ndarray]:
    """Apply a node permutation; returns (new nodes, old→new index map)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return (
        NodeSet(coords=nodes.coords[perm], attrs={k: v[perm] for k, v in nodes.attrs.items()}),
        inv,
    )


def _icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Vertices (12, 3) and faces (20, 3) of a unit icosahedron."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def _subdivide(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One loop-subdivision step on a triangulated sphere mesh."""
    edge_mid: dict[tuple[int, int], int] = {}
    new_verts = [verts]
    next_id = len(verts)

    def midpoint(a: int, b: int) -> int:
        nonlocal next_id
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            m = verts[a] + verts[b]
            m /= np.linalg.norm(m)
            new_verts.append(m[None, :])
            edge_mid[key] = next_id
            next_id += 1
        return edge_mid[key]

    new_faces = np.empty((len(faces) * 4, 3), dtype=np.int64)
    for i, (a, b, c) in enumerate(faces):
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces[4 * i:4 * i + 4] = [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.concatenate(new_verts, axis=0), new_faces


def icosahedral_nodes(refinements: int) -> tuple[NodeSet, list[np.ndarray]]:
    """Icosahedral sphere mesh nodes after ``refinements`` subdivisions.

    Returns the node set plus per-level face arrays (level 0 = base
    icosahedron) used to derive multi-scale edges. Subdivision preserves node
    ids across levels: coarse-level nodes are a prefix of the fine node set.
    """
    verts, faces = _icosahedron()
    face_levels = [faces]
    for _ in range(refinements):
        verts, faces = _subdivide(verts, faces)
        face_levels.append(faces)
    coords = _xyz_to_latlon(verts)
    return NodeSet(coords=coords), face_levels


def _faces_to_bidirectional_edges(faces: np.ndarray) -> np.ndarray:
    """Unique bidirectional edge_index (2, E) from a triangle list."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    return np.concatenate([e.T, e.T[::-1]], axis=1).astype(np.int32)


def multiscale_edges(face_levels: list[np.ndarray]) -> np.ndarray:
    """AIFS-style multi-scale mesh edges: union of edges from every level."""
    all_edges = np.concatenate(
        [_faces_to_bidirectional_edges(f) for f in face_levels], axis=1
    )
    return np.unique(all_edges, axis=1)


def knn_edges(src: NodeSet, dst: NodeSet, k: int) -> np.ndarray:
    """Each destination node connects to its k nearest source nodes."""
    tree = cKDTree(_latlon_to_xyz(src.coords))
    _, nbrs = tree.query(_latlon_to_xyz(dst.coords), k=k)
    nbrs = np.atleast_2d(nbrs)
    if k == 1:
        nbrs = nbrs.reshape(-1, 1)
    dst_ids = np.repeat(np.arange(dst.num_nodes, dtype=np.int64), k)
    return np.stack([nbrs.ravel(), dst_ids], axis=0).astype(np.int32)


def cutoff_edges(src: NodeSet, dst: NodeSet, radius: float) -> np.ndarray:
    """Each destination node connects to all source nodes within chordal
    ``radius`` (on the unit sphere; radius 2 = antipodes)."""
    src_xyz = _latlon_to_xyz(src.coords)
    dst_xyz = _latlon_to_xyz(dst.coords)
    tree = cKDTree(src_xyz)
    pairs = tree.query_ball_point(dst_xyz, r=radius)
    src_ids = np.concatenate([np.asarray(p, dtype=np.int64) for p in pairs]) if len(pairs) else np.empty(0, np.int64)
    dst_ids = np.repeat(np.arange(dst.num_nodes, dtype=np.int64), [len(p) for p in pairs])
    return np.stack([src_ids, dst_ids], axis=0).astype(np.int32)


def edge_attributes(src: NodeSet, dst: NodeSet, edge_index: np.ndarray) -> dict[str, np.ndarray]:
    """Standard edge attributes: normalized great-circle length + direction."""
    a = src.coords[edge_index[0]]
    b = dst.coords[edge_index[1]]
    # great-circle angle via chord length
    chord = np.linalg.norm(_latlon_to_xyz(np.atleast_2d(b)) - _latlon_to_xyz(np.atleast_2d(a)), axis=-1)
    angle = 2.0 * np.arcsin(np.clip(chord / 2.0, 0.0, 1.0))
    length = (angle / max(angle.max(), 1e-12)).astype(np.float32)[:, None]
    dlat = b[:, 0] - a[:, 0]
    dlon = np.remainder(b[:, 1] - a[:, 1] + np.pi, 2 * np.pi) - np.pi
    lat_mid = 0.5 * (a[:, 0] + b[:, 0])
    dirs = np.stack([dlat, dlon * np.cos(lat_mid)], axis=-1).astype(np.float32)
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = np.divide(dirs, norm, out=np.zeros_like(dirs), where=norm > 1e-12)
    return {"edge_length": length, "edge_dirs": dirs}


def nodes_from_coords(coords: np.ndarray, area_weight: np.ndarray | None = None) -> NodeSet:
    """Wrap arbitrary (lat, lon)-radian coordinates, e.g. a dataset's own
    grid, as a data NodeSet. Area weights default to cos(lat) normalized to
    mean 1 (exact for any latitude-banded grid, a good proxy otherwise)."""
    coords = np.asarray(coords, np.float64)
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (N, 2) lat/lon radians; got {coords.shape}")
    if area_weight is None:
        area_weight = np.cos(coords[:, 0])
        area_weight = area_weight / max(area_weight.mean(), 1e-12)
    area_weight = np.asarray(area_weight, np.float32).reshape(len(coords), -1)
    return NodeSet(coords=coords, attrs={"area_weight": area_weight})


def build_enc_proc_dec_graph(
    *,
    grid_lat: int = 32,
    grid: str = "latlon",
    data_nodes: NodeSet | None = None,
    mesh_refinements: int = 3,
    encoder_cutoff_factor: float = 1.6,
    decoder_knn: int = 3,
    data_name: str = "data",
    hidden_name: str = "hidden",
    data_order: str = "rows",
) -> HeteroGraph:
    """Build the canonical AIFS-style graph: data grid + icosahedral hidden
    mesh, cutoff encoder edges, multi-scale processor edges, knn decoder
    edges. Edge sets come out CSR-sorted by destination.

    ``grid``: "latlon" (equal-angle, ``grid_lat`` rows) or "octahedral"
    (reduced Gaussian O<grid_lat> — near-uniform density, no polar
    in-degree skew).

    ``data_order``: "rows" keeps the grid's native latitude-row order;
    "mesh" renumbers data points along the hidden mesh's RCM curve (nearest
    hidden node's position) so the *decoder* conv gets bounded source spans
    and qualifies for the slot kernel. The original row index of every point
    is kept in ``nodes["data"].attrs["source_index"]`` for ingest-time
    permutation of row-ordered datasets.
    """
    if data_nodes is None:
        if grid == "octahedral":
            data_nodes = octahedral_grid_nodes(grid_lat)
        else:
            data_nodes = latlon_grid_nodes(grid_lat)
    hidden_nodes, face_levels = icosahedral_nodes(mesh_refinements)
    # bandwidth-minimizing renumbering of mesh nodes (fine-level RCM) for
    # gather locality and the edge-attention kernel's contiguous source slabs
    perm = rcm_order(
        _faces_to_bidirectional_edges(face_levels[-1]), hidden_nodes.num_nodes
    )
    hidden_nodes, old_to_new = reorder_nodes(hidden_nodes, perm)
    face_levels = [old_to_new[f] for f in face_levels]

    if data_order == "mesh":
        from scipy.spatial import cKDTree

        tree = cKDTree(_latlon_to_xyz(hidden_nodes.coords))
        _, nearest = tree.query(_latlon_to_xyz(data_nodes.coords))
        dperm = np.argsort(nearest, kind="stable")
        data_nodes, _ = reorder_nodes(data_nodes, dperm)
        data_nodes.attrs["source_index"] = dperm.astype(np.int32)[:, None]

    # encoder: every data point feeds the hidden nodes within a cutoff radius
    # proportional to the hidden mesh's resolution
    mesh_edge = _faces_to_bidirectional_edges(face_levels[-1])
    mesh_xyz = _latlon_to_xyz(hidden_nodes.coords)
    typical = np.linalg.norm(mesh_xyz[mesh_edge[0]] - mesh_xyz[mesh_edge[1]], axis=-1).mean()
    enc_idx = cutoff_edges(data_nodes, hidden_nodes, radius=encoder_cutoff_factor * typical)

    proc_idx = multiscale_edges(face_levels)
    dec_idx = knn_edges(hidden_nodes, data_nodes, k=decoder_knn)

    graph = HeteroGraph(
        nodes={data_name: data_nodes, hidden_name: hidden_nodes},
        edges={
            (data_name, "to", hidden_name): EdgeSet(
                edge_index=enc_idx, attrs=edge_attributes(data_nodes, hidden_nodes, enc_idx)
            ),
            (hidden_name, "to", hidden_name): EdgeSet(
                edge_index=proc_idx, attrs=edge_attributes(hidden_nodes, hidden_nodes, proc_idx)
            ),
            (hidden_name, "to", data_name): EdgeSet(
                edge_index=dec_idx, attrs=edge_attributes(hidden_nodes, data_nodes, dec_idx)
            ),
        },
    )
    return graph.sorted()


def build_hierarchical_graph(
    *,
    grid_lat: int = 32,
    grid: str = "latlon",
    data_nodes: NodeSet | None = None,
    mesh_refinements: int = 3,
    num_levels: int = 2,
    encoder_cutoff_factor: float = 1.6,
    decoder_knn: int = 3,
    level_knn: int = 3,
    data_name: str = "data",
    hidden_prefix: str = "hidden",
) -> tuple[HeteroGraph, list[str]]:
    """Multi-level graph for the hierarchical model: the data grid and a
    pyramid of icosahedral meshes at decreasing refinement, each in its own
    fine-level RCM order.

    Edge sets: data -> h1 (cutoff), h_i -> h_i (the level's own mesh edges),
    h_i -> h_{i+1} (downscale, knn), h_{i+1} -> h_i (upscale, knn), h1 -> data
    (knn), each sorted by destination. Returns (graph, hidden_names) with the
    names ordered fine to coarse, the layout the hierarchical model reads.
    """
    if num_levels < 1 or mesh_refinements - (num_levels - 1) < 0:
        raise ValueError(f"{num_levels} levels need at least {num_levels - 1} mesh refinements, "
                         f"got {mesh_refinements}")
    if data_nodes is None:
        data_nodes = octahedral_grid_nodes(grid_lat) if grid == "octahedral" else latlon_grid_nodes(grid_lat)
    hidden_names = [f"{hidden_prefix}_{i + 1}" for i in range(num_levels)]
    level_nodes: list[NodeSet] = []
    level_faces: list[np.ndarray] = []
    for i in range(num_levels):
        ns, faces = icosahedral_nodes(mesh_refinements - i)
        perm = rcm_order(_faces_to_bidirectional_edges(faces[-1]), ns.num_nodes)
        ns, old_to_new = reorder_nodes(ns, perm)
        level_nodes.append(ns)
        level_faces.append(old_to_new[faces[-1]])

    nodes = {data_name: data_nodes}
    edges: dict[tuple[str, str, str], EdgeSet] = {}

    def add_edge(src_name: str, dst_name: str, src_ns: NodeSet, dst_ns: NodeSet, idx: np.ndarray) -> None:
        edges[(src_name, "to", dst_name)] = EdgeSet(edge_index=idx, attrs=edge_attributes(src_ns, dst_ns, idx))

    # encoder: data -> the finest level, within a cutoff proportional to its resolution
    fine = level_nodes[0]
    mesh_edge = _faces_to_bidirectional_edges(level_faces[0])
    mesh_xyz = _latlon_to_xyz(fine.coords)
    typical = np.linalg.norm(mesh_xyz[mesh_edge[0]] - mesh_xyz[mesh_edge[1]], axis=-1).mean()
    add_edge(data_name, hidden_names[0], data_nodes, fine,
             cutoff_edges(data_nodes, fine, radius=encoder_cutoff_factor * typical))

    for i, name in enumerate(hidden_names):
        nodes[name] = level_nodes[i]
        add_edge(name, name, level_nodes[i], level_nodes[i], _faces_to_bidirectional_edges(level_faces[i]))
        if i + 1 < num_levels:
            add_edge(name, hidden_names[i + 1], level_nodes[i], level_nodes[i + 1],
                     knn_edges(level_nodes[i], level_nodes[i + 1], k=level_knn))
            add_edge(hidden_names[i + 1], name, level_nodes[i + 1], level_nodes[i],
                     knn_edges(level_nodes[i + 1], level_nodes[i], k=level_knn))

    add_edge(hidden_names[0], data_name, fine, data_nodes, knn_edges(fine, data_nodes, k=decoder_knn))
    return HeteroGraph(nodes=nodes, edges=edges).sorted(), hidden_names
