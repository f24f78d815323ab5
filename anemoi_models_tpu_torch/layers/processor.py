"""Processors on the hidden mesh: chunked stacks of blocks.

Counterparts of ``TransformerProcessor``, ``GNNProcessor``,
``GraphTransformerProcessor``, ``HaloGNNProcessor`` and ``register_edges``
in ``anemoi_models_tpu/layers/processor.py``. A graph processor's edge set is
registered once at construction as a CSR list (``rowptr``, ``src``), its
transpose for the attention backward (``perm_t``, ``colptr_t``, ``dst_t``, ``pos_t``)
and its static attributes. The Transformer processor attends over mesh
positions and takes no graph.

Under a mesh whose ``model`` axis is larger than 1
(:func:`~anemoi_models_tpu_torch.parallel.api.model_sharded`), each rank
holds its rows of the hidden mesh and the graph processors take the halo
paths (``parallel/halo_conv.py``) on the rank's part of the edge set
(:func:`halo_shard_of`), as the JAX processors route to them
(``processor.py:110-140``); the Transformer's attention takes its halo
window path (``layers/attention.py``).

Each processor takes every field of its JAX class. Its chunks (or, in
``HaloGNNProcessor``, its layers) are the remat units of ``layers/remat.py``
under ``remat_policy`` and ``cpu_offload``. The JAX fields that lay the
computation out for the TPU (:data:`TPU_ONLY`) are taken at their defaults
only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from anemoi_models_tpu_torch.graphs.partition import (
    HaloShard,
    MapperShard,
    halo_shard,
    mapper_shard,
    partition_1hop,
)
from anemoi_models_tpu_torch.layers.chunk import (
    GNNProcessorChunk,
    GraphTransformerProcessorChunk,
    TransformerProcessorChunk,
)
from anemoi_models_tpu_torch.layers.graph import TrainableTensor
from anemoi_models_tpu_torch.layers.mlp import MLP
from anemoi_models_tpu_torch.layers.remat import run_unit
from anemoi_models_tpu_torch.ops.edge_attention import CSRTranspose, csr_from_edge_index, csr_transpose
from anemoi_models_tpu_torch.parallel.api import Mesh, model_sharded
from anemoi_models_tpu_torch.parallel.halo_conv import halo_graph_conv

__all__ = [
    "TransformerProcessor",
    "GNNProcessor",
    "GraphTransformerProcessor",
    "HaloGNNProcessor",
    "register_edges",
    "register_edge_buffers",
    "edge_csr_t",
    "halo_shard_of",
    "mapper_shard_of",
    "check_tpu_only",
]

# Layouts of the JAX package's convs; the port has one CSR path for each.
GRAPH_IMPLS = ("dense", "pallas")
GNN_GRAPH_IMPLS = ("dense", "pallas", "segment")
# JAX layer fields that lay the computation out for the TPU: (default, what it does there)
TPU_ONLY = {
    "layer_scan": (False, "nn.scan over stacked layer parameters, to bound the size of XLA's program"),
    "kv_src_gather": ("auto", "a dataflow of the TPU's bucketed gather tables; the port has one CSR path"),
    "plan_block_nodes": (0, "the geometry of a TPU slot-kernel plan (graphs/kernel_plan.py)"),
    "plan_slab_width": (0, "the geometry of a TPU slot-kernel plan (graphs/kernel_plan.py)"),
}


def check_tpu_only(layer: str, **values) -> None:
    """Raises unless each of the :data:`TPU_ONLY` fields in ``values`` is at
    its JAX default: the port has no such layout."""
    for name, value in values.items():
        default, what = TPU_ONLY[name]
        if value != default:
            raise ValueError(f"{layer}: {name}={value!r} is not ported ({what}; ROADMAP, \"Do not port\": "
                             f"TPU-only); the port takes {name}={default!r}")


def register_edges(
    sub_graph, edge_attributes: Optional[list[str]], trainable_size: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """(edge_attr (E, A), edge_index (2, E), edge_dim = A + trainable_size)."""
    if sub_graph is None:
        raise ValueError("A valid sub_graph is required to register edges.")
    if edge_attributes is None:
        raise ValueError("the edge attributes to register must be named (got None)")
    edge_attr = sub_graph.attr_tensor(list(edge_attributes))
    edge_index = np.asarray(sub_graph.edge_index, dtype=np.int32)
    return edge_attr, edge_index, edge_attr.shape[1] + trainable_size


def register_edge_buffers(
    module: nn.Module, sub_graph, edge_attributes, trainable_size: int,
    num_src: int, num_dst: int, graph_impl: str, device, graph_impls: tuple = GRAPH_IMPLS,
) -> int:
    """Give ``module`` the edge set: buffers ``edge_attr``, ``rowptr``, ``src``
    and the transposed CSR ``perm_t``, ``colptr_t``, ``dst_t``, ``pos_t`` (graph-derived,
    not saved in the state dict) and the parameter ``trainable.trainable``.
    Returns the edge feature width."""
    if graph_impl not in graph_impls:
        raise ValueError(f"graph_impl must be one of {graph_impls}, got {graph_impl!r}")
    edge_attr, edge_index, edge_dim = register_edges(sub_graph, edge_attributes, trainable_size)
    rowptr, src = csr_from_edge_index(edge_index, num_src, num_dst)
    perm_t, colptr_t, dst_t, pos_t = csr_transpose(rowptr, src, num_src)
    buffers = dict(edge_attr=edge_attr, rowptr=rowptr, src=src, perm_t=perm_t, colptr_t=colptr_t, dst_t=dst_t,
                   pos_t=pos_t)
    for name, value in buffers.items():
        module.register_buffer(name, torch.as_tensor(value, device=device), persistent=False)
    module.trainable = TrainableTensor(edge_attr.shape[0], trainable_size, device=device)
    # the host copy each rank plans its part from, and the parts made from it (by mesh shape and rank)
    module._edge_set = (edge_index, num_src, num_dst)
    module._shards = {}
    return edge_dim


def edge_csr_t(module: nn.Module) -> CSRTranspose:
    """The transposed CSR that :func:`register_edge_buffers` gave ``module``."""
    return CSRTranspose(module.perm_t, module.colptr_t, module.dst_t, module.pos_t)


def halo_shard_of(module: nn.Module, mesh: Mesh) -> HaloShard:
    """This rank's :class:`HaloShard` of ``module``'s self-graph under
    ``mesh``, planned once (``partition_1hop``) and kept on the module."""
    edge_index, num_src, num_dst = module._edge_set
    key = ("halo", mesh.shape["model"], mesh.coords["model"], module.rowptr.device)
    if key not in module._shards:
        if num_src != num_dst:
            raise ValueError(f"halo exchange needs a self-graph, got {num_src} sources and {num_dst} destinations")
        part = partition_1hop(edge_index, num_dst, mesh.shape["model"])
        module._shards[key] = halo_shard(part, mesh.coords["model"], module.rowptr.device)
    return module._shards[key]


def mapper_shard_of(module: nn.Module, mesh: Mesh) -> MapperShard:
    """This rank's destination-sharded :class:`MapperShard` of ``module``'s
    bipartite edge set under ``mesh``, kept on the module."""
    edge_index, num_src, num_dst = module._edge_set
    key = ("mapper", mesh.shape["model"], mesh.coords["model"], module.rowptr.device)
    if key not in module._shards:
        module._shards[key] = mapper_shard(edge_index, num_src, num_dst, mesh.shape["model"], mesh.coords["model"],
                                           module.rowptr.device)
    return module._shards[key]


def _chunk_size(num_layers: int, num_chunks: int) -> int:
    if num_layers % num_chunks:
        raise ValueError(f"num_layers ({num_layers}) must split evenly into {num_chunks} chunks")
    return num_layers // num_chunks


class TransformerProcessor(nn.Module):
    """Sliding-window transformer over the hidden mesh positions:
    ``num_layers`` blocks in ``num_chunks`` chunks. With ``deterministic=False``
    the attention drops weights at ``dropout_p`` under the ``dropout_key``
    the forward is given (each layer folds in its index). ``dst_grid_size``
    is the mesh's node count, the sequence length a rank holding its rows of
    the sequence attends over."""

    def __init__(
        self,
        num_layers: int,
        *,
        window_size: Optional[int] = None,
        num_channels: int = 128,
        num_chunks: int = 2,
        activation: str = "GELU",
        cpu_offload: bool = False,
        num_heads: int = 16,
        mlp_hidden_ratio: int = 4,
        dropout_p: float = 0.1,
        attention_impl: str = "auto",
        remat_policy: str = "full",
        deterministic: bool = True,
        layer_scan: bool = False,
        dst_grid_size: int = 0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        check_tpu_only(type(self).__name__, layer_scan=layer_scan)
        chunk_size = _chunk_size(num_layers, num_chunks)
        self.proc = nn.ModuleList(
            TransformerProcessorChunk(
                num_channels, chunk_size, window_size, num_heads=num_heads,
                mlp_hidden_ratio=mlp_hidden_ratio, activation=activation, dropout_p=dropout_p,
                attention_impl=attention_impl, deterministic=deterministic, remat_policy=remat_policy,
                cpu_offload=cpu_offload, first_layer=c * chunk_size, seq_len=dst_grid_size, dtype=dtype,
                device=device,
            )
            for c in range(num_chunks)
        )

    def forward(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C)."""
        for chunk in self.proc:
            x = chunk(x, dropout_key)
        return x


class GNNProcessor(nn.Module):
    """Edge-MLP message-passing processor: ``num_layers`` blocks in
    ``num_chunks`` chunks over the hidden-to-hidden edge set; the first chunk
    embeds the edge attributes and the updated edges thread through the
    layers and chunks."""

    def __init__(
        self,
        num_layers: int,
        *,
        trainable_size: int = 8,
        num_channels: int = 128,
        num_chunks: int = 2,
        mlp_extra_layers: int = 0,
        activation: str = "SiLU",
        cpu_offload: bool = False,
        sub_graph=None,
        sub_graph_edge_attributes: Optional[list[str]] = ("edge_length", "edge_dirs"),
        src_grid_size: int = 0,
        dst_grid_size: int = 0,
        graph_impl: str = "dense",
        remat_policy: str = "full",
        layer_scan: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        check_tpu_only(type(self).__name__, layer_scan=layer_scan)
        chunk_size = _chunk_size(num_layers, num_chunks)
        self.dtype = dtype
        edge_dim = register_edge_buffers(
            self, sub_graph, sub_graph_edge_attributes, trainable_size,
            src_grid_size, dst_grid_size, graph_impl, device, GNN_GRAPH_IMPLS,
        )
        self.proc = nn.ModuleList(
            GNNProcessorChunk(
                num_channels, chunk_size, mlp_extra_layers=mlp_extra_layers, activation=activation,
                edge_dim=edge_dim if c == 0 else None, remat_policy=remat_policy, cpu_offload=cpu_offload,
                dtype=dtype, device=device,
            )
            for c in range(num_chunks)
        )

    def forward(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C) (a rank's rows under a model-sharded
        mesh); no layer drops, so ``dropout_key`` is unused."""
        edge_attr = self.trainable(self.edge_attr.to(self.dtype))
        rowptr, src, csr_t, halo = self.rowptr, self.src, edge_csr_t(self), None
        mesh = model_sharded()
        if mesh is not None:
            shard = halo_shard_of(self, mesh)
            edge_attr = edge_attr[shard.edge_lo:shard.edge_hi]
            rowptr, src, csr_t, halo = shard.rowptr, shard.src, shard.csr_t, (mesh, shard)
        for chunk in self.proc:
            x, edge_attr = chunk(x, edge_attr, rowptr, src, csr_t, halo)
        return x


class GraphTransformerProcessor(nn.Module):
    """Per-edge attention processor: ``num_layers`` blocks in ``num_chunks``
    chunks over the hidden-to-hidden edge set."""

    def __init__(
        self,
        num_layers: int,
        *,
        num_channels: int = 128,
        num_chunks: int = 2,
        num_heads: int = 16,
        mlp_hidden_ratio: int = 4,
        activation: str = "GELU",
        cpu_offload: bool = False,
        trainable_size: int = 8,
        sub_graph=None,
        sub_graph_edge_attributes: Optional[list[str]] = ("edge_length", "edge_dirs"),
        src_grid_size: int = 0,
        dst_grid_size: int = 0,
        graph_impl: str = "dense",
        kv_src_gather: str = "auto",
        remat_policy: str = "full",
        deterministic: bool = True,
        layer_scan: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        check_tpu_only(type(self).__name__, kv_src_gather=kv_src_gather, layer_scan=layer_scan)
        del deterministic  # the JAX blocks pick their inference edge chunking by it; nothing here drops
        chunk_size = _chunk_size(num_layers, num_chunks)
        self.dtype = dtype
        edge_dim = register_edge_buffers(
            self, sub_graph, sub_graph_edge_attributes, trainable_size,
            src_grid_size, dst_grid_size, graph_impl, device,
        )
        self.proc = nn.ModuleList(
            GraphTransformerProcessorChunk(
                num_channels, chunk_size, edge_dim, num_heads=num_heads,
                mlp_hidden_ratio=mlp_hidden_ratio, activation=activation, remat_policy=remat_policy,
                cpu_offload=cpu_offload, dtype=dtype, device=device,
            )
            for _ in range(num_chunks)
        )

    def forward(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C) (a rank's rows under a model-sharded
        mesh); no layer drops, so ``dropout_key`` is unused."""
        edge_attr = self.trainable(self.edge_attr.to(self.dtype))
        rowptr, src, csr_t, halo = self.rowptr, self.src, edge_csr_t(self), None
        mesh = model_sharded()
        if mesh is not None:
            shard = halo_shard_of(self, mesh)
            edge_attr = edge_attr[shard.edge_lo:shard.edge_hi]
            rowptr, src, csr_t, halo = shard.rowptr, shard.src, shard.csr_t, (mesh, shard)
        for chunk in self.proc:
            x = chunk(x, edge_attr, rowptr, src, csr_t, halo)
        return x


class HaloGNNProcessor(nn.Module):
    """Domain-decomposed GNN processor: a 1-hop halo exchange a layer.

    Counterpart of the JAX ``HaloGNNProcessor``, a config-selectable
    alternative to :class:`GNNProcessor` for sharded runs, which takes the
    plain path with no mesh active. The edge attributes are embedded once
    (``emb_edges``); each layer's conv runs the edge MLP Dense(3C -> C) ->
    act -> Dense -> act -> Dense -> LayerNorm, whose parameters are the
    processor's own ``conv_{i}_w1`` .. ``conv_{i}_ln_b`` in the flax layout
    ((in, out) kernels), through :class:`~anemoi_models_tpu_torch.ops.gnn_conv.GNNConv`;
    the updated edges thread into the next layer on the rank that owns them;
    then ``node_mlp_{i}`` on ``cat[x, aggregated]`` with a residual. Each
    layer is a remat unit under ``"full"`` (recomputed in the backward, as
    the JAX layer checkpoints it) or ``cpu_offload``."""

    def __init__(
        self,
        num_layers: int,
        *,
        trainable_size: int = 8,
        num_channels: int = 128,
        num_chunks: int = 2,
        mlp_extra_layers: int = 0,
        activation: str = "SiLU",
        cpu_offload: bool = False,
        sub_graph=None,
        sub_graph_edge_attributes: Optional[list[str]] = ("edge_length", "edge_dirs"),
        src_grid_size: int = 0,
        dst_grid_size: int = 0,
        num_shards: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        del num_chunks  # accepted for config parity; the recompute is per layer
        self.num_layers = num_layers
        self.num_shards = num_shards
        self.cpu_offload = cpu_offload
        self.activation = activation
        self.dtype = dtype
        c = num_channels
        edge_dim = register_edge_buffers(
            self, sub_graph, sub_graph_edge_attributes, trainable_size,
            src_grid_size, dst_grid_size, "dense", device,
        )
        mlp_kw = dict(n_extra_layers=mlp_extra_layers, activation=activation, dtype=dtype, device=device)
        self.emb_edges = MLP(edge_dim, c, c, **mlp_kw)
        for i in range(num_layers):
            for name, shape, fill in (("w1", (3 * c, c), None), ("b1", (c,), 0.0), ("w2", (c, c), None),
                                      ("b2", (c,), 0.0), ("w3", (c, c), None), ("b3", (c,), 0.0),
                                      ("ln_s", (c,), 1.0), ("ln_b", (c,), 0.0)):
                value = torch.empty(shape, device=device) if fill is None else torch.full(shape, fill, device=device)
                if fill is None:
                    nn.init.kaiming_normal_(value, nonlinearity="linear", mode="fan_out")
                self.register_parameter(f"conv_{i}_{name}", nn.Parameter(value))
            self.add_module(f"node_mlp_{i}", MLP(2 * c, c, c, **mlp_kw))

    def _conv_params(self, i: int) -> list[torch.Tensor]:
        """Layer i's edge MLP as GNNConv takes it: (out, in) weights."""
        p = {name: getattr(self, f"conv_{i}_{name}") for name in ("w1", "b1", "w2", "b2", "w3", "b3", "ln_s", "ln_b")}
        return [p["w1"].t(), p["b1"], p["w2"].t(), p["b2"], p["w3"].t(), p["b3"], p["ln_s"], p["ln_b"]]

    def forward(self, x: torch.Tensor, dropout_key: Optional[int] = None) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C) (a rank's rows under a model-sharded mesh)."""
        from anemoi_models_tpu_torch.ops.gnn_conv import GNNConv

        edges = self.emb_edges(self.trainable(self.edge_attr.to(self.dtype)))
        mesh = model_sharded()
        if mesh is not None:
            if self.num_shards not in (None, mesh.shape["model"]):
                raise ValueError(f"HaloGNNProcessor num_shards ({self.num_shards}) must equal the mesh's "
                                 f"model-axis size ({mesh.shape['model']})")
            shard = halo_shard_of(self, mesh)
            edges = edges[shard.edge_lo:shard.edge_hi]
        edges = edges.unsqueeze(0).expand(x.shape[0], -1, -1)

        def layer(x_, edges_, *params):
            if mesh is not None:
                return halo_graph_conv(mesh, shard, params, x_, edges_, self.activation)
            agg, msg = GNNConv.apply(x_.to(edges_.dtype).contiguous(), x_.to(edges_.dtype).contiguous(),
                                     edges_.contiguous(), self.rowptr, self.src, edge_csr_t(self), self.activation,
                                     *params)
            return agg.to(edges_.dtype), msg

        for i in range(self.num_layers):
            agg, edges = run_unit(layer, x, edges, *self._conv_params(i), remat_policy="full",
                                  cpu_offload=self.cpu_offload, owner=self)
            x = getattr(self, f"node_mlp_{i}")(torch.cat([x, agg], dim=-1)) + x
        return x
