"""Ready-made model configurations for the flagship architectures.

The port's own copy of ``anemoi_models_tpu/configs.py`` on the port's
:class:`~anemoi_models_tpu_torch.utils.DotDict`: the same builders, giving
the same configs (drop-in for the ``config`` argument of
:class:`~anemoi_models_tpu_torch.interface.AnemoiModelInterface`; the
``_target_`` paths under ``anemoi.models.*`` resolve to this package's
modules, and to the JAX package's there).

All presets take the variable routing as arguments and default to the
AIFS-class GraphTransformer recipe (reference
``models/encoder_processor_decoder.py`` + GraphTransformer mappers and
processor, C=1024, 16 layers at production scale — scaled down by default
so the presets run anywhere).

:func:`flagship` and :func:`flagship_hierarchical` are the models of the
JAX package's benchmark (``__graft_entry__._build`` and
``_build_hierarchical``), which the port's ``bench`` command and
``chip_smoke.py`` both build.
"""

from __future__ import annotations

from typing import Optional, Sequence

from anemoi_models_tpu_torch.utils import DotDict

__all__ = ["enc_proc_dec", "flagship", "flagship_hierarchical", "hierarchical", "FLAVORS"]

FLAVORS = ("graphtransformer", "gnn", "transformer")

_MAPPER = {
    "graphtransformer": "anemoi.models.layers.mapper.GraphTransformer{}Mapper",
    "gnn": "anemoi.models.layers.mapper.GNN{}Mapper",
}
_PROCESSOR = {
    "graphtransformer": "anemoi.models.layers.processor.GraphTransformerProcessor",
    "gnn": "anemoi.models.layers.processor.GNNProcessor",
    "transformer": "anemoi.models.layers.processor.TransformerProcessor",
}


def enc_proc_dec(
    *,
    forcing: Sequence[str],
    diagnostic: Sequence[str],
    flavor: str = "graphtransformer",
    num_channels: int = 256,
    num_layers: int = 8,
    num_chunks: int = 2,
    num_heads: int = 16,
    mlp_hidden_ratio: int = 4,
    multistep_input: int = 2,
    trainable_hidden: int = 8,
    trainable_edges: int = 4,
    window_size: int = 512,
    dropout_p: float = 0.0,
    graph_impl: Optional[str] = None,
    remat_policy: str = "full",
    compute_dtype: str = "bfloat16",
    normalizer_default: str = "mean-std",
    bounding: Sequence[dict] = (),
) -> DotDict:
    """Config for the canonical encoder-processor-decoder model.

    ``flavor`` selects the processor family (mappers follow: GNN mappers for
    the GNN flavor, GraphTransformer mappers otherwise, as in AIFS).
    ``graph_impl`` None keeps each layer's measured default ("dense"
    tables; pass "pallas" for the fused kernel path).
    """
    if flavor not in FLAVORS:
        raise ValueError(f"flavor must be one of {FLAVORS}, got {flavor!r}")
    if isinstance(forcing, str) or isinstance(diagnostic, str):
        raise ValueError(
            "forcing/diagnostic take sequences of variable names, not a bare "
            "string (a string would split into characters)"
        )
    mapper_flavor = "gnn" if flavor == "gnn" else "graphtransformer"
    mapper_extra = (
        {"num_heads": num_heads, "mlp_hidden_ratio": mlp_hidden_ratio}
        if mapper_flavor == "graphtransformer"
        else {}
    )
    edge_attrs = ["edge_length", "edge_dirs"]
    proc: dict = {
        "_target_": _PROCESSOR[flavor],
        "num_layers": num_layers,
        "num_chunks": num_chunks,
        "remat_policy": remat_policy,
    }
    if flavor == "transformer":
        proc.update(
            num_heads=num_heads,
            mlp_hidden_ratio=mlp_hidden_ratio,
            window_size=window_size,
            dropout_p=dropout_p,
        )
    else:
        proc.update(
            trainable_size=trainable_edges,
            sub_graph_edge_attributes=edge_attrs,
        )
        if flavor == "graphtransformer":
            proc.update(num_heads=num_heads, mlp_hidden_ratio=mlp_hidden_ratio)
        if graph_impl:
            proc["graph_impl"] = graph_impl
    return DotDict(
        {
            "data": {
                "forcing": list(forcing),
                "diagnostic": list(diagnostic),
                "processors": {
                    "normalizer": {
                        "_target_": "anemoi.models.preprocessing.normalizer.InputNormalizer",
                        "config": {"default": normalizer_default},
                    },
                },
            },
            "graph": {"data": "data", "hidden": "hidden"},
            "training": {"multistep_input": multistep_input},
            "model": {
                "num_channels": num_channels,
                "compute_dtype": compute_dtype,
                "trainable_parameters": {"hidden": trainable_hidden},
                "bounding": list(bounding),
                "model": {
                    "_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"
                },
                "encoder": {
                    "_target_": _MAPPER[mapper_flavor].format("Forward"),
                    "trainable_size": trainable_edges,
                    "sub_graph_edge_attributes": edge_attrs,
                    **mapper_extra,
                },
                "processor": proc,
                "decoder": {
                    "_target_": _MAPPER[mapper_flavor].format("Backward"),
                    "trainable_size": trainable_edges,
                    "sub_graph_edge_attributes": edge_attrs,
                    **mapper_extra,
                },
            },
        }
    )


def hierarchical(
    *,
    forcing: Sequence[str],
    diagnostic: Sequence[str],
    hidden_names: Sequence[str],
    level_process_num_layers: int = 2,
    enable_level_processing: bool = True,
    **kwargs,
) -> DotDict:
    """Config for the hierarchical (mesh-pyramid) model over the node sets
    produced by :func:`anemoi_models_tpu_torch.graphs.build_hierarchical_graph`."""
    cfg = enc_proc_dec(forcing=forcing, diagnostic=diagnostic, **kwargs)
    cfg.graph.hidden = list(hidden_names)
    cfg.model.model._target_ = (
        "anemoi.models.models.hierarchical.AnemoiModelEncProcDecHierarchical"
    )
    cfg.model.enable_hierarchical_level_processing = enable_level_processing
    cfg.model.level_process_num_layers = level_process_num_layers
    return cfg


def flagship(num_channels: int, num_layers: int, num_chunks: int, dtype: str, remat_policy: str = "full",
             flavor: str = "graphtransformer", num_heads: int = 4, mlp_extra_layers: int = 0) -> DotDict:
    """The flagship config of the JAX package's entry point
    (``__graft_entry__._build``), written for the port, over the variables
    ``lsm`` (forcing), ``z_500``, ``t_850``, ``q_700``, ``t2m`` and ``tp``
    (diagnostic): 8 trainable node and 4 trainable edge features, mean-std
    normalisation; ``num_heads`` for the GraphTransformer's mappers and
    processor (the Transformer's processor has 4 heads and a window of
    512), ``mlp_extra_layers`` for the GNN's MLPs."""
    edges = {"trainable_size": 4, "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
    if flavor == "gnn":
        edges["mlp_extra_layers"] = mlp_extra_layers
    mapper = {**edges, "num_heads": num_heads} if flavor != "gnn" else edges
    prefix = "GNN" if flavor == "gnn" else "GraphTransformer"
    processor = {
        "graphtransformer": {"_target_": _PROCESSOR["graphtransformer"], "graph_impl": "pallas", **mapper},
        "gnn": {"_target_": _PROCESSOR["gnn"], **edges},
        "transformer": {"_target_": _PROCESSOR["transformer"], "num_heads": 4, "window_size": 512, "dropout_p": 0.0},
    }[flavor]
    return DotDict({
        "data": {
            "forcing": ["lsm"],
            "diagnostic": ["tp"],
            "processors": {
                "normalizer": {
                    "_target_": "anemoi.models.preprocessing.normalizer.InputNormalizer",
                    "config": {"default": "mean-std"},
                },
            },
        },
        "graph": {"data": "data", "hidden": "hidden"},
        "training": {"multistep_input": 2},
        "model": {
            "num_channels": num_channels,
            "compute_dtype": dtype,
            "trainable_parameters": {"hidden": 8},
            "model": {"_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"},
            "encoder": {"_target_": f"anemoi.models.layers.mapper.{prefix}ForwardMapper", **mapper},
            "processor": {"num_layers": num_layers, "num_chunks": num_chunks, "remat_policy": remat_policy,
                          **processor},
            "decoder": {"_target_": f"anemoi.models.layers.mapper.{prefix}BackwardMapper", **mapper},
        },
    })


def flagship_hierarchical(hidden_names: Sequence[str], channels: int = 256, heads: int = 4, dtype: str = "bfloat16",
                          num_layers: int = 8, remat_policy: str = "full") -> DotDict:
    """The hierarchical model of the JAX package's benchmark
    (``__graft_entry__._build_hierarchical``) over :func:`flagship`'s
    variables: ``heads`` heads, level processors of 2 layers in one chunk,
    8 trainable node and 4 trainable edge features."""
    return hierarchical(
        forcing=["lsm"], diagnostic=["tp"], hidden_names=hidden_names, num_channels=channels, num_layers=num_layers,
        num_chunks=1, num_heads=heads, trainable_hidden=8, trainable_edges=4, level_process_num_layers=2,
        remat_policy=remat_policy, compute_dtype=dtype,
    )
