"""The system under test: the PyTorch port, built for a cell.

Everything of the port the benchmark touches is here: its graph builder
(with the graph kept in a cache inside the checkout), its config builder,
the interface, the train step and the optimizer. The port is imported
inside the functions, after the run has checked for a card.
"""

from __future__ import annotations

import hashlib
import os
import time

import torch

from port_bench.harness.data import Variables
from port_bench.harness.spec import CACHE_DIR


def _graphs_digest() -> str:
    import anemoi_models_tpu_torch.graphs as graphs

    digest = hashlib.sha256()
    folder = os.path.dirname(graphs.__file__)
    for name in sorted(os.listdir(folder)):
        if name.endswith(".py"):
            with open(os.path.join(folder, name), "rb") as fh:
                digest.update(name.encode() + fh.read())
    return digest.hexdigest()[:16]


def graph_for(traffic: dict, log):
    """The cell's graph from the port's builder, saved once in the cache
    (``HeteroGraph.save``) under its parameters and a digest of the port's
    ``graphs/`` sources, loaded from there by later runs."""
    from anemoi_models_tpu_torch.graphs import HeteroGraph, build_enc_proc_dec_graph

    key = f"{traffic['grid']}{traffic['grid_lat']}_r{traffic['mesh_refinements']}_{_graphs_digest()}"
    path = os.path.join(CACHE_DIR, "graphs", f"{key}.npz")
    t0 = time.perf_counter()
    if os.path.exists(path):
        graph = HeteroGraph.load(path)
        log(f"graph: loaded {path} in {time.perf_counter() - t0:.2f} s")
    else:
        graph = build_enc_proc_dec_graph(grid_lat=traffic["grid_lat"], grid=traffic["grid"],
                                         mesh_refinements=traffic["mesh_refinements"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        graph.save(path)
        log(f"graph: built and saved {path} in {time.perf_counter() - t0:.2f} s")
    return graph


def port_config(config: dict):
    """The port's config for the configuration's file."""
    from anemoi_models_tpu_torch import configs

    v = config["variables"]
    return configs.enc_proc_dec(
        forcing=v["forcing"], diagnostic=v["diagnostic"], flavor=config["flavor"],
        num_channels=config["num_channels"], num_layers=config["num_layers"], num_chunks=config["num_chunks"],
        num_heads=config["num_heads"], mlp_hidden_ratio=config["mlp_hidden_ratio"],
        multistep_input=config["multistep_input"], trainable_hidden=config["trainable_hidden"],
        trainable_edges=config["trainable_edges"], window_size=config["window_size"] or 512,
        remat_policy=config["remat_policy"], compute_dtype=config["compute_dtype"],
    )


def build_interface(config: dict, graph, variables: Variables, device):
    """``AnemoiModelInterface`` for the configuration on ``device``."""
    from anemoi_models_tpu_torch.data_indices import IndexCollection
    from anemoi_models_tpu_torch.interface import AnemoiModelInterface

    cfg = port_config(config)
    indices = IndexCollection(cfg, variables.name_to_index)
    return AnemoiModelInterface(config=cfg, graph_data=graph, statistics=variables.statistics(),
                                data_indices=indices, device=device)


def parameter_shapes(model: torch.nn.Module) -> dict[str, tuple]:
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    params = dict(model.named_parameters())
    missing = set(params) ^ set(weights)
    if missing:
        raise KeyError(f"weights and parameters differ: {sorted(missing)[:5]}")
    names = sorted(params)
    torch._foreach_copy_([params[n] for n in names], [weights[n] for n in names])


def make_optimizer(model: torch.nn.Module, config: dict):
    from anemoi_models_tpu_torch.training import AdamW

    o = config["optimizer"]
    return AdamW(model.parameters(), lambda _count: o["lr"], b1=o["b1"], b2=o["b2"],
                 weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])


def make_train_step(model: torch.nn.Module, optimizer):
    from anemoi_models_tpu_torch.training import make_train_step as port_make_train_step

    return port_make_train_step(model, optimizer)

