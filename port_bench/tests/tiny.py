"""Tiny cells for the CPU tests: the benchmark's own cells with their
widths, depth and grid shrunk and the compute in float32 (where the port
and the reference agree to rounding, so a sound run reads far inside the
cells' limits and a fault far outside), every other setting as committed."""

from __future__ import annotations

import copy

import torch

from port_bench.harness import spec

TINY_CONFIG = {"num_channels": 32, "num_layers": 2, "num_heads": 4, "compute_dtype": "float32"}
TINY_TRAFFIC = {"grid_lat": 6, "mesh_refinements": 2}


def tiny_cell(name: str, **traffic) -> spec.Cell:
    cell = copy.deepcopy(spec.load_cell(name))
    cell.config.update(TINY_CONFIG)
    if cell.config["window_size"]:
        cell.config["window_size"] = 8
    cell.traffic.update(TINY_TRAFFIC, **traffic)
    return cell


def run_tiny(name: str, seed: int = 3, traced: bool = False, seconds: float = 0.5, **traffic):
    """(cell, the result line, the compared lines) of a tiny CPU run."""
    from port_bench.run import result, run_cell

    torch.manual_seed(0)
    cell = tiny_cell(name, **traffic)
    outcome = run_cell(cell, seed, seconds, traced, torch.device("cpu"), lambda: 0.5)
    line, compared = result(cell, outcome, traced, torch.device("cpu"), 1)
    return cell, line, compared
