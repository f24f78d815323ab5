"""The control and the faults judged by the cells' own comparison at a tiny
size on the CPU, the reference's edge attributes against the graph
builder's, and the readers of a traced window on a made-up trace."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import control
from port_bench.harness import data, program, readers, trace, work
from port_bench.reference.model import edge_attributes
from port_bench.tests.test_bench_work import SIZES, VARIABLES, _config
from port_bench.tests.tiny import tiny_cell

CELLS = ["aifs-gt-c1024.train-o320", "aifs-transformer-c1024.train-o320", "aifs-gt-c1024.forecast-o96",
         "aifs-transformer-c1024.forecast-o96"]


@pytest.mark.parametrize("name", CELLS)
def test_every_control_reading_comes_out_not_correct(name):
    cell = tiny_cell(name, checked_within=3, checked_requests=2)
    variables = data.Variables(cell.config)
    graph = program.graph_for(cell.traffic, lambda _line: None)
    read = control.read_train if cell.kind == "train" else control.read_forecast
    readings = control.judged(read(cell, 3, torch.device("cpu"), graph, variables))
    assert set(readings) == ({"control", "half_batch", "frozen"} if cell.kind == "train" else {"control"})
    assert all(r["correct"] is False for r in readings.values()), readings
    assert all(set(r) - {"correct"} <= set(cell.limits) for r in readings.values())


def test_reference_edge_attributes_match_the_graph_file():
    arrays = program.graph_for(tiny_cell(CELLS[0]).traffic, lambda _line: None).to_arrays()
    for src, dst in (("data", "hidden"), ("hidden", "hidden"), ("hidden", "data")):
        base = f"edge::{src}::to::{dst}"
        got = edge_attributes(arrays[f"node::{src}::coords"], arrays[f"node::{dst}::coords"],
                              np.asarray(arrays[f"{base}::edge_index"], np.int64))
        for name in ("edge_length", "edge_dirs"):
            np.testing.assert_allclose(got[name], arrays[f"{base}::attr::{name}"], rtol=0, atol=1e-6)


def _run(kind: str, plain_s: float, window_s: float) -> SimpleNamespace:
    """Two units: 0.3 s of device work a unit in kernels of 0.1 s, 0.2 s of
    it in the edge kernels."""
    kernels = [(name, start * 1e6, 0.1e6, i, "kernel") for i, (name, start) in enumerate(
        [("kv_proj_tag", 0.0), ("edge_attn_csr_kernel", 0.1), ("gemm", 0.2),
         ("kv_proj_tag", 1.0), ("edge_attn_csr_kernel", 1.1), ("gemm", 1.2)])]
    shapes = work.Shapes.of(_config("graphtransformer"), SIZES, VARIABLES, 1)
    return SimpleNamespace(kind=kind, trace=trace.Trace(kernels=kernels), units=2, window_s=window_s,
                           plain_s=plain_s, shapes=shapes)


def test_mfu_and_idle_take_the_untraced_time():
    run = _run("forecast", plain_s=0.8, window_s=2.0)
    assert readers.idle_pct(run, "forecast") == pytest.approx(100 * (1 - 0.6 / 0.8))
    flops = work.model_flops(run.shapes, False)
    assert readers.mfu_pct(run, "forecast") == pytest.approx(100 * flops / (0.4 * work.PEAK_BF16_FLOPS))
    assert readers.launches(run, "forecast") == 3
    assert readers.idle_pct(run, "train") is None and readers.mfu_pct(run, "train") is None


def test_roofline_takes_the_device_time_of_its_kernels():
    run = _run("forecast", plain_s=0.8, window_s=2.0)
    least = work.least_time_s(work.edge_calls(run.shapes, False))
    assert readers.edge_roofline(run, "forecast") == pytest.approx(100 * least / 0.2)
    assert readers.flash_roofline(run, "forecast") is None
