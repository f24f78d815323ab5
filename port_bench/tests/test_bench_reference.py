"""The plain reference against the port at a tiny size on the CPU, in
float32 (where the two should agree to rounding), and the control (the
reference in float8) against it."""

from __future__ import annotations

import pytest
import torch

from port_bench.harness import cells, data, program
from port_bench.reference import train as ref_train
from port_bench.reference.model import Reference
from port_bench.tests.tiny import tiny_cell

FLAVORS = {"graphtransformer": "aifs-gt-c1024.train-o320", "transformer": "aifs-transformer-c1024.train-o320"}


def _built(flavor: str, dtype: str = "float32", seed: int = 5):
    cell = tiny_cell(FLAVORS[flavor])
    cell.config["compute_dtype"] = dtype
    variables = data.Variables(cell.config)
    graph = program.graph_for(cell.traffic, lambda _line: None)
    iface = program.build_interface(cell.config, graph, variables, "cpu")
    shapes = program.parameter_shapes(iface.model)
    program.load_weights(iface.model, data.make_weights(shapes, seed, "cpu"))
    return cell, variables, graph, iface, shapes


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_reference_forward_matches_the_port(flavor):
    cell, variables, graph, iface, shapes = _built(flavor)
    sizes = cells.graph_sizes(graph, cell.config)
    (x, _), = data.train_samples(1, sizes["data"], len(variables.inputs), len(variables.outputs), 5, "cpu")
    with torch.no_grad():
        got = iface.model(x)
        want = Reference(cell.config, graph.to_arrays(), variables, "cpu").forward(data.make_weights(shapes, 5, "cpu"), x)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < 2e-5


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_reference_train_steps_follow_the_port(flavor):
    cell, variables, graph, iface, shapes = _built(flavor)
    model = iface.model
    sizes = cells.graph_sizes(graph, cell.config)
    samples = data.train_samples(3, sizes["data"], len(variables.inputs), len(variables.outputs), 5, "cpu")
    opt = program.make_optimizer(model, cell.config)
    step = program.make_train_step(model, opt)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, grads = [], None
    for x, y in samples:
        losses.append(float(step(x, y)))
        if grads is None:  # the first gradient, from the moment after one step
            grads = {n: float(torch.linalg.vector_norm(t)) / (1 - cell.config["optimizer"]["b1"]) for n, t in
                     cells.published_leaves([(n, opt.state[p]["mu"]) for n, p in model.named_parameters()])}
    change = {n: float(torch.linalg.vector_norm(t)) for n, t in
              cells.published_leaves([(n, p.detach() - start[n]) for n, p in model.named_parameters()])}
    ref = Reference(cell.config, graph.to_arrays(), variables, "cpu")
    r = ref_train.train_steps(ref, data.make_weights(shapes, 5, "cpu"), samples, cell.config["optimizer"],
                              cells.published_leaves)
    gaps = {c.name: c.value for c in cells.compare_train({"losses": losses, "grad_norms": grads,
                                                          "change_norms": change}, r, cell.limits)}
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-3, gaps


def test_reference_forecast_matches_predict_rollout():
    cell, variables, graph, iface, shapes = _built("graphtransformer")
    (x, f), = data.forecast_requests(1, graph["data"].num_nodes, variables, 3, 5, "cpu")
    got = iface.predict_rollout(x, 3, f)
    ref = Reference(cell.config, graph.to_arrays(), variables, "cpu")
    want = ref_train.forecast(ref, data.make_weights(shapes, 5, "cpu"), x, f, 3, variables, "cpu")
    std = variables.output_stats("cpu")[1]
    assert float((((got - want) / std) ** 2).mean().sqrt()) < 1e-5


def test_fp8_control_departs_from_the_reference_more_than_bf16_does():
    cell, variables, graph, _iface, shapes = _built("graphtransformer")
    (x, _), = data.train_samples(1, graph["data"].num_nodes, len(variables.inputs), len(variables.outputs), 5, "cpu")
    w = data.make_weights(shapes, 5, "cpu")
    bf16 = _built("graphtransformer", "bfloat16")[3].model
    with torch.no_grad():
        truth = Reference(cell.config, graph.to_arrays(), variables, "cpu").forward(w, x)
        low = Reference(cell.config, graph.to_arrays(), variables, "cpu", fp8=True).forward(w, x)
        half = bf16(x)
    err = lambda a: float(((a - truth) ** 2).mean().sqrt())  # noqa: E731
    assert err(low) > 3 * err(half) > 0
