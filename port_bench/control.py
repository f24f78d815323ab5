"""Readings that set the comparison limits: the control and the faults.

    python3 port_bench/control.py --workload aifs-gt-c1024.train-o320 --seeds 5 6 7

For each seed it reads, at the cell's own sizes and with the cell's own
inputs and weights, the numbers a run compares, with the float32 reference
as the truth and in the program's place:

- ``control``: the reference computed one precision below the
  configuration's bfloat16 (every product's operands rounded to float8);
- ``half_batch`` (train cells): the reference with the loss taken over half
  of the grid's rows, the mean over the rest;
- ``frozen`` (train cells): a step that returns its state unchanged, which
  reads 1 on the change by construction and needs no run.

Each reading is judged by the cell's own comparison (``harness/cells.py``)
against its committed limits, as a run judges the program. It prints one
JSON line a seed, with each reading's numbers and ``correct``, and writes
them to ``--out``; it exits with 0 only when every reading of every seed
comes out not correct. The runs of the benchmark never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def half_batch_mse(pred, target):
    rows = pred.shape[-2] // 2
    return ((pred[..., :rows, :] - target[..., :rows, :]) ** 2).mean()


def read_train(cell, seed: int, device, graph, variables) -> dict:
    from port_bench.harness import cells, data, program
    from port_bench.harness.common import Compared
    from port_bench.reference import train as ref_train
    from port_bench.reference.model import Reference

    cfg, tr = cell.config, cell.traffic
    shapes = program.parameter_shapes(program.build_interface(cfg, graph, variables, "meta").model)
    sizes = cells.graph_sizes(graph, cfg)
    arrays = graph.to_arrays()
    samples = data.train_samples(tr["pool"], sizes["data"], len(variables.inputs), len(variables.outputs), seed,
                                 device, cfg["multistep_input"])[:tr["checked_steps"]]
    readings = {}
    for label, fp8, loss in (("reference", False, None), ("control", True, None),
                             ("half_batch", False, half_batch_mse)):
        t0 = time.perf_counter()
        ref = Reference(cfg, arrays, variables, device, fp8=fp8)
        weights = data.make_weights(shapes, seed, device)
        readings[label] = ref_train.train_steps(ref, weights, samples, cfg["optimizer"], cells.published_leaves,
                                                loss_fn=loss)
        del ref, weights
        print(f"control: {label} in {time.perf_counter() - t0:.1f} s, losses {readings[label]['losses']}",
              file=sys.stderr, flush=True)
    truth = readings.pop("reference")
    out = {label: cells.compare_train(r, truth, cell.limits) for label, r in readings.items()}
    out["frozen"] = [Compared("change_gap", 1.0, cell.limits["change_gap"])]  # the change's gap of a leaf left unmoved
    return out


def read_forecast(cell, seed: int, device, graph, variables) -> dict:
    import numpy as np
    import torch

    from port_bench.harness import cells, data, program
    from port_bench.reference import train as ref_train
    from port_bench.reference.model import Reference

    cfg, tr = cell.config, cell.traffic
    shapes = program.parameter_shapes(program.build_interface(cfg, graph, variables, "meta").model)
    sizes = cells.graph_sizes(graph, cfg)
    arrays = graph.to_arrays()
    reqs = data.forecast_requests(tr["pool"], sizes["data"], variables, tr["leads"], seed, device,
                                  cfg["multistep_input"])
    chosen = np.random.default_rng(seed).choice(tr["checked_within"], size=tr["checked_requests"], replace=False)
    weights = data.make_weights(shapes, seed, device)
    std = variables.output_stats(device)[1]
    truth, low = Reference(cfg, arrays, variables, device), Reference(cfg, arrays, variables, device, fp8=True)
    worst = 0.0
    for i in sorted(int(i) for i in chosen):
        x, f = reqs[i % tr["pool"]]
        want = ref_train.forecast(truth, weights, x, f, tr["leads"], variables, device)
        got = ref_train.forecast(low, weights, x, f, tr["leads"], variables, device)
        worst = max(worst, float(cells.lead_errors(got, want, std).max()))
        del want, got
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return {"control": cells.compare_forecast(worst, cell.limits)}


def judged(readings: dict) -> dict:
    """Each reading's compared numbers and whether the run would read
    ``correct``."""
    return {label: {**{c.name: c.value for c in compared}, "correct": all(c.ok for c in compared)}
            for label, compared in readings.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    import torch

    from port_bench.harness import common, data, program, spec
    from port_bench.reference.model import strict_fp32

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        common.log("the control reads at the cell's own size: it needs a card")
        return 3
    device = torch.device("cuda", 0)
    strict_fp32()
    variables = data.Variables(cell.config)
    graph = program.graph_for(cell.traffic, common.log)
    read = read_train if cell.kind == "train" else read_forecast
    passed = []
    for seed in args.seeds:
        readings = judged(read(cell, seed, device, graph, variables))
        passed += [f"{label} on seed {seed}" for label, r in readings.items() if r["correct"]]
        line = {"workload": cell.name, "seed": seed, **readings}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    if passed:
        common.log(f"reads correct, so the limits do not catch it: {passed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
