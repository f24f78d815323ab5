"""Benchmark of the PyTorch and CUDA port (``anemoi_models_tpu_torch``).

Run one cell of ``BENCHMARK.json`` from the root of a checkout::

    python3 port_bench/run.py --workload aifs-gt-c1024.train-o320 --seed 7 --seconds 30 --trace 0

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` runs a
short window under ``torch.profiler`` and reports the per-layer metrics,
the device's busy seconds and a breakdown. Either way the run then checks
what the window produced against the plain reference (``reference/``) and
prints, as the last lines of standard error, each compared number beside
its limit, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` when traced) and ``compared``.

It exits with another code than 0 and prints no result when there is no
card (or fewer than the cell asks for), when the port cannot be imported,
when a roofline or mfu share reads above 105%, and when JAX or the JAX
package has been loaded by the time the result is due.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from port_bench.harness import spec  # noqa: E402  (no torch yet: the caches' places go first)

for _name, _path in spec.cache_dirs().items():
    os.environ[_name] = _path
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402

EXIT_NO_CARD, EXIT_FORBIDDEN, EXIT_OVER_PEAK = 3, 4, 5


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Benchmark of the PyTorch and CUDA port: one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(cell, outcome, traced: bool, device, chips: int) -> tuple[dict, list[str]]:
    """The result's line and the per-layer metrics it carries (readers that
    find nothing to read are left out); raises where a share reads above its
    peak."""
    from port_bench.harness import common

    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(outcome.trace)
            if value is None:
                continue
            if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]) and \
                    value > common.ROOFLINE_LIMIT_PCT:
                raise OverflowError(f"{m['name']} reads {value}% > {common.ROOFLINE_LIMIT_PCT}%: the work is "
                                    "counted too high or the time leaves out part of it")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    info = common.device_info(device, chips, outcome.peak_bytes)
    line = {"correct": outcome.answers_complete and outcome.failed == 0 and all(c.ok for c in outcome.compared),
            "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics, "device": info}
    if traced:
        t = outcome.trace
        info["busy_s"] = t.trace.busy_us() / 1e6
        info["window_s"] = t.window_s
        line["breakdown"] = {"device_ops": [list(kv) for kv in t.trace.by_kind()[:10]],
                             "idle_gaps": [list(kv) for kv in t.trace.idle_gaps()[:10]]}
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.compared}
    return line, [f"{c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}" for c in outcome.compared]


def run_cell(cell, seed: int, seconds: float, traced: bool, device, since_start=None):
    """Run ``cell`` on ``device`` (a card, or the CPU in the harness's own
    tests): the outcome of its kind's driver."""
    from port_bench.harness import cells, common

    since_start = since_start or (lambda: common.process_age_s())
    drive = {"train": cells.run_train, "forecast": cells.run_forecast}[cell.kind]
    return drive(cell, seed, seconds, traced, device, since_start)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    import torch

    from port_bench.harness import common

    age0 = common.process_age_s() - (time.perf_counter() - _T0)  # the process's age when this file began
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        common.log(f"no result: the cell needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
                   f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return EXIT_NO_CARD
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    common.log(f"{cell.name}: seed {args.seed}, {args.seconds} s, trace {args.trace}, on "
               f"{torch.cuda.get_device_name(device)} ({common.card_reading()}), torch {torch.__version__}")
    outcome = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                       lambda: age0 + time.perf_counter() - _T0)
    try:
        line, compared = result(cell, outcome, bool(args.trace), device, cell.chips)
    except OverflowError as exc:
        common.log(f"no result: {exc}")
        return EXIT_OVER_PEAK
    found = common.forbidden_modules()
    if found:
        common.log(f"no result: modules of JAX or the JAX package are loaded: {found}")
        return EXIT_FORBIDDEN
    for text in compared:
        common.log(text)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
