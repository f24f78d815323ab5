"""What a run measures, found by name from ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``: the model's sizes and
variables, with its source) and a traffic mix (``traffic/<name>.json``: the
grid, the batch, the work of a window). Its comparison limits are in
``limits/<cell>.json`` and each per-layer metric is read by
``metrics/<metric>.py``. A later cell or metric is added as files and entries
only: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(ROOT, "build", "port_bench")  # inside the checkout, listed in .gitignore


def cache_dirs() -> dict[str, str]:
    """The fixed directories inside the checkout that the program's caches
    go to, as environment variables (set before torch loads)."""
    return {"TRITON_CACHE_DIR": os.path.join(CACHE_DIR, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(CACHE_DIR, "torch_extensions"),
            "CUDA_CACHE_PATH": os.path.join(CACHE_DIR, "cuda_cache")}


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it reads."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # the BENCHMARK.json entries this cell reports
    per_layer: list = field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the checkout's root)."""
    bench = _load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"], chips=int(w["chips"]), config=config,
        traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
