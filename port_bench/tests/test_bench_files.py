"""The benchmark's files: every name in BENCHMARK.json resolves, and the
file keeps to the contract's form."""

from __future__ import annotations

import json
import os
import re

import pytest

from port_bench.harness import spec

with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as _fh:
    BENCH = json.load(_fh)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_name_of_a_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1 and c.kind in ("train", "forecast")
    assert c.config_name + "." + c.traffic_name == cell
    limits = {"train": {"loss_gap", "grad_gap", "change_gap"}, "forecast": {"forecast_err"}}[c.kind]
    assert set(c.limits) == limits and all(v > 0 for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {cell} does not report"
        assert callable(spec.metric_reader(m["name"]))


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/configs/") and os.path.exists(os.path.join(spec.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    assert {m["name"] for m in BENCH["end_to_end"]} == {"train_step_ms", "forecast_lead_ms", "forecast_lead_ms_p95",
                                                        "peak_mem_gib", "setup_s"}


def test_every_metric_file_is_named_in_benchmark_json():
    files = {f[:-3] for f in os.listdir(os.path.join(spec.BENCH_DIR, "metrics")) if f.endswith(".py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("name", ["aifs-gt-c1024", "aifs-transformer-c1024"])
def test_configurations_keep_the_published_widths(name):
    with open(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    assert (cfg["num_channels"], cfg["num_layers"], cfg["num_chunks"], cfg["num_heads"], cfg["mlp_hidden_ratio"]) == \
        (1024, 16, 2, 16, 4)
    assert cfg["compute_dtype"] == "bfloat16" and cfg["reduced"] == [] and cfg["source"].startswith("https://")
    v = cfg["variables"]
    assert len(v["order"]) == 101 and len(v["forcing"]) == 13 and len(v["diagnostic"]) == 2
    assert cfg["window_size"] == (512 if cfg["flavor"] == "transformer" else None)
