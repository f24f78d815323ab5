"""A run end to end at a tiny size on the CPU: the result's line, the
check for JAX, the refusal without a card, and the faults that have to make
``correct`` false. The same cells on the card are the marked test at the
end."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench.harness import spec
from port_bench.tests.tiny import run_tiny

TRAIN = ["aifs-gt-c1024.train-o320", "aifs-transformer-c1024.train-o320"]
FORECAST = ["aifs-gt-c1024.forecast-o96", "aifs-transformer-c1024.forecast-o96"]
SMALL = {"checked_within": 3, "checked_requests": 2, "trace_requests": 3, "trace_steps": 2}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", TRAIN + FORECAST)
def test_last_line_has_the_contract_keys(name, traced):
    cell, line, compared = run_tiny(name, traced=traced, **SMALL)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else []) + ["compared"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["compared"]) == set(cell.limits) and len(compared) == len(cell.limits)
    if not traced:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    else:  # the CPU has no device trace: every per-layer reader finds nothing
        assert line["metrics"] == {} and {"busy_s", "window_s"} <= set(line["device"])
    json.dumps(line)


def test_a_run_loads_nothing_of_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from port_bench.tests.tiny import run_tiny\n"
            "from port_bench.harness.common import forbidden_modules\n"
            "run_tiny('aifs-gt-c1024.forecast-o96', checked_within=3, checked_requests=2)\n"
            "print('FOUND', forbidden_modules())") % spec.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from port_bench.harness import common

    monkeypatch.setitem(sys.modules, "anemoi_models_tpu_torch_fake", sys)
    assert "anemoi_models_tpu_torch_fake" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in common.forbidden_modules()


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload", TRAIN[0],
                          "--seed", "3000000000", "--seconds", "1"], capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def _frozen_step(monkeypatch):
    from anemoi_models_tpu_torch.training import optim

    monkeypatch.setattr(optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from anemoi_models_tpu_torch.training import step

    real = step.weighted_mse

    def half(pred, target, *args, **kwargs):
        rows = pred.shape[-2] // 2
        return real(pred[..., :rows, :], target[..., :rows, :], *args, **kwargs)

    monkeypatch.setattr(step, "weighted_mse", half)


def _altered_answer(monkeypatch):
    from anemoi_models_tpu_torch.interface import AnemoiModelInterface

    real = AnemoiModelInterface.predict_rollout

    def altered(self, batch, n_steps, forcings=None):
        out = real(self, batch, n_steps, forcings).clone()
        out[1, ..., 0] += self.statistics["stdev"][0]  # one variable of one lead, off by a standard deviation
        return out

    monkeypatch.setattr(AnemoiModelInterface, "predict_rollout", altered)


@pytest.mark.parametrize("name,fault", [(TRAIN[0], _frozen_step), (TRAIN[1], _frozen_step),
                                        (TRAIN[0], _half_batch), (TRAIN[1], _half_batch),
                                        (FORECAST[0], _altered_answer), (FORECAST[1], _altered_answer)])
def test_a_fault_underneath_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    _cell, line, compared = run_tiny(name, **SMALL)
    assert line["correct"] is False and any(text.endswith("FAILED") for text in compared), compared


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + FORECAST)
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload", name,
                          "--seed", "4000000001", "--seconds", "3"], capture_output=True, text=True, timeout=1200,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
