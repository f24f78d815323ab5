"""Pieces every cell shares: the log, the card's readings, timing
statistics, the check for JAX, the per-layer metrics' results."""

from __future__ import annotations

import gc
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "anemoi_models_tpu")
ROOFLINE_LIMIT_PCT = 105.0


def log(line: str) -> None:
    print(f"port_bench: {line}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (from /proc; 0 where there is none)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def card_reading() -> Optional[str]:
    """``nvidia-smi``'s name, SM and memory clocks, power draw and limit,
    temperature; None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def device_info(device: torch.device, chips: int, peak_bytes: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": int(peak_bytes)}


def spread_line(label: str, values_ms: list[float]) -> str:
    """Median, p95, max and the count above 1.5x the median of a list of times."""
    if not values_ms:
        return f"{label}: none"
    med = statistics.median(values_ms)
    p95 = percentile(values_ms, 95.0)
    slow = sum(v > 1.5 * med for v in values_ms)
    return (f"{label}: n {len(values_ms)}, median {med:.4f} ms, p95 {p95:.4f} ms, max {max(values_ms):.4f} ms, "
            f"above 1.5x median {slow}")


def percentile(values: list[float], pct: float) -> float:
    """The ``pct`` percentile by linear interpolation between order statistics."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * pct / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class GcCount:
    """Garbage collections that start while it is open."""

    def __init__(self) -> None:
        self.count = 0

    def _cb(self, phase, _info) -> None:
        if phase == "start":
            self.count += 1

    def __enter__(self) -> "GcCount":
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)


def settle() -> None:
    """Before the window: collect, then move everything that exists to the
    permanent generation, so the window's collections scan only its own
    objects."""
    gc.collect()
    gc.freeze()


@dataclass
class Compared:
    """A number compared with the reference, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Outcome:
    """What a cell's run hands the printer."""

    attempted: int
    failed: int
    end_to_end: dict = field(default_factory=dict)  # name -> value
    compared: list = field(default_factory=list)
    peak_bytes: int = 0
    trace: object = None  # the traced window (cells.TracedRun) of a --trace 1 run
    answers_complete: bool = True  # every answer drawn for the comparison arrived


def now() -> float:
    return time.perf_counter()
