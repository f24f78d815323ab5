"""The traced window: ranges the harness sets around the program's layers,
``torch.profiler`` over the window, and the trace read back.

The ranges are ``record_function`` ranges opened and closed by hooks: a
forward pre-hook and post-hook on each named module (``encoder``,
``processor``, ``decoder`` of the model) and the optimizer's step pre- and
post-hooks. The program is not touched. A device kernel belongs to a range
when the host call that launched it ran inside the range on the same thread
(the trace links the two by a correlation id).
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field

import torch

from port_bench.harness.kinds import kind_of

PREFIX = "port_bench."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Ranges:
    """Record-function ranges around modules' forwards and an optimizer's
    steps, while the object is open."""

    def __init__(self, modules: dict, optimizer=None) -> None:
        self.modules, self.optimizer = modules, optimizer
        self._handles, self._open = [], {}

    def _enter(self, name):
        def hook(*_args, **_kwargs):
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self._open.setdefault(name, []).append(rf)
        return hook

    def _exit(self, name):
        def hook(*_args, **_kwargs):
            stack = self._open.get(name)
            if stack:
                stack.pop().__exit__(None, None, None)
        return hook

    def __enter__(self) -> "Ranges":
        for name, module in self.modules.items():
            self._handles.append(module.register_forward_pre_hook(self._enter(name)))
            self._handles.append(module.register_forward_hook(self._exit(name)))
        if self.optimizer is not None:
            self._handles.append(self.optimizer.register_step_pre_hook(self._enter("optimizer")))
            self._handles.append(self.optimizer.register_step_post_hook(self._exit("optimizer")))
        return self

    def __exit__(self, *exc) -> None:
        for h in self._handles:
            h.remove()
        self._handles.clear()


@dataclass
class Trace:
    """The device's work in a traced window, read from the profiler."""

    kernels: list = field(default_factory=list)  # (name, start_us, dur_us, correlation, category), device activity
    ranges_of: dict = field(default_factory=dict)  # correlation -> set of range names
    launcher: dict = field(default_factory=dict)  # correlation -> the host op that launched it

    def device_ops(self) -> list:
        return [k for k in self.kernels if k[4] == "kernel"]

    def busy_us(self) -> float:
        """The union of device activity."""
        busy, end = 0.0, None
        for _, s, d, _, _ in sorted(self.kernels, key=lambda k: k[1]):
            t = s + d
            if end is None or s > end:
                busy += d
                end = t
            elif t > end:
                busy += t - end
                end = t
        return busy

    def in_range(self, name: str) -> list:
        """Device kernels launched inside range ``name``."""
        return [k for k in self.device_ops() if name in self.ranges_of.get(k[3], ())]

    def matching(self, patterns) -> list:
        return [k for k in self.device_ops() if any(p in k[0] for p in patterns)]

    def by_kind(self) -> list:
        out: dict[str, float] = {}
        for name, _, d, _, _ in self.kernels:
            kind = kind_of(name)
            out[kind] = out.get(kind, 0.0) + d / 1e6
        return sorted(out.items(), key=lambda kv: -kv[1])

    def idle_gaps(self) -> list:
        """Seconds of device idle by what the host was doing: each gap
        between device activity, named by the host op (in the harness's
        range) that launched the work ending it."""
        out: dict[str, float] = {}
        end = None
        for name, s, d, corr, _ in sorted(self.kernels, key=lambda k: k[1]):
            if end is not None and s > end:
                label = self.launcher.get(corr, "unattributed")
                out[label] = out.get(label, 0.0) + (s - end) / 1e6
            end = s + d if end is None else max(end, s + d)
        return sorted(out.items(), key=lambda kv: -kv[1])


def _intervals(events: list) -> dict:
    """tid -> (sorted starts, [(start, end, name)])."""
    by_tid: dict = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]))
    return {tid: ([s for s, _, _ in sorted(iv)], sorted(iv)) for tid, iv in by_tid.items()}


def _containing(table: dict, tid, ts: float) -> list:
    """Names of the intervals on ``tid`` that contain ``ts``, outermost first
    (for a table of few intervals: the harness's ranges)."""
    if tid not in table:
        return []
    starts, iv = table[tid]
    return [name for s, e, name in iv[:bisect.bisect_right(starts, ts)] if s <= ts <= e]


def _innermost(table: dict, tid, ts: float, look_back: int = 256):
    """The name of the latest-starting interval on ``tid`` that contains
    ``ts``, or None."""
    if tid not in table:
        return None
    starts, iv = table[tid]
    i = bisect.bisect_right(starts, ts)
    for s, e, name in reversed(iv[max(0, i - look_back):i]):
        if s <= ts <= e:
            return name
    return None


def read_chrome_trace(path: str) -> Trace:
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    annotations = _intervals([e for e in events if e.get("cat") == "user_annotation"
                              and e["name"].startswith(PREFIX)])
    ops = _intervals([e for e in events if e.get("cat") == "cpu_op"])
    trace = Trace()
    for e in runtime:
        corr = e.get("args", {}).get("correlation")
        if corr is None:
            continue
        ts = float(e["ts"])
        ranges = [n[len(PREFIX):] for n in _containing(annotations, e["tid"], ts)]
        trace.ranges_of[corr] = set(ranges)
        inner = _innermost(ops, e["tid"], ts)
        where = ranges[-1:] + ([inner] if inner else [])
        trace.launcher[corr] = " / ".join(where) if where else e["name"]
    for e in device:
        trace.kernels.append((e["name"], float(e["ts"]), float(e.get("dur", 0)),
                              e.get("args", {}).get("correlation"), e["cat"]))
    return trace


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` (host and device activity) and
    read its trace back; returns (fn's result, Trace). The trace file is
    written to a temporary directory and removed."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    folder = tempfile.mkdtemp(prefix="port_bench_trace_")
    try:
        with profile(activities=activities) as prof:
            result = fn()
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        return result, read_chrome_trace(path)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
