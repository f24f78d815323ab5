"""What the per-layer metrics read from a traced window (``metrics/``).

Every reader returns None where it finds nothing to read: a window of
another kind, or no kernel of the kind it times (a kernel taken off the
path). Times are device times from the profiler's trace, per train step or
per lead time of the traced window.
"""

from __future__ import annotations

from port_bench.harness import work

EDGE_KERNELS = ("kv_proj_tag", "edge_attn_csr_kernel", "bwd_dst_kernel", "bwd_src_kernel", "dw_parts_kernel",
                "dw_reduce_kernel")
FLASH_KERNELS = ("flash_attn_", "flash_bwd_")


def _of(run, kind: str) -> bool:
    """Whether ``run`` is a traced window of ``kind`` in which the device ran."""
    return run is not None and run.kind == kind and run.units > 0 and bool(run.trace.device_ops())


def launches(run, kind: str):
    """Device kernels a unit."""
    return len(run.trace.device_ops()) / run.units if _of(run, kind) else None


def range_ms(run, kind: str, *ranges: str):
    """Device ms a unit of the kernels launched inside the harness's ranges."""
    if not _of(run, kind):
        return None
    kernels = [k for name in ranges for k in run.trace.in_range(name)]
    return sum(k[2] for k in kernels) / 1e3 / run.units if kernels else None


def roofline_pct(run, kind: str, patterns, calls) -> float | None:
    """100 x the least time of a unit's work (``calls``: (kernel, FLOPs,
    bytes)) over the device time a unit of the kernels named by
    ``patterns``."""
    if not _of(run, kind) or not calls:
        return None
    kernels = run.trace.matching(patterns)
    if not kernels:
        return None
    device_s = sum(k[2] for k in kernels) / 1e6 / run.units
    return 100.0 * work.least_time_s(calls) / device_s


def edge_roofline(run, kind: str):
    return roofline_pct(run, kind, EDGE_KERNELS, work.edge_calls(run.shapes, kind == "train") if run else [])


def flash_roofline(run, kind: str):
    return roofline_pct(run, kind, FLASH_KERNELS, work.flash_calls(run.shapes, kind == "train") if run else [])


def mfu_pct(run, kind: str):
    """100 x the model FLOPs of a unit over (a unit's time x the bf16 peak).
    The time is that of the same units run just before the traced window
    without the profiler, which slows the host's dispatch."""
    if not _of(run, kind):
        return None
    flops = work.model_flops(run.shapes, kind == "train")
    return 100.0 * flops / (run.plain_s / run.units * work.PEAK_BF16_FLOPS)


def idle_pct(run, kind: str):
    """100 x (1 - the device's busy time a unit / a unit's time): the busy
    time is the union of device activity in the traced window, the unit's
    time that of the same units untraced (as for ``mfu_pct``)."""
    if not _of(run, kind):
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / 1e6 / run.plain_s)
