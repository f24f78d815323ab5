"""The two kinds of cell: train steps and forecasts.

Each builds the port's model for the cell, loads the benchmark's weights,
warms up the cell's shapes (a train cell's warm-up is its first steps, the
ones the reference follows), measures a window, frees the program's state
and then runs the plain reference on what the window produced.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass

import numpy as np
import torch

from port_bench.harness import common, data, program, trace, work
from port_bench.harness.common import Compared, Outcome, log, now
from port_bench.reference.model import Reference, strict_fp32
from port_bench.reference.train import forecast as reference_forecast
from port_bench.reference.train import train_steps as reference_train_steps

# a leaf whose first gradient in the reference is below this share of the median leaf's moves by round-off
NEGLIGIBLE_GRAD = 1e-3


@dataclass
class TracedRun:
    """What a per-layer metric's reader reads."""

    kind: str  # "train" or "forecast"
    trace: trace.Trace
    units: int  # train steps or lead times in the traced window
    window_s: float  # the traced window's length
    plain_s: float  # the same number of units run just before it without the profiler, which slows the host
    shapes: work.Shapes


def graph_sizes(graph, config: dict) -> dict:
    attrs = config["edge_attributes"]
    enc, proc, dec = (graph[k] for k in (("data", "to", "hidden"), ("hidden", "to", "hidden"),
                                          ("hidden", "to", "data")))
    return {"data": graph["data"].num_nodes, "hidden": graph["hidden"].num_nodes, "enc": enc.num_edges,
            "proc": proc.num_edges, "dec": dec.num_edges, "edge_attr_dim": enc.attr_tensor(attrs).shape[1]}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Elapsed ms between marks: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, device) -> None:
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return now()

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b) if not isinstance(a, float) else (b - a) * 1e3


def _more(t0: float, done: int, seconds: float, count) -> bool:
    """Whether a window goes on: for ``seconds`` by the host's clock, or
    for ``count`` units when a count is given (a traced window)."""
    return now() - t0 < seconds if count is None else done < count


def _window_open(device) -> None:
    _sync(device)
    common.settle()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log(f"card before the window: {common.card_reading()}")


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def published_leaves(named: list[tuple[str, torch.Tensor]]) -> list[tuple[str, torch.Tensor]]:
    """The model's leaves as the published model holds them: the port's
    fused ``lin_kv`` is anemoi-models' ``lin_key`` and ``lin_value``, whose
    key bias has no gradient (the softmax does not see it)."""
    out = []
    for name, t in named:
        if ".lin_kv." in name:
            key, value = t.chunk(2, dim=0)
            out += [(name.replace(".lin_kv.", ".lin_key."), key), (name.replace(".lin_kv.", ".lin_value."), value)]
        else:
            out.append((name, t))
    return out


def _worst_leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """max over leaves of |prog - ref| / max(ref, median ref): the gap of
    the norms, against the leaf's or the median leaf's norm."""
    names = [k for k in ref if keep is None or keep(k)]
    median = float(np.median([ref[k] for k in names]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def run_train(cell, seed: int, seconds: float, traced: bool, device, since_start) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    variables = data.Variables(cfg)
    graph = program.graph_for(tr, log)
    iface = program.build_interface(cfg, graph, variables, device)
    model = iface.model
    shapes = program.parameter_shapes(model)
    program.load_weights(model, data.make_weights(shapes, seed, device))
    sizes = graph_sizes(graph, cfg)
    n_in, n_out = len(variables.inputs), len(variables.outputs)
    samples = data.train_samples(tr["pool"], sizes["data"], n_in, n_out, seed, device, cfg["multistep_input"])
    optimizer = program.make_optimizer(model, cfg)
    step = program.make_train_step(model, optimizer)
    params = [p for _, p in model.named_parameters()]
    leaf_names = [n for n, _ in published_leaves(list(model.named_parameters()))]

    # the first steps: the kernels build, and the reference follows them
    start = [p.detach().clone() for p in params]
    losses = []
    grad_norms = None
    for i in range(tr["checked_steps"]):
        losses.append(step(*samples[i % tr["pool"]]))
        if i == 0:  # the first gradient as the update took it: mu / (1 - b1) after one step
            mus = [(n, optimizer.state[p]["mu"] if "mu" in optimizer.state[p] else torch.zeros_like(p))
                   for n, p in model.named_parameters()]
            grad_norms = torch.stack(torch._foreach_norm([t for _, t in published_leaves(mus)]))
            grad_norms = grad_norms / (1.0 - cfg["optimizer"]["b1"])
            del mus
    moved = [(n, p.detach() - s0) for (n, p), s0 in zip(model.named_parameters(), start)]
    change_norms = torch.stack(torch._foreach_norm([t for _, t in published_leaves(moved)]))
    del moved
    program_readings = {"losses": [float(x) for x in losses],
                        "grad_norms": dict(zip(leaf_names, grad_norms.tolist())),
                        "change_norms": dict(zip(leaf_names, change_norms.tolist()))}
    del start
    offset = tr["checked_steps"]
    for i in range(tr["warmup_steps"]):
        step(*samples[(offset + i) % tr["pool"]])
    offset += tr["warmup_steps"]
    log(f"first losses {program_readings['losses']}")

    clock = _Clock(device)
    _window_open(device)
    setup_s = since_start()
    window_losses = []

    def window(max_steps=None) -> list:
        """Steps back to back from the next sample; the clock's marks before
        the first and after each."""
        t0, first = now(), len(window_losses)
        marks = [clock.mark()]
        while _more(t0, len(window_losses) - first, seconds, max_steps):
            window_losses.append(step(*samples[(offset + len(window_losses)) % tr["pool"]]))
            marks.append(clock.mark())
        _sync(device)
        return marks

    with common.GcCount() as gcs:
        if traced:  # the same steps untraced, then traced
            plain = window(tr["trace_steps"])
            with trace.Ranges({"encoder": model.encoder, "processor": model.processor, "decoder": model.decoder},
                              optimizer):
                marks, tr_data = trace.profiled(lambda: window(tr["trace_steps"]))
        else:
            marks = window()
    peak = _peak(device)
    log(f"card after the window: {common.card_reading()}")
    steps = len(marks) - 1
    window_ms = clock.ms(marks[0], marks[-1])
    per_step = [clock.ms(a, b) for a, b in zip(marks, marks[1:])]
    log(common.spread_line("train steps", per_step))
    log(f"window {window_ms:.3f} ms, {steps} steps, {gcs.count} garbage collections in the window")
    finite = torch.isfinite(torch.stack(window_losses)).tolist()
    out = Outcome(attempted=len(window_losses), failed=sum(not f for f in finite), peak_bytes=peak)
    out.end_to_end = {"train_step_ms": window_ms / steps, "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    if traced:
        plain_ms = clock.ms(plain[0], plain[-1])
        log(f"untraced, the same {steps} steps before it: {plain_ms:.3f} ms")
        out.trace = TracedRun("train", tr_data, steps, window_ms / 1e3, plain_ms / 1e3,
                              work.Shapes.of(cfg, sizes, variables, tr["batch"]))

    # the program's state goes before the reference runs
    del step, optimizer, model, iface, params, samples, window_losses, losses
    _free(device)

    strict_fp32()
    t_ref = now()
    ref = Reference(cfg, graph.to_arrays(), variables, device)
    weights = data.make_weights(shapes, seed, device)
    ref_samples = data.train_samples(tr["pool"], sizes["data"], n_in, n_out, seed, device,
                                     cfg["multistep_input"])[:tr["checked_steps"]]
    r = reference_train_steps(ref, weights, ref_samples, cfg["optimizer"], published_leaves)
    out.compared = compare_train(program_readings, r, cell.limits)
    log(f"reference: {tr['checked_steps']} steps in {now() - t_ref:.2f} s; losses {r['losses']}")
    return out


def compare_train(prog: dict, ref: dict, limits: dict) -> list[Compared]:
    """The loss of each first step, the norm of each leaf's first gradient
    and of its change over the first steps, against the reference."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = _worst_leaf_gap(prog["grad_norms"], ref["grad_norms"])
    median_grad = float(np.median(list(ref["grad_norms"].values())))
    moved = lambda k: ref["grad_norms"][k] >= NEGLIGIBLE_GRAD * median_grad  # noqa: E731
    change_gap, change_leaf = _worst_leaf_gap(prog["change_norms"], ref["change_norms"], moved)
    log(f"worst leaves: gradient {grad_leaf}, change {change_leaf}; "
        f"left out of the change: {sorted(k for k in ref['grad_norms'] if not moved(k))}")
    return [Compared("loss_gap", loss_gap, limits["loss_gap"]), Compared("grad_gap", grad_gap, limits["grad_gap"]),
            Compared("change_gap", change_gap, limits["change_gap"])]


def run_forecast(cell, seed: int, seconds: float, traced: bool, device, since_start) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    variables = data.Variables(cfg)
    graph = program.graph_for(tr, log)
    iface = program.build_interface(cfg, graph, variables, device)
    model = iface.model
    shapes = program.parameter_shapes(model)
    program.load_weights(model, data.make_weights(shapes, seed, device))
    sizes = graph_sizes(graph, cfg)
    leads, pool = tr["leads"], tr["pool"]
    pin = device.type == "cuda"
    requests = [(x.cpu().pin_memory() if pin else x.cpu(), f.cpu().pin_memory() if pin else f.cpu())
                for x, f in data.forecast_requests(pool, sizes["data"], variables, leads, seed, device,
                                                   cfg["multistep_input"])]
    clock = _Clock(device)
    # a traced run times its requests untraced first, then traces as many: the checked ones are traced
    first = tr["trace_requests"] if traced else 0
    count = tr["trace_requests"] if traced else tr["checked_within"]
    checked = {first + i for i in np.random.default_rng(seed).choice(count, size=min(tr["checked_requests"], count),
                                                                    replace=False).tolist()}
    # the host buffers the leads arrive in: one for every request, and one of their own for those checked
    shape = (leads, 1, 1, sizes["data"], len(variables.outputs))
    result = torch.empty(shape, pin_memory=pin)
    own = {i: torch.empty(shape, pin_memory=pin) for i in checked}
    kept, latencies, bad = {}, [], []

    def request(i: int) -> None:
        x, f = requests[i % pool]
        target = own.get(i, result)
        t0 = clock.mark()
        out = iface.predict_rollout(x.to(device, non_blocking=True), leads, f.to(device, non_blocking=True))
        bad.append((~torch.isfinite(out)).any())
        target.copy_(out, non_blocking=True)
        t1 = clock.mark()
        if clock.cuda:
            t1.synchronize()
        latencies.append(clock.ms(t0, t1))
        if i in own:
            kept[i] = target

    for _ in range(tr["warmup_requests"]):
        request(-1)
    latencies.clear()
    bad.clear()
    _window_open(device)
    setup_s = since_start()

    def window(max_requests=None) -> float:
        """Requests one after another; the window's ms by the host's clock."""
        t0, start = now(), len(latencies)
        while _more(t0, len(latencies) - start, seconds, max_requests):
            request(len(latencies))
        return (now() - t0) * 1e3

    with common.GcCount() as gcs:
        if traced:
            plain_ms = window(tr["trace_requests"])
            with trace.Ranges({"encoder": model.encoder, "processor": model.processor, "decoder": model.decoder}):
                window_ms, tr_data = trace.profiled(lambda: window(tr["trace_requests"]))
        else:
            window_ms = window()
    peak = _peak(device)
    log(f"card after the window: {common.card_reading()}")
    timed = latencies[first:]
    n = len(timed)
    per_lead = [ms / leads for ms in timed]
    log(common.spread_line("forecasts, ms a lead", per_lead))
    log(f"window {window_ms:.3f} ms, {n} forecasts, {gcs.count} garbage collections in the window, "
        f"{window_ms - sum(timed):.3f} ms of the window outside any forecast")
    log("forecast ms, in order: " + " ".join(f"{ms:.2f}" for ms in timed))
    failed = sum(bool(b) for b in torch.stack(bad).tolist()) if bad else 0
    out = Outcome(attempted=len(latencies), failed=failed, peak_bytes=peak)
    out.end_to_end = {"forecast_lead_ms": window_ms / (n * leads),
                      "forecast_lead_ms_p95": common.percentile(per_lead, 95.0),
                      "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    if traced:
        log(f"untraced, the {first} forecasts before it: {plain_ms:.3f} ms")
        out.trace = TracedRun("forecast", tr_data, n * leads, window_ms / 1e3, plain_ms / 1e3,
                              work.Shapes.of(cfg, sizes, variables, tr["batch"]))
    missing = sorted(checked - set(kept))
    if missing:
        log(f"checked forecasts {missing} never completed")
        out.answers_complete = False

    del iface, model, requests, result, own
    _free(device)

    strict_fp32()
    t_ref = now()
    ref = Reference(cfg, graph.to_arrays(), variables, device)
    weights = data.make_weights(shapes, seed, device)
    reqs = data.forecast_requests(pool, sizes["data"], variables, leads, seed, device, cfg["multistep_input"])
    std = torch.as_tensor(variables.output_stats(device)[1])
    worst = 0.0
    for i, got in sorted(kept.items()):
        x, f = reqs[i % pool]
        err = lead_errors(got.to(device), reference_forecast(ref, weights, x, f, leads, variables, device), std)
        worst = max(worst, float(err.max()))
        log(f"forecast {i}: error by lead {[round(float(e), 6) for e in err]}")
    out.compared = compare_forecast(worst, cell.limits)
    log(f"reference: {len(kept)} forecasts in {now() - t_ref:.2f} s")
    return out


def lead_errors(got: torch.Tensor, want: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Each lead's RMS over the grid and the outputs of (got - want) / the
    output's standard deviation; (leads, 1, 1, grid, outputs) each."""
    return (((got - want) / std) ** 2).mean(dim=(1, 2, 3, 4)).sqrt()


def compare_forecast(worst: float, limits: dict) -> list[Compared]:
    """The worst lead's error over the checked forecasts, against its limit."""
    return [Compared("forecast_err", worst, limits["forecast_err"])]
