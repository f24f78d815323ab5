"""Inputs and weights drawn from ``--seed``, on the device, in a few calls.

The benchmark makes everything it hands to the program and to the plain
reference: the variable table and its statistics (from the configuration's
file), the weights (by the parameter names and shapes of the model) and the
inputs. The same seed gives the same tensors on the same device; each use
draws from its own generator, seeded from the run's seed and a fixed stream
number, so a reference that draws again gets the same values.
"""

from __future__ import annotations

import numpy as np
import torch

STREAM_WEIGHTS, STREAM_TRAIN, STREAM_FORECAST = 1, 2, 3
_BIAS_STD, _TRAINABLE_STD = 0.02, 0.5


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for ``stream`` of ``seed`` (any whole number
    below 2**59)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 16 + stream) % (1 << 63))


class Variables:
    """The configuration's variable table: order, forcings, diagnostics,
    statistics, and the index lists of the model's input and output."""

    def __init__(self, config: dict) -> None:
        spec = config["variables"]
        self.order = list(spec["order"])
        self.forcing = list(spec["forcing"])
        self.diagnostic = list(spec["diagnostic"])
        self.name_to_index = {name: i for i, name in enumerate(self.order)}
        ms = np.asarray([spec["mean_stdev"][name] for name in self.order], np.float64)
        self.mean, self.stdev = ms[:, 0], ms[:, 1]
        # dataset order with the diagnostics (outputs only) and the forcings (inputs only) dropped
        self.inputs = [n for n in self.order if n not in self.diagnostic]
        self.outputs = [n for n in self.order if n not in self.forcing]
        self.prognostic = [n for n in self.inputs if n not in self.forcing]
        self.forcing_in = [self.inputs.index(n) for n in self.forcing]
        self.prog_in = [self.inputs.index(n) for n in self.prognostic]
        self.prog_out = [self.outputs.index(n) for n in self.prognostic]

    def statistics(self) -> dict:
        """The normalizer's statistics (float64, in dataset order)."""
        return {"mean": self.mean.copy(), "stdev": self.stdev.copy(),
                "minimum": self.mean - 5.0 * self.stdev, "maximum": self.mean + 5.0 * self.stdev}

    def input_stats(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        idx = [self.name_to_index[n] for n in self.inputs]
        return (torch.as_tensor(self.mean[idx], dtype=torch.float32, device=device),
                torch.as_tensor(self.stdev[idx], dtype=torch.float32, device=device))

    def output_stats(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        idx = [self.name_to_index[n] for n in self.outputs]
        return (torch.as_tensor(self.mean[idx], dtype=torch.float32, device=device),
                torch.as_tensor(self.stdev[idx], dtype=torch.float32, device=device))


def _kind(name: str) -> str:
    """How a parameter is drawn, from its name."""
    parent, leaf = name.rsplit(".", 2)[-2:]
    if "norm" in parent:  # layer_norm1, node_dst_mlp.norm, node_data_extractor_norm
        return "ln_weight" if leaf == "weight" else "ln_bias"
    if "trainable" in name:
        return "trainable"
    return "weight" if leaf == "weight" else "bias"


def make_weights(shapes: dict[str, tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 weights for the named shapes: one normal draw on the device for
    all of them, cut and scaled by kind (Dense weights std 1/sqrt(fan_in),
    biases 0.02, trainable tensors 0.5; LayerNorms 1 and 0)."""
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[n])) for n in names]
    flat = torch.randn(sum(sizes), generator=generator(seed, STREAM_WEIGHTS, device), device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        t = flat[at:at + size].view(shapes[name])
        at += size
        kind = _kind(name)
        if kind == "ln_weight":
            t = torch.ones_like(t)
        elif kind == "ln_bias":
            t = torch.zeros_like(t)
        elif kind == "weight":
            t = t * (1.0 / np.sqrt(shapes[name][-1]))
        else:
            t = t * (_BIAS_STD if kind == "bias" else _TRAINABLE_STD)
        out[name] = t.contiguous()
    return out


def train_samples(count: int, grid: int, n_in: int, n_out: int, seed: int, device,
                  multistep: int = 2) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``count`` normalised (x (1, multistep, 1, grid, n_in), y (1, 1, grid,
    n_out)) pairs, all different: what the pre-processors hand a train step."""
    gen = generator(seed, STREAM_TRAIN, device)
    xs = torch.randn((count, 1, multistep, 1, grid, n_in), generator=gen, device=device)
    ys = torch.randn((count, 1, 1, grid, n_out), generator=gen, device=device)
    return [(xs[i], ys[i]) for i in range(count)]


def forecast_requests(count: int, grid: int, variables: Variables, leads: int, seed: int, device,
                      multistep: int = 2) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``count`` requests: (initial window (1, multistep, grid, inputs) in
    physical units, drawn from the statistics; forcings (leads, 1, 1, grid,
    n_forcing), pre-processed)."""
    gen = generator(seed, STREAM_FORECAST, device)
    mean, stdev = variables.input_stats(device)
    x = torch.randn((count, 1, multistep, grid, len(variables.inputs)), generator=gen, device=device)
    x = x * stdev + mean
    f = torch.randn((count, leads, 1, 1, grid, len(variables.forcing)), generator=gen, device=device)
    return [(x[i], f[i]) for i in range(count)]
