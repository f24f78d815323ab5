"""Synthetic weather-like data for examples, tests, and benchmarks.

The port's own copy of ``anemoi_models_tpu/training/data.py`` (numpy only):
the same seed gives the same fields in both packages.

The reference gets real data through the external anemoi-datasets/training
stack; this module provides a self-contained generator with the same tensor
contract: batches of (batch, time, grid, vars) at the *data* level, plus the
statistics dict the preprocessing stack consumes.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["SyntheticWeather"]


class SyntheticWeather:
    """Smooth spatially-correlated fields evolving by advection + noise.

    Fields are sums of spherical harmonics-ish sinusoids of the node
    coordinates, rotated in longitude each step — enough structure that a
    model must actually learn advection to beat persistence.
    """

    def __init__(
        self,
        coords: np.ndarray,
        num_vars: int,
        seed: int = 0,
        rotation: float = 0.05,
        noise: float = 0.01,
    ) -> None:
        self.coords = np.asarray(coords)  # (grid, 2) lat/lon radians
        self.num_vars = num_vars
        self.rotation = rotation
        self.noise = noise
        rng = np.random.RandomState(seed)
        self.freqs = rng.randint(1, 4, size=(num_vars, 3))
        self.phases = rng.rand(num_vars, 3) * 2 * np.pi
        self.amps = 0.5 + rng.rand(num_vars, 3)
        self.offsets = rng.randn(num_vars) * 2
        self.scales = 0.5 + rng.rand(num_vars) * 2
        self._rng = rng

    def field(self, t: float) -> np.ndarray:
        """(grid, vars) state at continuous time t."""
        lat, lon = self.coords[:, 0], self.coords[:, 1]
        out = np.zeros((len(lat), self.num_vars), dtype=np.float32)
        for v in range(self.num_vars):
            f = np.zeros_like(lat)
            for k in range(3):
                f += self.amps[v, k] * np.sin(
                    self.freqs[v, k] * (lon - self.rotation * t) + self.phases[v, k]
                ) * np.cos(self.freqs[v, k] * lat)
            out[:, v] = self.offsets[v] + self.scales[v] * f
        return out

    def batch(self, batch_size: int, window: int, t0: float = 0.0) -> np.ndarray:
        """(batch, window, grid, vars) consecutive states with noise."""
        out = np.stack(
            [
                np.stack([self.field(t0 + b * 100 + s) for s in range(window)])
                for b in range(batch_size)
            ]
        )
        return out + self._rng.randn(*out.shape).astype(np.float32) * self.noise

    def batches(self, batch_size: int, window: int) -> Iterator[np.ndarray]:
        t = 0.0
        while True:
            yield self.batch(batch_size, window, t0=t)
            t += 1.0

    def statistics(self, samples: int = 32) -> dict:
        """Statistics dict over sampled states (the normalizer's contract)."""
        fields = np.stack([self.field(t * 7.3) for t in range(samples)])
        flat = fields.reshape(-1, self.num_vars)
        return {
            "mean": flat.mean(0),
            "stdev": flat.std(0) + 1e-6,
            "minimum": flat.min(0),
            "maximum": flat.max(0),
        }
