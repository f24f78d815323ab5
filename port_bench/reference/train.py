"""The reference's train steps and forecasts, in float32.

- A train step: the plain MSE of the reference model's output against the
  target, its gradient by autograd, then AdamW in optax's form: the
  gradients clipped to a global norm (scaled by ``clip / norm`` when the
  norm reaches ``clip``), bias-corrected moments, ``eps`` outside the square
  root, decoupled weight decay ``lr * wd * p`` on every leaf.
- A forecast: the initial window normalised by the statistics (``(x -
  mean) / stdev``), the model run lead by lead with the predicted prognostic
  variables and the given forcings written into the next window's newest
  step, every lead de-normalised.
"""

from __future__ import annotations

import torch

from port_bench.reference.model import Reference


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps, wd))."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float, weight_decay: float, clip_norm,
                 eps: float = 1e-8) -> None:
        self.lr, self.b1, self.b2, self.wd, self.clip, self.eps = lr, b1, b2, weight_decay, clip_norm, eps
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Update ``params`` in place; returns the gradients as the update
        used them (clipped)."""
        if self.clip is not None:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
            if norm >= self.clip:
                grads = {k: g * (self.clip / norm) for k, g in grads.items()}
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * update)
        return grads


def train_steps(model: Reference, weights: dict, samples: list, optim: dict, leaves, loss_fn=None) -> dict:
    """The first ``len(samples)`` train steps from ``weights``: each step's
    loss, each leaf's first gradient (as the update took it) and each
    leaf's change after the last step, all as norms per leaf of
    ``leaves(list of (name, tensor))``, the published model's. ``loss_fn``
    replaces the MSE (a fault's reading)."""
    params = {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}
    start = {k: w.detach().clone() for k, w in weights.items()}
    opt = AdamW(params, optim["lr"], optim["b1"], optim["b2"], optim["weight_decay"], optim["clip_norm"])
    losses, first = [], None
    for x, y in samples:
        loss = (loss_fn or mse)(model.forward(params, x), y)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
        used = opt.step(params, grads)
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g)) for k, g in leaves(list(used.items()))}
        del grads, used, loss
    moved = [(k, params[k].detach() - start[k]) for k in params]
    change = {k: float(torch.linalg.vector_norm(t)) for k, t in leaves(moved)}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


@torch.no_grad()
def forecast(model: Reference, weights: dict, batch: torch.Tensor, forcings: torch.Tensor, leads: int,
             variables, device) -> torch.Tensor:
    """(leads, 1, 1, grid, outputs) in physical units from the initial
    window ``batch`` (1, multistep, grid, inputs) and the pre-processed
    ``forcings`` (leads, 1, 1, grid, n_forcing)."""
    mean_in, std_in = variables.input_stats(device)
    mean_out, std_out = variables.output_stats(device)
    x = ((batch - mean_in) / std_in)[:, :, None]
    prog_in = torch.as_tensor(variables.prog_in, device=device)
    prog_out = torch.as_tensor(variables.prog_out, device=device)
    forcing_in = torch.as_tensor(variables.forcing_in, device=device)
    outs = []
    for t in range(leads):
        y = model.forward(weights, x)
        outs.append(y * std_out + mean_out)
        nxt = torch.zeros_like(x[:, -1])
        nxt[..., prog_in] = y[..., prog_out]
        nxt[..., forcing_in] = forcings[t]
        x = torch.cat([x[:, 1:], nxt[:, None]], dim=1)
    return torch.stack(outs)
