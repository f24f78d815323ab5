"""Optimizer factory + parameter EMA.

Counterpart of ``anemoi_models_tpu/training/optim.py``: AdamW with a linear
warmup + cosine decay schedule and global-norm clipping. The three pieces are
written in optax's form, not torch's, so that a train step in the port follows
the JAX package's step for step:

- the schedule is ``optax.warmup_cosine_decay_schedule``, read at the update
  count *before* it is incremented: the first update uses ``init_value``
  (0.0 in :func:`make_optimizer`);
- clipping is ``optax.clip_by_global_norm``: gradients are scaled by
  ``max_norm / g_norm`` only when ``g_norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and scales
  whenever it is above);
- AdamW is ``optax.adamw``: bias-corrected moments, ``eps`` added outside the
  square root, decoupled decay ``lr * wd * p`` on every parameter.

Under a ZeRO-1 / FSDP plan (``parallel.fsdp``, attached as ``plan``) each
rank holds its slice of a sharded leaf's moments and updates its slice of
the leaf; the clip reads the norm of the whole gradient.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional

import torch

__all__ = ["AdamW", "ema_update", "make_optimizer", "warmup_cosine_decay_schedule"]


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1) as a function of
    the update count."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, ...))``
    as a torch optimizer. ``count`` is the number of updates taken, optax's
    step counter. A parameter without a gradient is updated as if its
    gradient were zero, as optax updates every leaf. ``plan``, when a
    ``parallel.fsdp.ShardPlan`` sets it, says which slice of each leaf this
    rank updates and how the gradient's global norm is summed."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None) -> None:
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0
        self.plan = None

    def state_dict(self) -> dict:
        """torch's optimizer state (each parameter's ``mu`` and ``nu``) and
        ``count``, which the schedule and the bias corrections read."""
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        state = dict(state_dict)
        self.count = int(state.pop("count", 0))
        super().load_state_dict(state)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("AdamW.step takes no closure")
        groups = [
            (group, group["params"], [torch.zeros_like(p) if p.grad is None else p.grad for p in group["params"]])
            for group in self.param_groups
        ]
        plan = self.plan
        if self.clip_norm is not None:
            # optax.clip_by_global_norm, on the device (no host sync): the
            # per-tensor norms are combined as sqrt(sum of squares)
            norms = [n for _, _, grads in groups for n in torch._foreach_norm(grads)]
            if plan is not None and plan.mode == "fsdp":
                g_norm = plan.global_norm([p for _, params, _ in groups for p in params], norms)
            else:
                g_norm = torch.linalg.vector_norm(torch.stack(norms).float())
            factor = torch.where(g_norm < self.clip_norm, 1.0, self.clip_norm / g_norm)
            groups = [(group, params, torch._foreach_mul(grads, factor)) for group, params, grads in groups]
        lr = self.schedule(self.count)
        self.count += 1
        for group, leaves, grads in groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            # what this rank updates: each leaf, or under ZeRO-1 its slice of a sharded one
            params = leaves if plan is None else plan.views(leaves)
            if plan is not None:
                grads = plan.grad_views(leaves, grads)
            for leaf, p in zip(leaves, params):
                if not self.state[leaf]:
                    self.state[leaf]["mu"] = torch.zeros_like(p)
                    self.state[leaf]["nu"] = torch.zeros_like(p)
            mus = [self.state[leaf]["mu"] for leaf in leaves]
            nus = [self.state[leaf]["nu"] for leaf in leaves]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(nus, 1.0 - b2 ** self.count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            updates = torch._foreach_div(mus, 1.0 - b1 ** self.count)
            torch._foreach_div_(updates, denom)
            if wd:
                torch._foreach_add_(updates, params, alpha=wd)
            torch._foreach_add_(params, updates, alpha=-lr)
        return None


def make_optimizer(
    params: Iterable[torch.Tensor],
    peak_lr: float = 1e-3,
    *,
    warmup_steps: int = 1000,
    total_steps: int = 100_000,
    end_lr_ratio: float = 0.01,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = 32.0,
    b1: float = 0.9,
    b2: float = 0.95,
) -> AdamW:
    """AdamW + linear warmup + cosine decay + global-norm clipping over
    ``params``, with the JAX package's defaults."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=peak_lr,
        warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1),
        end_value=peak_lr * end_lr_ratio,
    )
    return AdamW(params, schedule, b1=b1, b2=b2, weight_decay=weight_decay, clip_norm=clip_norm)


@torch.no_grad()
def ema_update(ema: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float = 0.999) -> dict[str, torch.Tensor]:
    """One EMA step over named parameters (use the result for eval/ckpt)."""
    return {k: decay * e + (1.0 - decay) * params[k] for k, e in ema.items()}
