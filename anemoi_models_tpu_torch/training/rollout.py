"""Autoregressive rollout driver.

Counterpart of ``anemoi_models_tpu/training/rollout.py``: a forecast is a
run of lead times, each fed the last ``multi_step`` windows, with the
predicted prognostic variables written back into the window and the
forcings supplied from outside. The JAX package runs the loop as one
``lax.scan`` program; here it is a Python loop of eager steps (CUDA graphs
are a later step).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from anemoi_models_tpu_torch.ops.flash_attention import fold_key

__all__ = ["make_rollout_fn"]


def make_rollout_fn(model: Any, data_indices: Any, n_steps: int) -> Callable:
    """Build ``rollout(x0, forcings=None, dropout_key=None) -> (x_final, predictions)``.

    - ``x0``: (batch, multi_step, ensemble, grid, n_in) initial window at the
      internal-model input width;
    - ``forcings``: (n_steps, batch, ensemble, grid, n_forcing) per-step
      forcing values, or None if the model has no forcing variables;
    - returns the last window and the predictions (n_steps, batch, ensemble,
      grid, n_out).

    - ``dropout_key``: required iff the model was built with
      ``deterministic=False`` (training-time attention dropout); lead time t
      runs under ``fold_key(dropout_key, t)``.

    Gradients flow through the whole rollout when the caller records them.
    """
    needs_key = not getattr(model, "deterministic", True)
    prog_in = np.asarray(data_indices.internal_model.input.prognostic)
    prog_out = np.asarray(data_indices.internal_model.output.prognostic)
    forcing_in = np.asarray(data_indices.internal_model.input.forcing)
    n_in = len(data_indices.internal_model.input)

    def rollout(x0: torch.Tensor, forcings: Optional[torch.Tensor] = None,
                dropout_key: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
        if needs_key and dropout_key is None:
            raise ValueError("this model was built with deterministic=False (attention dropout); "
                             "rollout() needs a dropout_key")
        if forcings is None and forcing_in.size:
            raise ValueError(
                f"This model takes {forcing_in.size} forcing variables per step but rollout() "
                "was called with forcings=None — every future step would see zero forcings "
                "(normalized space) and the forecast would silently drift. Pass a "
                "(n_steps, batch, ensemble, grid, n_forcing) array."
            )
        # the index tables on the window's device, once per call
        p_in, p_out, f_in = (torch.as_tensor(i, dtype=torch.long, device=x0.device)
                             for i in (prog_in, prog_out, forcing_in))
        x, preds = x0, []
        for t in range(n_steps):
            y = model(x) if dropout_key is None else model(x, dropout_key=fold_key(dropout_key, t))
            preds.append(y)
            # the next window's newest time step, built from zeros: the
            # prognostic outputs and this step's forcings
            nxt = x.new_zeros(x.shape[:1] + x.shape[2:4] + (n_in,))
            nxt[..., p_in] = y[..., p_out].to(nxt.dtype)
            if forcings is not None and forcing_in.size:
                nxt[..., f_in] = forcings[t].to(nxt.dtype)
            x = torch.cat([x[:, 1:], nxt[:, None]], dim=1)
        return x, torch.stack(preds)

    return rollout
