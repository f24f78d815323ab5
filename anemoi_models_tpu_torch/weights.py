"""Parameters: flax-tree loading and seeded initialisation.

:func:`load_flax_params` turns the JAX package's parameter tree (nested dicts
of numpy arrays, as ``model.init`` returns them) into a state dict of the
port's modules:

- a flax ``Dense`` kernel is (in, out) (``x @ kernel``); ``nn.Linear.weight``
  is (out, in), so kernels are transposed;
- flax ``LayerNorm`` ``scale``/``bias`` become ``weight``/``bias``;
- the processor's fused ``lin_qkvs`` (columns ``[q | k | v | r]``) splits into
  ``lin_qr`` (``[q | r]``) and ``lin_kv`` (``[k | v]``);
- under the commuted dataflow the encoder's ``emb_nodes_src`` sits at
  ``encoder/proc/emb_nodes_src``; the port keeps it at ``encoder.emb_nodes_src``
  and accepts either place (for a mapper's own tree too: ``proc/emb_nodes_src``).

:func:`init_params` draws the flax initialisers (lecun-normal kernels, zero
biases, unit LayerNorm scales, zero trainable tensors) from a
``torch.Generator`` on the host, so the same seed gives the same weights on
every device.
"""

from __future__ import annotations

import math
import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_params", "init_params"]

_RENAME = {
    "AutocastLayerNorm_0": "norm",
    "Dense_0": "fc1",
    "Dense_1": "fc2",
    "kernel": "weight",
    "scale": "weight",
}
_LAYER_INDEX = re.compile(r"^(proc|blocks)_(\d+)$")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _port_name(path: tuple) -> str:
    if "emb_nodes_src" in path[1:] and path[path.index("emb_nodes_src") - 1] == "proc":
        i = path.index("emb_nodes_src")
        path = (*path[: i - 1], *path[i:])  # commuted layout: <mapper>/proc/emb_nodes_src
    if len(path) == 2 and path[0] == "node_attributes" and path[1].startswith("trainable_"):
        path = ("node_attributes", "trainable", path[1][len("trainable_"):])
    tokens = []
    for token in path:
        if token == "LayerNorm_0":  # flax LayerNorm wrapped by AutocastLayerNorm
            continue
        match = _LAYER_INDEX.match(token)
        tokens.append(f"{match[1]}.{match[2]}" if match else _RENAME.get(token, token))
    return ".".join(tokens)


def load_flax_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """State dict of the port's model from a flax parameter tree."""
    if "params" in tree:
        tree = tree["params"]
    state = {}
    for path, value in _flatten(tree).items():
        tensor = torch.from_numpy(np.array(value, dtype=np.float32))
        if path[-1] == "kernel":
            tensor = tensor.t()
        if path[-2] == "lin_qkvs":
            q, k, v, r = tensor.chunk(4, dim=0)  # weight rows / bias entries
            stem = _port_name((*path[:-2], "lin_qr", path[-1]))
            state[stem] = torch.cat([q, r]).contiguous()
            state[stem.replace("lin_qr", "lin_kv")] = torch.cat([k, v]).contiguous()
            continue
        state[_port_name(path)] = tensor.contiguous()
    return state


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise ``model`` in place as flax initialises the JAX model.
    ``generator`` is a CPU generator; values are drawn on the host, in
    parameter order, and copied to the parameters' device."""
    trunc = 0.87962566103423978  # std of the unit normal truncated at +-2
    for name, param in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        module = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        if isinstance(module, nn.Linear) and leaf == "weight":
            std = math.sqrt(1.0 / param.shape[1]) / trunc
            value = torch.empty(param.shape)
            nn.init.trunc_normal_(value, std=std, a=-2 * std, b=2 * std, generator=generator)
        elif isinstance(module, nn.LayerNorm) and leaf == "weight":
            value = torch.ones(param.shape)
        else:  # biases and trainable tensors
            value = torch.zeros(param.shape)
        param.copy_(value)
