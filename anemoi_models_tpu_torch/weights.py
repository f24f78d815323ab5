"""Parameters: flax-tree loading and saving, and seeded initialisation.

:func:`load_flax_params` turns the JAX package's parameter tree (nested dicts
of numpy arrays, as ``model.init`` returns them, or of torch tensors where a
JAX checkpoint held bf16) into a state dict of the port's modules:

- a flax ``Dense`` kernel is (in, out) (``x @ kernel``); ``nn.Linear.weight``
  is (out, in), so kernels are transposed;
- flax ``LayerNorm`` ``scale``/``bias`` become ``weight``/``bias``;
- the two-layer MLPs written inline in flax (a GraphTransformer block's
  ``node_dst_mlp``, a Transformer block's ``Dense_0``/``Dense_1``) are
  ``norm``/``fc1``/``fc2`` here; a GraphConv's ``MLP_0`` is ``mlp``; the
  ``MLP`` modules (GNN flavor) keep flax's ``Dense_i`` and
  ``AutocastLayerNorm_0``;
- the processor's fused ``lin_qkvs`` (columns ``[q | k | v | r]``) splits into
  ``lin_qr`` (``[q | r]``) and ``lin_kv`` (``[k | v]``);
- under the commuted dataflow the encoder's ``emb_nodes_src`` sits at
  ``encoder/proc/emb_nodes_src``; the port keeps it at ``encoder.emb_nodes_src``
  and accepts either place (for a mapper's own tree too: ``proc/emb_nodes_src``);
- a ``HaloGNNProcessor``'s edge MLPs are its own parameters,
  ``conv_{i}_w1`` .. ``conv_{i}_ln_b``, kept in the flax layout ((in, out)
  kernels) under the flax names, so they load and save as they are;
- the hierarchical model's per-level modules, flax's
  ``down_level_processor_<level>``, ``up_level_processor_<level>``,
  ``downscale_<level>`` and ``upscale_<level>``, are entries of the port's
  ``nn.ModuleDict``s: ``down_level_processor.<level>`` and so on.

:func:`to_flax_params` is its inverse: it carries a state dict (a model
trained in the port, or its gradients) back to the JAX package's tree.

:func:`init_params` draws the flax initialisers (lecun-normal kernels, zero
biases, unit LayerNorm scales, zero trainable tensors; a ``HaloGNNProcessor``'s
own kernels and scales as flax draws them) from a
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

__all__ = ["load_flax_params", "to_flax_params", "init_params"]

_RENAME = {"kernel": "weight", "scale": "weight"}
_INLINE_MLP = {"AutocastLayerNorm_0": "norm", "Dense_0": "fc1", "Dense_1": "fc2"}
_LAYER_INDEX = re.compile(r"^(proc|blocks)_(\d+)$")
_FLAX_NAME = {**{port: flax for flax, port in _INLINE_MLP.items()}, "mlp": "MLP_0"}
# the hierarchical model's per-level modules: flax <dict>_<level>, the port's ModuleDict <dict>.<level>
_LEVEL_DICTS = ("down_level_processor", "up_level_processor", "downscale", "upscale")
# a HaloGNNProcessor's own edge-MLP parameters: conv_<layer>_<w1|b1|w2|b2|w3|b3|ln_s|ln_b>
_HALO_GNN_PARAM = re.compile(r"^conv_\d+_(w[123]|b[123]|ln_s|ln_b)$")


def _rename(parent: str, token: str) -> str:
    """The port's name of flax module ``token`` under ``parent``."""
    if parent == "node_dst_mlp" or (parent.startswith("blocks_") and token in ("Dense_0", "Dense_1")):
        return _INLINE_MLP.get(token, token)
    if parent == "conv" and token == "MLP_0":
        return "mlp"
    return _RENAME.get(token, token)


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value if isinstance(value, torch.Tensor) else np.asarray(value)
    return out


def _port_name(path: tuple) -> str:
    if "emb_nodes_src" in path[1:] and path[path.index("emb_nodes_src") - 1] == "proc":
        i = path.index("emb_nodes_src")
        path = (*path[: i - 1], *path[i:])  # commuted layout: <mapper>/proc/emb_nodes_src
    if len(path) == 2 and path[0] == "node_attributes" and path[1].startswith("trainable_"):
        path = ("node_attributes", "trainable", path[1][len("trainable_"):])
    level_dict = next((d for d in _LEVEL_DICTS if path[0].startswith(d + "_")), None)
    if level_dict is not None:
        return ".".join((level_dict, path[0][len(level_dict) + 1:], _port_name(("_level", *path[1:]))[len("_level."):]))
    tokens = []
    for parent, token in zip(("", *path), path):
        if token == "LayerNorm_0":  # flax LayerNorm wrapped by AutocastLayerNorm
            continue
        match = _LAYER_INDEX.match(token)
        tokens.append(f"{match[1]}.{match[2]}" if match else _rename(parent, token))
    return ".".join(tokens)


def load_flax_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """State dict of the port's model from a flax parameter tree."""
    if "params" in tree:
        tree = tree["params"]
    state = {}
    for path, value in _flatten(tree).items():
        # a bf16 leaf of a JAX checkpoint arrives as a torch tensor (numpy has no bf16)
        tensor = (value.float() if isinstance(value, torch.Tensor)
                  else torch.from_numpy(np.array(value, dtype=np.float32)))
        if path[-1] == "kernel":
            tensor = tensor.t()
        if len(path) > 1 and path[-2] == "lin_qkvs":
            q, k, v, r = tensor.chunk(4, dim=0)  # weight rows / bias entries
            stem = _port_name((*path[:-2], "lin_qr", path[-1]))
            state[stem] = torch.cat([q, r]).contiguous()
            state[stem.replace("lin_qr", "lin_kv")] = torch.cat([k, v]).contiguous()
            continue
        state[_port_name(path)] = tensor.contiguous()
    return state


def _flax_path(name: str, state: Mapping[str, torch.Tensor]) -> tuple:
    stem, leaf = name.split(".")[:-1], name.split(".")[-1]
    if stem == ["node_attributes", "trainable"]:
        return ("node_attributes", f"trainable_{leaf}")
    if stem and stem[0] in _LEVEL_DICTS:
        inner = _flax_path(".".join(["_level", *stem[2:], leaf]), {
            ".".join(["_level", *k.split(".")[2:]]): v for k, v in state.items()
            if k.split(".")[:2] == stem[:2]})
        return (f"{stem[0]}_{stem[1]}", *inner[1:])
    path: list[str] = []
    for token in stem:
        if token.isdigit() and path and path[-1] in ("proc", "blocks"):
            path[-1] = f"{path[-1]}_{token}"
        else:
            path.append(_FLAX_NAME.get(token, token))
    if path and path[-1] == "emb_nodes_src":
        path.insert(-1, "proc")  # commuted layout: <mapper>/proc/emb_nodes_src
    weight = state.get(".".join([*stem, "weight"]))
    if weight is not None and weight.dim() == 1:  # a LayerNorm (flax LayerNorm_0 inside)
        return (*path, "LayerNorm_0", "scale" if leaf == "weight" else "bias")
    return (*path, "kernel" if leaf == "weight" else leaf)


def to_flax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The JAX package's parameter tree, ``{"params": ...}`` of numpy fp32
    arrays, from a state dict of the port's model (or a dict of gradients with
    the same names): the inverse of :func:`load_flax_params`. ``lin_qr`` and
    ``lin_kv`` of a processor block join back into ``lin_qkvs`` (columns
    ``[q | k | v | r]``). A mapper's ``emb_nodes_src`` goes where the JAX
    commuted dataflow (``kv_src_gather="auto"``, the default) keeps it."""
    state = {k: v.detach().cpu().float() for k, v in state_dict.items()}
    tree: dict = {}
    for name, tensor in state.items():
        if ".lin_kv." in name and name.replace(".lin_kv.", ".lin_qr.") in state:
            continue  # joined into lin_qkvs with its lin_qr
        if ".lin_qr." in name:
            q, r = tensor.chunk(2, dim=0)
            k, v = state[name.replace(".lin_qr.", ".lin_kv.")].chunk(2, dim=0)
            tensor = torch.cat([q, k, v, r])
            name = name.replace(".lin_qr.", ".lin_qkvs.")
        path = _flax_path(name, state)
        if path[-1] == "kernel":
            tensor = tensor.t()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = tensor.contiguous().numpy()
    return {"params": tree}


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise ``model`` in place as flax initialises the JAX model.
    ``generator`` is a CPU generator; values are drawn on the host, in
    parameter order, and copied to the parameters' device."""
    trunc = 0.87962566103423978  # std of the unit normal truncated at +-2
    for name, param in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        module = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        halo_gnn = _HALO_GNN_PARAM.match(leaf)
        if (isinstance(module, nn.Linear) and leaf == "weight") or (halo_gnn and halo_gnn[1][0] == "w"):
            fan_in = param.shape[0] if halo_gnn else param.shape[1]  # HaloGNNProcessor's kernels are (in, out)
            std = math.sqrt(1.0 / fan_in) / trunc
            value = torch.empty(param.shape)
            nn.init.trunc_normal_(value, std=std, a=-2 * std, b=2 * std, generator=generator)
        elif (isinstance(module, nn.LayerNorm) and leaf == "weight") or (halo_gnn and halo_gnn[1] == "ln_s"):
            value = torch.ones(param.shape)
        else:  # biases and trainable tensors
            value = torch.zeros(param.shape)
        param.copy_(value)
