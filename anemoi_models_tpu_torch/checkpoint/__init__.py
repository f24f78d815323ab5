"""Checkpoint save and restore.

Counterpart of ``anemoi_models_tpu/checkpoint/__init__.py``. A checkpoint is
a directory:

- ``arrays.pt``: ``{"params": the model's state dict, "processor_state":
  ..., "opt_state": the optimizer's state dict}`` (the last two only when
  given), written with ``torch.save`` and read with ``torch.load(...,
  weights_only=True)``, so loading runs no pickled code. The JAX package
  writes its arrays with orbax under ``arrays/`` instead;
- ``meta.json``: ``step``, ``metadata``, ``config``, ``run_id`` and
  ``format_version``, the JAX package's fields;
- ``supporting_arrays.npz``: as the JAX package lays it out.

:func:`load_checkpoint` reads either package's directory, choosing the
reader by what it holds: ``arrays.pt`` (the port's) or ``arrays/_METADATA``
(the JAX package's, through :func:`load_jax_checkpoint`, which needs
``tensorstore`` and nothing of JAX). :func:`load_jax_opt_state` maps a JAX
run's optax state (AdamW moments and count) onto the port's ``AdamW``, so a
JAX run resumes in the port.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["FORMAT_VERSION", "load_checkpoint", "load_jax_checkpoint", "load_jax_opt_state", "save_checkpoint"]

# The JAX package's format history: 1, the first layout; 2, the forward
# mapper's emb_nodes_src moved into the block ('proc') scope. The port writes
# 2; weights.load_flax_params takes emb_nodes_src in either scope, so a
# format-1 JAX checkpoint loads too.
FORMAT_VERSION = 2
_ARRAYS = "arrays.pt"


def _atomic_write(path: str, write) -> None:
    """``write(tmp_path)``, then a rename over ``path``: a reader never sees a
    half-written file."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(
    path: str,
    *,
    params: dict,
    processor_state: Optional[dict] = None,
    opt_state: Optional[dict] = None,
    step: Optional[int] = None,
    metadata: Optional[dict] = None,
    config: Optional[dict] = None,
    supporting_arrays: Optional[dict] = None,
    run_id: Optional[str] = None,
) -> str:
    """Write a checkpoint directory; returns its absolute path. ``params`` is
    a state dict, ``opt_state`` an optimizer's ``state_dict()``; tensors are
    saved from the CPU, so the checkpoint loads on any device."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tree: dict[str, Any] = {"params": {k: v.detach().cpu() for k, v in params.items()}}
    if processor_state:
        tree["processor_state"] = processor_state
    if opt_state is not None:
        tree["opt_state"] = opt_state
    _atomic_write(os.path.join(path, _ARRAYS), lambda tmp: torch.save(tree, tmp))

    sidecar = {
        "step": step,
        "metadata": metadata or {},
        "config": config or {},
        "run_id": run_id,
        "format_version": FORMAT_VERSION,
    }

    def write_meta(tmp: str) -> None:
        with open(tmp, "w") as fh:
            json.dump(sidecar, fh, default=str)

    _atomic_write(os.path.join(path, "meta.json"), write_meta)
    if supporting_arrays:
        def write_npz(tmp: str) -> None:
            with open(tmp, "wb") as fh:  # a file object: np.savez would add ".npz" to a name
                np.savez(fh, **supporting_arrays)

        _atomic_write(os.path.join(path, "supporting_arrays.npz"), write_npz)
    return path


def _sidecars(path: str, out: dict) -> dict:
    """``out`` with meta.json's fields and the supporting arrays added."""
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            out.update(json.load(fh))
    sup_path = os.path.join(path, "supporting_arrays.npz")
    if os.path.exists(sup_path):
        with np.load(sup_path) as z:
            out["supporting_arrays"] = {k: z[k] for k in z.files}
    return out


def load_checkpoint(path: str) -> dict:
    """Read a checkpoint directory of either package into a dict: ``params``
    (the port's state dict, or the JAX package's flax tree), ``processor_state``
    and ``opt_state`` where saved, meta.json's fields and
    ``supporting_arrays``."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, _ARRAYS)):
        out = dict(torch.load(os.path.join(path, _ARRAYS), map_location="cpu", weights_only=True))
        return _sidecars(path, out)
    if os.path.exists(os.path.join(path, "arrays", "_METADATA")):
        return load_jax_checkpoint(path)
    raise FileNotFoundError(f"{path!r} holds no checkpoint: neither {_ARRAYS} nor arrays/_METADATA")


def _leaf(value: np.ndarray) -> Any:
    """numpy, except bf16 (``ml_dtypes.bfloat16``, which torch cannot take
    from numpy): a torch.bfloat16 tensor through a uint16 view."""
    if value.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(value).view(np.uint16)).view(torch.bfloat16)
    return value


def load_jax_checkpoint(path: str) -> dict:
    """Read a checkpoint that the JAX package wrote (orbax: OCDBT + zarr
    under ``arrays/``) without JAX: the same keys as its ``load_checkpoint``,
    the trees as nested dicts (lists where the tree held a sequence, ``None``
    where it held ``None``) of numpy arrays, bf16 leaves as torch.bfloat16
    tensors. The optimizer state is returned as it was stored; it is not
    mapped onto the port's optimizer. Needs the ``tensorstore`` package."""
    try:
        import tensorstore as ts
    except ImportError as exc:
        raise ImportError("reading a JAX package checkpoint needs the 'tensorstore' package") from exc

    path = os.path.abspath(path)
    arrays = os.path.join(path, "arrays")
    with open(os.path.join(arrays, "_METADATA")) as fh:
        meta = json.load(fh)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    base = f"file://{arrays}" if meta.get("use_ocdbt", True) else None
    out: dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        is_index = [k["key_type"] == 1 for k in entry["key_metadata"]]
        value = None
        if entry["value_metadata"]["value_type"] != "None":
            name = ".".join(keys)
            kvstore = ({"driver": "ocdbt", "base": base, "path": name + "/"} if base
                       else {"driver": "file", "path": os.path.join(arrays, name)})
            value = _leaf(np.asarray(ts.open({"driver": driver, "kvstore": kvstore}).result().read().result()))
        node: Any = out
        for i, key in enumerate(keys):
            last = i == len(keys) - 1
            if is_index[i]:
                idx = int(key)
                node.extend([None] * (idx + 1 - len(node)))
                if last:
                    node[idx] = value
                elif node[idx] is None:
                    node[idx] = [] if is_index[i + 1] else {}
                node = node[idx]
            else:
                if last:
                    node[key] = value
                else:
                    node = node.setdefault(key, [] if is_index[i + 1] else {})
    return _sidecars(path, out)


def _adam_state(tree: Any) -> Optional[dict]:
    """The first node of an optax state tree (nested dicts and lists) that
    holds Adam's ``mu``, ``nu`` and ``count``."""
    if isinstance(tree, dict):
        if {"mu", "nu", "count"} <= tree.keys():
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    return next((found for child in children if (found := _adam_state(child)) is not None), None)


def load_jax_opt_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module, opt_state: Any) -> None:
    """Load the optax state of the JAX package's ``make_optimizer`` chain
    (``clip_by_global_norm`` then ``adamw``; as :func:`load_jax_checkpoint`
    returns it) into the port's ``AdamW`` over ``model``'s parameters: each
    parameter's ``mu`` and ``nu`` from the flax moment trees (mapped to the
    port's names and layouts as the parameters are) and the update count."""
    from anemoi_models_tpu_torch.weights import load_flax_params

    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam moments (mu, nu, count)")
    mu, nu = load_flax_params(adam["mu"]), load_flax_params(adam["nu"])
    with torch.no_grad():
        for name, p in model.named_parameters():
            state = optimizer.state[p]
            state["mu"] = torch.as_tensor(mu[name]).to(p.device, p.dtype).clone()
            state["nu"] = torch.as_tensor(nu[name]).to(p.device, p.dtype).clone()
    optimizer.count = int(np.asarray(adam["count"]))
