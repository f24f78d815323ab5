"""Memory policies of a train step: what a remat unit keeps on the device
between its forward and its backward.

Counterpart of ``_remat`` in ``anemoi_models_tpu/layers/processor.py``, of the
mappers' ``nn.remat`` (``layers/mapper.py``) and of ``HaloGNNProcessor``'s
per-layer ``jax.checkpoint``. A unit (a processor chunk, a mapper block, a
``HaloGNNProcessor`` layer) runs through :func:`run_unit`; while gradients
are recorded its policy decides what stays:

- ``"full"``: non-reentrant ``torch.utils.checkpoint``. Only the unit's
  inputs stay; its forward runs again in the backward, collectives and
  dropout draws included (the recompute draws the forward's masks).
- ``"save_dots"``: the same checkpoint with a selective policy
  (:func:`save_dots_policy`): the outputs of the 2-D matrix products
  (``aten.mm``, ``aten.addmm``) stay and everything else is recomputed, as
  JAX's ``dots_with_no_batch_dims_saveable``; ``aten.bmm`` and
  ``aten.baddbmm`` carry a batch dimension and are recomputed. The
  hand-written kernels are extension calls inside ``torch.autograd.Function``s
  that the dispatch mode does not see as products: they are recomputed, as a
  Pallas call is not a dot to JAX.
- ``"none"``: no checkpoint; every saved activation stays.
- ``"auto"``: ``"full"`` at the layer, as the JAX processors take it;
  ``training.run.train_run`` resolves it from the step's memory first
  (``training.step.resolve_remat_policy``).
- ``cpu_offload=True`` overrides the policy, as JAX's ``_remat`` does: the
  unit runs once and every activation its operations save waits in pinned
  host memory until the backward copies it back (:func:`offload_saved`),
  the upstream reference's ``offload_wrapper``. The JAX package keeps only
  the dots on the host and recomputes the rest; the values and gradients are
  the same either way.
"""

from __future__ import annotations

import contextlib
import itertools
import weakref
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

__all__ = ["REMAT_POLICIES", "OFFLOADED", "check_policy", "count_saved_bytes", "offload_saved", "run_unit",
           "save_dots_policy"]

REMAT_POLICIES = ("full", "save_dots", "none", "auto")
# the 2-D products whose outputs "save_dots" keeps
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# host copies made by cpu_offload since the caller last set these to 0
OFFLOADED = {"tensors": 0, "bytes": 0}
# set by count_saved_bytes: units run their forward once, unchecked, so that
# its hook sees every tensor a step without rematerialisation would keep
_COUNTING = [False]


def check_policy(remat_policy: str) -> str:
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {remat_policy!r}")
    return remat_policy


def save_dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the outputs of 2-D matrix products, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots_context():
    return create_selective_checkpoint_contexts(save_dots_policy)


def _kept_storages(owner: nn.Module) -> set[int]:
    return {t.untyped_storage().data_ptr() for t in itertools.chain(owner.parameters(), owner.buffers())}


@contextlib.contextmanager
def offload_saved(owner: nn.Module):
    """Every floating-point tensor an operation saves for the backward inside
    this context goes to host memory (pinned for a CUDA tensor) and comes
    back to its device, with its strides, when the backward reads it.

    Kept on the device: ``owner``'s parameters and buffers and views of them,
    and integer tensors (CSR and shard tables). A broadcast dimension
    (stride 0, as ``expand`` makes) is stored once and expanded again."""
    kept = _kept_storages(owner)

    def pack(t: torch.Tensor):
        if not t.is_floating_point() or t.untyped_storage().data_ptr() in kept:
            return t
        base = t
        for dim in range(t.dim()):
            if t.stride(dim) == 0 and t.shape[dim] > 1:
                base = base.narrow(dim, 0, 1)
        host = torch.empty_like(base, device="cpu", pin_memory=t.is_cuda)
        host.copy_(base, non_blocking=t.is_cuda)
        OFFLOADED["tensors"] += 1
        OFFLOADED["bytes"] += host.untyped_storage().nbytes()
        return host, t.device, t.shape, base.stride()

    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        host, device, shape, stride = packed
        out = torch.empty_strided(host.shape, stride, dtype=host.dtype, device=device)
        out.copy_(host, non_blocking=out.is_cuda)
        return out.expand(shape)

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


def run_unit(fn: Callable, *args, remat_policy: str, cpu_offload: bool, owner: nn.Module):
    """``fn(*args)`` as a remat unit under ``remat_policy`` (or
    ``cpu_offload``, which overrides it; ``owner``'s parameters and buffers
    stay on the device) while gradients are recorded; ``fn(*args)`` else."""
    if not torch.is_grad_enabled() or _COUNTING[0]:
        return fn(*args)
    if cpu_offload:
        with offload_saved(owner):
            return fn(*args)
    if remat_policy == "none":
        return fn(*args)
    if remat_policy == "save_dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_save_dots_context)
    return checkpoint(fn, *args, use_reentrant=False)


@contextlib.contextmanager
def count_saved_bytes(owner: nn.Module):
    """Yields a dict whose ``"bytes"`` adds up the bytes of every storage
    that an operation inside the context saves for the backward, once a
    storage and but ``owner``'s parameters and buffers, and keeps none of
    them: a forward under it holds no more memory than one without
    gradients. Every remat unit runs unchecked inside, so the count
    is what a step with no rematerialisation keeps (a mapper's activations
    included, which a step keeps only while it recomputes that mapper)."""
    total = {"bytes": 0}
    live: dict[int, weakref.ref] = {}
    kept = _kept_storages(owner)

    def pack(t: torch.Tensor):
        storage = t.untyped_storage()
        ptr = storage.data_ptr()
        if ptr in kept:
            return None
        seen = live.get(ptr)
        if seen is None or seen() is None:  # a new storage, or a freed one's address again
            total["bytes"] += storage.nbytes()
            live[ptr] = weakref.ref(t)
        return None

    def unpack(_):
        raise RuntimeError("count_saved_bytes keeps no tensor: its forward cannot run a backward")

    _COUNTING[0] = True
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield total
    finally:
        _COUNTING[0] = False
