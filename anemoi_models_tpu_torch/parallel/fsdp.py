"""Parameter and optimizer-state sharding (ZeRO-1 and FSDP).

Counterpart of ``anemoi_models_tpu/parallel/fsdp.py``. The JAX package
states the memory optimisation as shardings and lets GSPMD insert the
collectives; PyTorch has no GSPMD, so the port writes the dataflow out, with
the JAX package's leaf rule (:func:`_leaf_spec`): a leaf of at least
``DEFAULT_MIN_SIZE`` elements is split along its largest dimension that the
axis size divides, every other leaf stays replicated. A :class:`ShardPlan`
records, for each parameter, which dimension is split over which axis, and
applies it:

- ``"zero1"``: the parameters stay replicated. Each rank holds its slice of
  the AdamW moments, updates its slice of each parameter after the gradient
  reduction (:meth:`ShardPlan.views`), then all-gathers the updated
  slices over the axis (:meth:`ShardPlan.sync_params`).
- ``"fsdp"``: the parameters, the moments and the EMA are sharded. A
  module that owns sharded parameters reads each of them whole: reading the
  attribute all-gathers it (:meth:`ShardPlan.attach`), so a full weight
  lives only while the code that read it holds it, and is gathered again in
  the recompute of remat ``"full"``. The gather's adjoint sums the ranks'
  gradients of the full weight over the axis and keeps the rank's slice: an
  all-reduce then a slice, since gloo has no reduce-scatter on CUDA tensors.

The axis is ``"data"`` (classic ZeRO / FSDP over the data-parallel
replicas) or ``"model"``. A checkpoint of a sharded run is written in the
unsharded format (:meth:`ShardPlan.gathered`), as orbax gathers on save, so
it loads unchanged in an unsharded run, a sharded resume or ``predict``.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn

from anemoi_models_tpu_torch.parallel.api import Mesh, use_mesh
from anemoi_models_tpu_torch.parallel.primitives import gather_tensor, reduce_tensor, sync_tensor

__all__ = [
    "DEFAULT_MIN_SIZE",
    "ShardPlan",
    "array_shardings",
    "shard_train_state",
    "train_state_shardings",
]

# leaves smaller than this many elements stay replicated: sharding biases and
# LayerNorm scales buys nothing and costs collective launches
DEFAULT_MIN_SIZE = 2**15
MODES = ("zero1", "fsdp")


def _leaf_spec(shape: tuple, axis_size: int, axis_name: str, min_size: int) -> tuple:
    """The leaf's spec, as the JAX package's ``PartitionSpec`` reads as a
    tuple: ``axis_name`` at the largest dimension divisible by
    ``axis_size`` (the first of equal ones), ``()`` (replicated) if none
    qualifies or the leaf is small."""
    if int(np.prod(shape, dtype=np.int64)) < min_size:
        return ()
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if shape[d] % axis_size == 0 and shape[d] >= axis_size:
            spec = [None] * len(shape)
            spec[d] = axis_name
            return tuple(spec)
    return ()


def array_shardings(tree: Mapping[str, torch.Tensor], mesh: Mesh, axis: str = "data",
                    min_size: Optional[int] = None, replicate: bool = False) -> dict[str, tuple]:
    """The spec of each leaf of ``tree`` (name -> tensor) over ``axis``;
    ``replicate`` gives every leaf ``()``."""
    min_size = DEFAULT_MIN_SIZE if min_size is None else min_size
    axis_size = int(mesh.shape[axis])

    def spec(leaf: torch.Tensor) -> tuple:
        if replicate or leaf.dim() == 0 or axis_size == 1:
            return ()
        return _leaf_spec(tuple(leaf.shape), axis_size, axis, min_size)

    return {name: spec(leaf) for name, leaf in tree.items()}


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"param sharding mode {mode!r}: expected 'zero1' or 'fsdp'")


def train_state_shardings(model: nn.Module, mesh: Mesh, mode: str = "zero1", axis: str = "data",
                          min_size: Optional[int] = None) -> dict[str, dict[str, tuple]]:
    """The specs of a train state: ``{"params": ..., "opt_state": ...}``, by
    parameter name; the moments ``mu`` and ``nu`` of a parameter share its
    ``opt_state`` spec, the update count is replicated. ``"zero1"``
    replicates the parameters, ``"fsdp"`` shards them as the moments."""
    check_mode(mode)
    params = dict(model.named_parameters())
    return {"params": array_shardings(params, mesh, axis, min_size, replicate=mode == "zero1"),
            "opt_state": array_shardings(params, mesh, axis, min_size)}


_GATHERING: dict[type, type] = {}


def _gathering_class(cls: type) -> type:
    """``cls`` whose attribute lookup returns a sharded parameter whole
    (:meth:`ShardPlan.read`) while its plan is not inside ``gathered``."""
    if cls in _GATHERING.values():
        return cls
    if cls not in _GATHERING:
        def __getattr__(self, name: str):
            value = cls.__getattr__(self, name)
            plan = self.__dict__.get("_fsdp_plan")
            if plan is not None and not plan.full and isinstance(value, nn.Parameter) and id(value) in plan.dims:
                return plan.read(value)
            return value

        _GATHERING[cls] = type(cls.__name__, (cls,), {"__getattr__": __getattr__, "__module__": cls.__module__,
                                                      "__qualname__": cls.__qualname__})
    return _GATHERING[cls]


class ShardPlan:
    """Which dimension of each parameter is split over ``axis`` (``dims``:
    parameter -> dimension, for the sharded ones only), and the functions
    that apply the split. Made by :func:`shard_train_state`."""

    def __init__(self, model: nn.Module, mesh: Mesh, mode: str, axis: str, min_size: Optional[int]) -> None:
        check_mode(mode)
        if axis not in ("data", "model"):
            raise ValueError(f"param_sharding_axis must be 'data' or 'model', got {axis!r}")
        self.mesh, self.mode, self.axis = mesh, mode, axis
        self.size, self.index = mesh.shape[axis], mesh.coords[axis]
        specs = train_state_shardings(model, mesh, mode, axis, min_size)["opt_state"]
        params = dict(model.named_parameters())
        self.dims: dict[int, int] = {id(params[n]): spec.index(axis) for n, spec in specs.items() if spec}
        self.by_name = {n: self.dims[id(p)] for n, p in params.items() if id(p) in self.dims}
        self.full = False  # inside gathered(): the fsdp parameters hold their full values

    # -- slices ----------------------------------------------------------
    def dim_of(self, p: torch.Tensor) -> Optional[int]:
        return self.dims.get(id(p))

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim`` (a view; the leaf rule
        splits only dimensions the axis size divides)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    def gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's slice along ``dim``, in rank order: the full leaf
        (``primitives.gather_tensor``; no gradient flows through it here)."""
        with use_mesh(self.mesh):
            return gather_tensor(shard, dim, self.axis, size=shard.shape[dim] * self.size)

    def read(self, p: torch.Tensor) -> torch.Tensor:
        """A sharded parameter whole, for the code that reads it: the
        all-gather of ``primitives.sync_tensor``, whose adjoint sums the
        ranks' gradients of the whole leaf (fp32) and keeps this rank's slice
        (an all-reduce, then a slice: gloo has no reduce-scatter on CUDA
        tensors)."""
        dim = self.dims[id(p)]
        with use_mesh(self.mesh):
            return sync_tensor(p, dim, self.axis, size=p.shape[dim] * self.size)

    # -- placement -------------------------------------------------------
    @torch.no_grad()
    def place(self, model: nn.Module, optimizer: torch.optim.Optimizer,
              ema: Optional[dict[str, torch.Tensor]] = None) -> Optional[dict[str, torch.Tensor]]:
        """Cut the state to this rank's slices: the moments already held (a
        resumed run's), and under ``"fsdp"`` the parameters and the EMA;
        attach the plan to ``optimizer`` and, under ``"fsdp"``, to ``model``
        (:meth:`attach`). Returns the EMA as this rank holds it."""
        for p in (q for group in optimizer.param_groups for q in group["params"]):
            dim = self.dim_of(p)
            if dim is None:
                continue
            state = optimizer.state.get(p) or {}
            for key in ("mu", "nu"):
                if key in state:
                    state[key] = self.own(state[key], dim).clone()
            if self.mode == "fsdp":
                p.data = self.own(p.data, dim).clone()
        optimizer.plan = self
        if self.mode == "fsdp":
            self.attach(model)
            if ema is not None:
                ema = {k: self.own(v, self.by_name[k]).clone() if k in self.by_name else v for k, v in ema.items()}
        return ema

    def attach(self, model: nn.Module) -> None:
        """Under ``"fsdp"``: every module of ``model`` that owns sharded
        parameters (a ``ParameterDict`` too) reads them whole: its class
        becomes a subclass whose attribute lookup all-gathers a sharded
        parameter, with the gather's adjoint in the graph. The optimizer,
        ``state_dict`` and ``named_parameters`` still see the shards. Call it
        for each module tree that runs the parameters (a dropout twin too)."""
        for module in model.modules():
            if any(id(p) in self.dims for p in module.parameters(recurse=False)):
                module.__dict__["_fsdp_plan"] = self
                module.__class__ = _gathering_class(type(module))

    # -- the step --------------------------------------------------------
    def views(self, params: list[torch.Tensor]) -> list[torch.Tensor]:
        """Under ``"zero1"``: what this rank updates of each parameter, its
        slice (a view) or the whole replicated leaf; else the parameters."""
        if self.mode != "zero1":
            return params
        return [p if (d := self.dim_of(p)) is None else self.own(p, d) for p in params]

    def grad_views(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> list[torch.Tensor]:
        if self.mode != "zero1":
            return grads
        return [g if (d := self.dim_of(p)) is None else self.own(g, d) for p, g in zip(params, grads)]

    @torch.no_grad()
    def global_norm(self, params: list[torch.Tensor], norms: list[torch.Tensor]) -> torch.Tensor:
        """Under ``"fsdp"``: the norm of the whole gradient from each leaf's
        norm, the sharded leaves' squares summed over the axis."""
        sq = torch.stack(norms).float() ** 2
        sharded = torch.tensor([self.dim_of(p) is not None for p in params], device=sq.device)
        with use_mesh(self.mesh):
            part = reduce_tensor(torch.where(sharded, sq, 0.0).sum(), self.axis)
        return torch.sqrt(part + torch.where(sharded, 0.0, sq).sum())

    @torch.no_grad()
    def sync_params(self, params) -> None:
        """Under ``"zero1"``, after the update of each rank's slices: every
        sharded parameter all-gathered whole on every rank."""
        if self.mode != "zero1":
            return
        for p in params:
            dim = self.dim_of(p)
            if dim is not None:
                p.copy_(self.gather(self.own(p, dim), dim))

    # -- the unsharded format --------------------------------------------
    @contextmanager
    def gathered(self, optimizer: torch.optim.Optimizer,
                 ema: Optional[dict[str, torch.Tensor]] = None) -> Iterator[Optional[dict[str, torch.Tensor]]]:
        """The run's state whole for the body of the block (a checkpoint, an
        evaluation): the moments, and under ``"fsdp"`` the parameters (read
        as they are, with no gather); yields the EMA whole. Every rank enters
        it: the gathers are collectives."""
        held = []
        with torch.no_grad():
            for p in (q for group in optimizer.param_groups for q in group["params"]):
                dim = self.dim_of(p)
                if dim is None:
                    continue
                state = optimizer.state.get(p) or {}
                moments = {k: state[k] for k in ("mu", "nu") if k in state}
                held.append((p, p.data, state, moments))
                for k, v in moments.items():
                    state[k] = self.gather(v, dim)
                if self.mode == "fsdp":
                    p.data = self.gather(p.data, dim)
            if ema is not None and self.mode == "fsdp":
                ema = {k: self.gather(v, self.by_name[k]) if k in self.by_name else v for k, v in ema.items()}
        self.full = True
        try:
            yield ema
        finally:
            self.full = False
            for p, data, state, moments in held:
                p.data = data
                state.update(moments)


def shard_train_state(model: nn.Module, optimizer: torch.optim.Optimizer, mesh: Mesh, mode: str = "zero1",
                      axis: str = "data", min_size: Optional[int] = None,
                      ema: Optional[dict[str, torch.Tensor]] = None) -> tuple[ShardPlan, Optional[dict]]:
    """Shard ``model``'s train state over ``mesh``'s ``axis`` as ``mode``
    says (see the module docstring); returns ``(plan, ema)``, the EMA as
    this rank holds it (replicated under ``"zero1"``, sharded under
    ``"fsdp"``, as the JAX package's ``shard_train_state`` places it). Pass
    the plan to the train step (``make_train_step(..., plan=plan)``)."""
    plan = ShardPlan(model, mesh, mode, axis, min_size)
    return plan, plan.place(model, optimizer, ema)
