"""The (data, model) grid of ranks and its ambient context.

Counterpart of ``make_mesh`` / ``set_mesh`` / ``get_mesh`` / ``use_mesh`` in
``anemoi_models_tpu/parallel/api.py``. The JAX package lays a
``jax.sharding.Mesh`` over its devices and lets GSPMD insert the collectives
(``constrain``). PyTorch has no GSPMD, so the port states the dataflow
explicitly: every rank holds its own rows of every node set, and each
collective is a call in :mod:`~anemoi_models_tpu_torch.parallel.primitives`
with its autograd adjoint. ``constrain`` has no counterpart: where the JAX
code calls it, the port's layout is already explicit.

Axis convention, as in the JAX package:

- ``data``: the batch (and ensemble) axis, one model replica per data index;
- ``model``: the node rows of one model instance, split contiguously over
  the model axis, ``ceil(N / model)`` rows a rank and the remainder on the
  last (the equal-pad split GSPMD and ``graphs.partition.partition_1hop``
  use).

Rank ``r`` of the default process group sits at ``(r // model, r % model)``
(the JAX package's row-major ``reshape(data, model)``). Nothing on a machine
tells a program of a cluster: the caller initialises
``torch.distributed`` with its address, world size and rank, then builds
the mesh with the same backend. ``gloo`` runs on the CPU, and on CUDA
tensors for the collectives the port uses (all-gather, all-reduce,
broadcast); ``nccl`` needs a card of its own for each rank. The backend is
never chosen behind the caller's back: a backend that cannot run a
collective on a tensor's device raises.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "get_mesh", "hybrid_rank_grid", "make_hybrid_mesh", "make_mesh", "model_sharded", "row_range",
           "set_mesh", "use_mesh"]

BACKENDS = ("gloo", "nccl")

_MESH: Optional["Mesh"] = None


def row_range(num_rows: int, shards: int, index: int) -> tuple[int, int]:
    """``[lo, hi)``: shard ``index``'s rows of ``num_rows`` split
    contiguously over ``shards``, ``ceil(num_rows / shards)`` a shard, the
    last holding the remainder (possibly none)."""
    per = -(-num_rows // shards)
    lo = min(index * per, num_rows)
    return lo, min(lo + per, num_rows)


class Mesh:
    """A (data, model) grid over the ranks of the default process group.

    ``groups[axis]`` is the process group of this rank's line along
    ``axis`` (None where the axis has size 1), ``coords[axis]`` this rank's
    index on it. ``device`` is where this rank's tensors live."""

    def __init__(self, data: int, model: int, backend: str, device: torch.device) -> None:
        self.shape = {"data": data, "model": model}
        self.backend = backend
        self.device = device
        self.rank = dist.get_rank()
        self.coords = {"data": self.rank // model, "model": self.rank % model}
        self.groups: dict[str, Optional[dist.ProcessGroup]] = {"data": None, "model": None}
        # every rank creates every group, in one order (torch.distributed.new_group's rule)
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            group = dist.new_group(ranks, backend=backend) if model > 1 else None
            if d == self.coords["data"]:
                self.groups["model"] = group
        for m in range(model):
            ranks = [d * model + m for d in range(data)]
            group = dist.new_group(ranks, backend=backend) if data > 1 else None
            if m == self.coords["model"]:
                self.groups["data"] = group

    def rows(self, num_rows: int, axis: str = "model") -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``num_rows`` rows split over ``axis``."""
        return row_range(num_rows, self.shape[axis], self.coords[axis])

    def check_device(self, t: torch.Tensor) -> None:
        """Raise unless this mesh's backend runs collectives on ``t``'s device."""
        if self.backend == "nccl" and t.device.type != "cuda":
            raise ValueError(f"the nccl backend runs collectives on CUDA tensors only, got one on {t.device}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no collective of backend {self.backend!r} for a tensor on {t.device}")

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, backend={self.backend!r}, " \
               f"rank={self.rank}, device={self.device})"


def make_mesh(data: int = 1, model: int = 1, *, backend: str, device="cuda") -> Mesh:
    """The (data, model) mesh over the default process group, which the
    caller has initialised with ``backend`` and ``data * model`` ranks.
    ``device``: where this rank's tensors live (``"cuda"``, a card of its
    own per rank for ``nccl``; ``"cpu"`` with ``gloo`` only)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call init_process_group(backend, "
                           "init_method='tcp://localhost:<port>', world_size=..., rank=...) first")
    if dist.get_backend() != backend:
        raise ValueError(f"the default process group runs {dist.get_backend()!r}, not {backend!r}")
    if data < 1 or model < 1 or data * model != dist.get_world_size():
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, the process group has "
                         f"{dist.get_world_size()}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: build the mesh with device='cpu' to run it on the CPU")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    return Mesh(data, model, backend, device)


def hybrid_rank_grid(dcn_data: int, ici_data: int = 1, model: int = 1) -> np.ndarray:
    """The ranks of :func:`make_hybrid_mesh`'s grid, (dcn_data ici_data,
    model): consecutive ranks form a model group and the two data factors
    flatten into one ``data`` axis, the JAX package's device order where the
    devices have no slice topology (``parallel/api.py:make_hybrid_mesh``)."""
    return np.arange(dcn_data * ici_data * model).reshape(dcn_data * ici_data, model)


def make_hybrid_mesh(dcn_data: int, ici_data: int = 1, model: int = 1, *, backend: str, device="cuda") -> Mesh:
    """The multi-host (data, model) mesh: the data axis spans the hosts
    (``dcn_data``) and the ranks of a host (``ici_data``), the model axis
    stays among consecutive ranks, the ones a host's fast links join
    (:func:`hybrid_rank_grid`). One host has no slice topology to lay it
    on, so this is the JAX package's branch for devices without one; raises
    by name when the process group has fewer ranks than the grid."""
    n = dcn_data * ici_data * model
    if dist.is_initialized() and dist.get_world_size() < n:
        raise ValueError(f"hybrid mesh needs {n} ranks, have {dist.get_world_size()}")
    return make_mesh(dcn_data * ici_data, model, backend=backend, device=device)


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install (or clear, with None) the ambient mesh."""
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


@contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Scoped mesh installation."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def model_sharded() -> Optional[Mesh]:
    """The ambient mesh if its ``model`` axis splits node rows (size > 1),
    else None: the condition under which the layers take their sharded
    paths, as the JAX layers test ``mesh.shape["model"] > 1``."""
    mesh = _MESH
    return mesh if mesh is not None and mesh.shape["model"] > 1 else None
