"""Explicit collectives with their autograd adjoints.

Counterpart of ``anemoi_models_tpu/parallel/primitives.py`` (the reference's
``distributed/graph.py`` and ``distributed/primitives.py``). Under GSPMD the
JAX package states these as sharding constraints and JAX derives the
adjoints; here each is an ``autograd.Function`` whose backward is written
out, in the reference's pairing:

- :func:`shard_tensor`: split, adjoint gather;
- :func:`gather_tensor`: gather, adjoint split (the consumer is replicated:
  every rank computes the same function of the gathered tensor);
- :func:`sync_tensor`: gather, adjoint reduce (sum) and re-shard (each
  rank computes a different function of it: its own destinations);
- :func:`reduce_shard_tensor`: reduce (sum) and shard, adjoint gather;
- :func:`reduce_tensor`: an fp32 all-reduce (sum), adjoint the identity.

Rows split as :func:`~anemoi_models_tpu_torch.parallel.api.row_range` says.
Every adjoint is built of all-gathers and all-reduces only, which gloo runs
on CUDA tensors as well as on the CPU (it has no ``send`` / ``recv`` for
CUDA tensors). Sums run in fp32, in the backend's fixed order. Each
primitive is the identity when no mesh is active or its axis has size 1.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

from anemoi_models_tpu_torch.parallel.api import Mesh, get_mesh, row_range

__all__ = [
    "all_reduce_gradients",
    "change_channels_in_shape",
    "gather_tensor",
    "get_shape_shards",
    "reduce_shard_tensor",
    "reduce_tensor",
    "shard_tensor",
    "sync_tensor",
]


def _active(axis: str) -> Optional[Mesh]:
    mesh = get_mesh()
    return mesh if mesh is not None and mesh.shape[axis] > 1 else None


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    mesh.check_device(x)
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, x, group=mesh.groups[axis])
    return out


def _all_reduce_f32(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, taken in fp32, in x's dtype."""
    mesh.check_device(x)
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=mesh.groups[axis])
    return y.to(x.dtype)


def _counts(total: int, shards: int) -> list[int]:
    return [hi - lo for lo, hi in (row_range(total, shards, i) for i in range(shards))]


def _total(n_local: int, mesh: Mesh, axis: str, device: torch.device) -> int:
    """The rows of all ranks on ``axis`` together, from each rank's count."""
    t = torch.tensor([n_local], dtype=torch.int64, device=device)
    mesh.check_device(t)
    dist.all_reduce(t, group=mesh.groups[axis])
    return int(t.item())


def _gather_rows(x: torch.Tensor, dim: int, mesh: Mesh, axis: str, counts: list[int]) -> torch.Tensor:
    """Every rank's rows along ``dim``, in rank order; ranks hold ``counts``."""
    per = max(counts)
    pad = per - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    parts = _all_gather(x, mesh, axis)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, counts)], dim=dim)


def _own_rows(x: torch.Tensor, dim: int, mesh: Mesh, axis: str) -> torch.Tensor:
    lo, hi = mesh.rows(x.shape[dim], axis)
    return x.narrow(dim, lo, hi - lo).contiguous()


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, axis: str, mesh: Mesh):
        ctx.dim, ctx.axis, ctx.mesh, ctx.n = dim, axis, mesh, x.shape[dim]
        return _own_rows(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        counts = _counts(ctx.n, ctx.mesh.shape[ctx.axis])
        return _gather_rows(g, ctx.dim, ctx.mesh, ctx.axis, counts), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, axis: str, mesh: Mesh, total: int):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        return _gather_rows(x, dim, mesh, axis, _counts(total, mesh.shape[axis]))

    @staticmethod
    def backward(ctx, g):
        return _own_rows(g, ctx.dim, ctx.mesh, ctx.axis), None, None, None, None


class _Sync(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, axis: str, mesh: Mesh, total: int):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        return _gather_rows(x, dim, mesh, axis, _counts(total, mesh.shape[axis]))

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_f32(g, ctx.mesh, ctx.axis)
        return _own_rows(g, ctx.dim, ctx.mesh, ctx.axis), None, None, None, None


class _ReduceShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, axis: str, mesh: Mesh):
        ctx.dim, ctx.axis, ctx.mesh, ctx.n = dim, axis, mesh, x.shape[dim]
        return _own_rows(_all_reduce_f32(x, mesh, axis), dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        counts = _counts(ctx.n, ctx.mesh.shape[ctx.axis])
        return _gather_rows(g, ctx.dim, ctx.mesh, ctx.axis, counts), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: str, mesh: Mesh):
        return _all_reduce_f32(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def shard_tensor(x: torch.Tensor, dim: int = 0, axis: str = "model") -> torch.Tensor:
    """This rank's rows of ``x`` along ``dim``; the adjoint gathers."""
    mesh = _active(axis)
    return x if mesh is None else _Shard.apply(x, dim % x.dim(), axis, mesh)


def gather_tensor(x: torch.Tensor, dim: int = 0, axis: str = "model", size: Optional[int] = None) -> torch.Tensor:
    """Every rank's rows of ``x`` along ``dim`` (``size`` of them together;
    counted with one all-reduce when not given); the adjoint takes this
    rank's rows of the (replicated) cotangent."""
    mesh = _active(axis)
    if mesh is None:
        return x
    dim = dim % x.dim()
    return _Gather.apply(x, dim, axis, mesh, size if size is not None else _total(x.shape[dim], mesh, axis, x.device))


def sync_tensor(x: torch.Tensor, dim: int = 0, axis: str = "model", size: Optional[int] = None) -> torch.Tensor:
    """As :func:`gather_tensor`, for a consumer that differs by rank: the
    adjoint sums the ranks' cotangents (fp32) and takes this rank's rows."""
    mesh = _active(axis)
    if mesh is None:
        return x
    dim = dim % x.dim()
    return _Sync.apply(x, dim, axis, mesh, size if size is not None else _total(x.shape[dim], mesh, axis, x.device))


def reduce_shard_tensor(x: torch.Tensor, dim: int = 0, axis: str = "model") -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial ``x``, then this rank's
    rows; the adjoint gathers."""
    mesh = _active(axis)
    return x if mesh is None else _ReduceShard.apply(x, dim % x.dim(), axis, mesh)


def reduce_tensor(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """All-reduce (sum) over ``axis`` in fp32, returned in x's dtype; the
    adjoint passes the cotangent through, as the reference's does."""
    mesh = _active(axis)
    return x if mesh is None else _Reduce.apply(x, axis, mesh)


def get_shape_shards(x: torch.Tensor, dim: int, num_shards: int) -> list[tuple[int, ...]]:
    """Per-shard shapes under ``tensor_split`` semantics (reference
    ``distributed/shapes.py:19-24``)."""
    base, rem = divmod(x.shape[dim], num_shards)
    shapes = []
    for i in range(num_shards):
        size = base + (1 if i < rem else 0)
        shapes.append(tuple(size if d == dim else s for d, s in enumerate(x.shape)))
    return shapes


def change_channels_in_shape(shapes: list[tuple[int, ...]], channels: int) -> list[tuple[int, ...]]:
    """Swap the channel (last) dim of every shard shape (reference
    ``shapes.py:27-29``)."""
    return [tuple(list(s[:-1]) + [channels]) for s in shapes]


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.Tensor], plan=None) -> None:
    """Make each replicated parameter's gradient the whole model's: sum
    the ranks' partial gradients over ``model`` (each rank's holds its own
    rows' terms), then average them over ``data`` (each data index trains on
    its slice of the batch). One fp32 buffer for all parameters, so every
    rank issues the same collectives whatever gradients it holds (a missing
    gradient counts as zeros, as the optimizer reads it). Under GSPMD the
    JAX package gets this from the replicated parameters' sharding; without
    it each rank would step a different model.

    Under an FSDP ``plan`` (``parallel.fsdp``) a sharded parameter's
    gradient is its shard's, already summed over the plan's axis by the
    gather's adjoint: a second buffer takes the sum over the other axis, if
    it is ``model``, and the average over ``data``."""
    mesh = get_mesh()
    if mesh is None or mesh.shape["model"] * mesh.shape["data"] == 1:
        return
    params = [p for p in params if p.requires_grad]
    sharded = plan is not None and plan.mode == "fsdp"
    buffers = [([p for p in params if not sharded or plan.dim_of(p) is None], ("model", "data"))]
    if sharded:
        buffers.append(([p for p in params if plan.dim_of(p) is not None],
                        tuple(a for a in ("model", "data") if a != plan.axis)))
    for group, axes in buffers:
        if not group:
            continue
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in group]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        mesh.check_device(flat)
        for axis in axes:
            if mesh.shape[axis] > 1:
                dist.all_reduce(flat, group=mesh.groups[axis])
        if mesh.shape["data"] > 1:
            flat /= mesh.shape["data"]
        offset = 0
        for p, g in zip(group, grads):
            n = g.numel()
            p.grad = flat[offset:offset + n].view_as(g).to(p.dtype)
            offset += n
