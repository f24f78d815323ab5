"""Rank targets of the parallel port's tests, run in spawned processes.

``spawn(fn, world, *args)`` starts ``world`` processes in ``spawn`` mode
(a forked pytest worker would carry JAX's threads), joins them into one
gloo process group on ``localhost`` and saves what ``fn(rank, world,
*args)`` returns to ``out_dir``; the parent reads every rank's result back.
A failing rank fails the spawn. This module imports torch and the port
only: a spawned child imports it by name to find its target.
"""

from __future__ import annotations

import copy
import datetime
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from anemoi_models_tpu_torch.data_indices import IndexCollection
from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph, build_hierarchical_graph
from anemoi_models_tpu_torch.parallel import (
    gather_tensor,
    halo_graph_conv,
    halo_graph_transformer_conv,
    make_mesh,
    reduce_shard_tensor,
    reduce_tensor,
    row_range,
    shard_edge_values,
    shard_tensor,
    sync_tensor,
    use_mesh,
)
from anemoi_models_tpu_torch.training import AdamW, WeightedMSELoss, make_rollout_train_step, make_train_step

PRIMITIVES = ("shard_tensor", "gather_tensor", "sync_tensor", "reduce_shard_tensor", "reduce_tensor")
PRIM_ROWS, PRIM_COLS = 7, 3  # 7 rows: uneven over 2 and 4 ranks
# attention under a model-sharded mesh that the halo path does not take
NON_HALO_ATTENTION = {
    "causal": dict(window_size=4, is_causal=True, attention_impl="chunked"),
    "flash": dict(window_size=4, attention_impl="flash"),
    "no_window": dict(window_size=None),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, out_dir: str, fn, args, init: bool) -> None:
    torch.set_num_threads(1)
    if not init:  # the target joins a process group itself, on ``port``
        torch.save(fn(rank, world, port, *args), os.path.join(out_dir, f"rank{rank}.pt"))
        return
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, out_dir: str, *args, init: bool = True) -> list:
    """Every rank's result of ``fn(rank, world, *args)``, in rank order;
    with ``init=False`` no process group is made and the target is called
    as ``fn(rank, world, port, *args)`` with a free port for its own."""
    return start(fn, world, out_dir, *args, init=init)()


def start(fn, world: int, out_dir: str, *args, init: bool = True):
    """:func:`spawn` started, not joined: returns the function that joins
    the ranks and returns their results (so the parent can work meanwhile)."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, _free_port(), out_dir, fn, args, init), nprocs=world, join=False,
                             start_method="spawn")

    def join() -> list:
        while not ctx.join():
            pass
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]

    return join


def tasks(rank: int, world: int, named: dict) -> dict:
    """Several tasks in one spawn: ``named`` maps a name to ``(fn, args)``;
    ``"leaked"``, what of jax, flax or the JAX package the rank imported."""
    out = {name: fn(rank, world, *args) for name, (fn, args) in named.items()}
    out["leaked"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "anemoi_models_tpu"))
    return out


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def primitive_inputs(world: int, rank: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """(input, cotangent) of each primitive on ``rank``: whole arrays where
    the primitive takes replicated or partial inputs, the rank's rows where
    it takes rows."""
    lo, hi = row_range(PRIM_ROWS, world, rank)
    full = np.random.RandomState(0).randn(PRIM_ROWS, PRIM_COLS)  # replicated
    mine = np.random.RandomState(10 + rank).randn(PRIM_ROWS, PRIM_COLS)  # differs by rank
    return {
        "shard_tensor": (full, mine[lo:hi]),
        "gather_tensor": (full[lo:hi], full[::-1].copy()),  # a replicated consumer: one cotangent
        "sync_tensor": (full[lo:hi], mine),
        "reduce_shard_tensor": (mine, mine[lo:hi] * 2.0),
        "reduce_tensor": (mine, mine * 3.0),
    }


def primitives_task(rank: int, world: int) -> dict:
    mesh = make_mesh(1, world, backend="gloo", device="cpu")
    fns = {"shard_tensor": shard_tensor, "gather_tensor": gather_tensor, "sync_tensor": sync_tensor,
           "reduce_shard_tensor": reduce_shard_tensor, "reduce_tensor": reduce_tensor}
    out = {}
    with use_mesh(mesh):
        for name, (x, g) in primitive_inputs(world, rank).items():
            x = torch.tensor(x, dtype=torch.float32, requires_grad=True)
            y = fns[name](x, 0) if name != "reduce_tensor" else fns[name](x)
            y.backward(torch.tensor(g, dtype=torch.float32))
            out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


# ---------------------------------------------------------------------------
# the halo layers
# ---------------------------------------------------------------------------


def layers_task(rank: int, world: int, spec: dict) -> dict:
    """The halo GNN conv, the halo GraphTransformer conv and the halo window
    attention on this rank's rows of ``spec``'s whole inputs, forward and
    backward against the given cotangents."""
    from anemoi_models_tpu_torch.graphs.partition import halo_shard, partition_1hop
    from anemoi_models_tpu_torch.layers.attention import MultiHeadSelfAttention
    from anemoi_models_tpu_torch.ops.ring_attention import gathered_attention, halo_window_attention

    mesh = make_mesh(1, world, backend="gloo", device="cpu")
    graph = build_enc_proc_dec_graph(**spec["graph"])
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    shard = halo_shard(partition_1hop(es.edge_index, n, world), rank, "cpu")
    lo, hi = mesh.rows(n)

    def t(a, grad=True):
        return torch.tensor(a, dtype=torch.float32, requires_grad=grad)

    out = {}
    with use_mesh(mesh):
        # GNN conv
        g = spec["gnn"]
        x = t(g["x"][:, lo:hi])
        e = t(shard_edge_values(torch.tensor(g["e"]), shard).numpy())
        params = [t(p) for p in g["params"]]
        agg, msg = halo_graph_conv(mesh, shard, params, x, e, g["activation"])
        ((agg * t(g["g_agg"][:, lo:hi], False)).sum()
         + (msg * t(shard_edge_values(torch.tensor(g["g_msg"]), shard).numpy(), False)).sum()).backward()
        out["gnn"] = dict(agg=agg.detach().numpy(), msg=msg.detach().numpy(), dx=x.grad.numpy(), de=e.grad.numpy(),
                          dparams=[p.grad.numpy() for p in params], edge_range=(shard.edge_lo, shard.edge_hi))
        # GraphTransformer conv
        a = spec["gt"]
        q, f = t(a["q"][:, lo:hi]), t(a["feats"][:, lo:hi])
        ea = t(a["edge_attr"][shard.edge_lo:shard.edge_hi])
        w = {k: t(a[k]) for k in ("w_kv", "b_kv", "w_edge", "b_edge")}
        o = halo_graph_transformer_conv(mesh, shard, q, f, w["w_kv"], w["b_kv"], ea, w["w_edge"], w["b_edge"])
        (o * t(a["g_out"][:, lo:hi], False)).sum().backward()
        out["gt"] = dict(out=o.detach().numpy(), dq=q.grad.numpy(), dfeats=f.grad.numpy(), dedge=ea.grad.numpy(),
                         **{f"d{k}": v.grad.numpy() for k, v in w.items()})
        # window attention at p = 0, and with dropout at p = 0.5 (v = 1)
        wa = spec["window"]
        q, k, v = (t(wa[name][:, :, lo:hi]) for name in ("q", "k", "v"))
        o = halo_window_attention(q, k, v, window_size=wa["window"], seq_len=n, mesh=mesh)
        (o * t(wa["g_out"][:, :, lo:hi], False)).sum().backward()
        ones = torch.ones_like(v)
        dropped = halo_window_attention(q.detach(), k.detach(), ones, window_size=wa["window"], seq_len=n,
                                        mesh=mesh, dropout_rate=0.5, dropout_key=7)
        out["window"] = dict(out=o.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy(),
                             dropped=dropped.numpy())
        # every other attention under the mesh: the gathered keys' path, forward and backward, and the
        # layer's rows against the same layer's unsharded output
        for case, kw in NON_HALO_ATTENTION.items():
            q, k, v = (t(wa[name][:, :, lo:hi]) for name in ("q", "k", "v"))
            o = gathered_attention(q, k, v, window_size=kw["window_size"], is_causal=kw.get("is_causal", False),
                                   seq_len=n, mesh=mesh)
            (o * t(wa["g_out"][:, :, lo:hi], False)).sum().backward()
            torch.manual_seed(0)
            layer = MultiHeadSelfAttention(2, 8, seq_len=n, **kw)
            x = torch.from_numpy(wa["x"])
            with torch.no_grad():
                rows = layer(x[:, lo:hi])
                with use_mesh(None):
                    whole = layer(x)[:, lo:hi]
            out[f"non_halo_{case}"] = dict(out=o.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(),
                                           dv=v.grad.numpy(), layer=rows.numpy(), layer_unsharded=whole.numpy())
    return out


# ---------------------------------------------------------------------------
# the model: forward, train step, rollout
# ---------------------------------------------------------------------------


def _rank_batch(a: np.ndarray, mesh, batch_axis: int, grid_axis: int) -> torch.Tensor:
    """This rank's slice of the data axis and rows of the model axis."""
    b = a.shape[batch_axis] // mesh.shape["data"]
    d = mesh.coords["data"]
    lo, hi = mesh.rows(a.shape[grid_axis])
    idx = [slice(None)] * a.ndim
    idx[batch_axis] = slice(d * b, (d + 1) * b)
    idx[grid_axis] = slice(lo, hi)
    return torch.from_numpy(np.ascontiguousarray(a[tuple(idx)]))


def model_graph(spec: dict):
    """The graph of a model spec: ``spec["graph"]``'s keywords to the
    hierarchical builder when ``spec["hierarchical"]``, else to the flat one."""
    if spec.get("hierarchical"):
        return build_hierarchical_graph(**spec["graph"])[0]
    return build_enc_proc_dec_graph(**spec["graph"])


def model_task(rank: int, world: int, spec: dict) -> dict:
    """Per flavor (a model config): the sharded forward of a model loaded
    from the unsharded model's checkpoint, one sharded train step (its loss,
    the reduced gradients and the updated parameters) and a 2-step sharded
    rollout train step's loss; with ``spec["negative"]``, the
    GraphTransformer's step again without the reduction of the gradients;
    with ``spec["save_dots"]``, its step again under ``remat_policy``
    "save_dots", with the calls of each mapper's block counted."""
    from anemoi_models_tpu_torch.checkpoint import load_checkpoint
    from anemoi_models_tpu_torch.utils.config import DotDict, instantiate

    data, model_ax = spec["mesh"]
    mesh = make_mesh(data, model_ax, backend="gloo", device="cpu")
    graph = model_graph(spec)
    s = spec["inputs"]
    x, y = _rank_batch(s["x"], mesh, 0, 3), _rank_batch(s["y"], mesh, 0, 2)
    truth, targets = _rank_batch(s["truth"], mesh, 1, 3), _rank_batch(s["targets"], mesh, 1, 3)
    node_weights = torch.from_numpy(s["node_weights"])  # whole grid: the loss takes the rank's rows
    out = {}
    for flavor, fs in spec["flavors"].items():
        di = IndexCollection(fs["cfg"], spec["name_to_index"])

        def build(cfg=fs["cfg"]):
            net = instantiate(DotDict(cfg).model.model, model_config=cfg, data_indices=di,
                              graph_data=graph, device="cpu")
            net.load_state_dict(load_checkpoint(fs["checkpoint"])["params"], strict=True)
            return net

        res = {}
        with use_mesh(mesh):
            net = build()
            with torch.no_grad():
                res["forward"] = net(x).numpy()
            opt = AdamW(net.parameters(), lambda count: spec["lr"], clip_norm=32.0)
            res["loss"] = float(make_train_step(net, opt, WeightedMSELoss(node_weights))(x, y))
            res["grads"] = {k: p.grad.numpy().copy() for k, p in net.named_parameters()}
            res["params"] = {k: p.detach().numpy().copy() for k, p in net.named_parameters()}
            net = build()
            opt = AdamW(net.parameters(), lambda count: spec["lr"], clip_norm=32.0)
            res["rollout_loss"] = float(make_rollout_train_step(net, di, opt, n_steps=2)(x, truth, targets))
            if spec.get("negative") and flavor == "graphtransformer":
                # the step with the reduction of the replicated parameters' gradients left out
                net = build()
                opt = AdamW(net.parameters(), lambda count: spec["lr"], clip_norm=32.0)
                WeightedMSELoss(node_weights)(net(x), y).backward()
                res["negative_grads"] = {k: p.grad.numpy().copy() for k, p in net.named_parameters()}
                opt.step()
                res["negative_params"] = {k: p.detach().numpy().copy() for k, p in net.named_parameters()}
            if spec.get("save_dots") and flavor == "graphtransformer":
                cfg = copy.deepcopy(fs["cfg"])
                cfg["model"]["processor"]["remat_policy"] = "save_dots"
                net = build(cfg)
                calls = {"encoder": 0, "decoder": 0}
                for part in calls:
                    getattr(net, part).proc.register_forward_pre_hook(
                        lambda *_, part=part: calls.__setitem__(part, calls[part] + 1))
                opt = AdamW(net.parameters(), lambda count: spec["lr"], clip_norm=32.0)
                res["save_dots_loss"] = float(make_train_step(net, opt, WeightedMSELoss(node_weights))(x, y))
                res["save_dots_grads"] = {k: p.grad.numpy().copy() for k, p in net.named_parameters()}
                res["mapper_block_calls"] = calls
        out[flavor] = res
    if "halo_gnn" in spec:
        out["halo_gnn"] = _halo_gnn(mesh, spec["halo_gnn"], graph)
    if "train_run" in spec:
        out["train_run"] = _train_run(mesh, spec["train_run"])
    return out


def hier_source():
    """A small record for the hierarchical model's train_run: a 6-row
    lat/lon grid, 4 variables, 24 steps (``tests/training/test_run.py``'s)."""
    from anemoi_models_tpu_torch.graphs.build import latlon_grid_nodes
    from anemoi_models_tpu_torch.training import SyntheticSource

    return SyntheticSource(latlon_grid_nodes(6).coords, num_vars=4, num_steps=24, seed=1)


def _train_run(mesh, kwargs: dict) -> list:
    """train_run's loss trace on ``mesh``."""
    from anemoi_models_tpu_torch.training import train_run

    return train_run(hier_source(), mesh=mesh, device="cpu", log=lambda s: None, handle_signals=False,
                     **kwargs)["losses"]


def _halo_gnn(mesh, spec: dict, graph) -> np.ndarray:
    """A HaloGNNProcessor loaded from a JAX tree, its sharded forward."""
    from anemoi_models_tpu_torch.layers.processor import HaloGNNProcessor
    from anemoi_models_tpu_torch.weights import load_flax_params

    n = graph["hidden"].num_nodes
    proc = HaloGNNProcessor(spec["num_layers"], num_channels=spec["channels"], trainable_size=2,
                            sub_graph=graph[("hidden", "to", "hidden")], src_grid_size=n, dst_grid_size=n,
                            device="cpu")
    proc.load_state_dict(load_flax_params(spec["tree"]), strict=True)
    lo, hi = mesh.rows(n)
    with use_mesh(mesh), torch.no_grad():
        return proc(torch.from_numpy(spec["x"][:, lo:hi])).numpy()


# ---------------------------------------------------------------------------
# ZeRO-1 / FSDP and train_run on a mesh
# ---------------------------------------------------------------------------


def fsdp_source():
    """The JAX package's fsdp tests' source: an 8-row lat/lon grid, 4
    variables, 48 steps (``tests/parallel/test_fsdp.py``)."""
    from anemoi_models_tpu_torch.graphs.build import latlon_grid_nodes
    from anemoi_models_tpu_torch.training import SyntheticSource

    return SyntheticSource(latlon_grid_nodes(8).coords, num_vars=4, num_steps=48, seed=1)


def _layout(run: dict) -> dict:
    """Per parameter: its shape on this rank, the shapes of its moments and
    of its EMA entry."""
    opt, model = run["optimizer"], run["model"]
    out = {}
    for name, p in model.named_parameters():
        state = opt.state.get(p) or {}
        out[name] = {"param": tuple(p.shape), "mu": tuple(state["mu"].shape) if "mu" in state else None,
                     "ema": tuple(run["ema"][name].shape) if run.get("ema") else None}
    return out


def _whole(run: dict) -> dict:
    """The run's parameters whole (gathered under FSDP), on every rank."""
    plan = run["plan"]
    if plan is None:
        return {k: p.detach().clone().numpy() for k, p in run["model"].named_parameters()}
    with plan.gathered(run["optimizer"]):
        return {k: p.detach().clone().numpy() for k, p in run["model"].named_parameters()}


def fsdp_task(rank: int, world: int, spec: dict) -> dict:
    """train_run on a (2, 2) mesh of gloo ranks on the CPU: from the JAX
    run's initial parameters, 4 steps under each of None, "zero1" and "fsdp"
    (min size 64, as the JAX tests patch it); zero1 with an EMA; an FSDP run
    checkpointed at step 2 and resumed to 4 against the uninterrupted run;
    and a hybrid (2, 1, 2) mesh's run writing metrics.jsonl."""
    from anemoi_models_tpu_torch.parallel import fsdp, make_hybrid_mesh
    from anemoi_models_tpu_torch.training import train_run

    fsdp.DEFAULT_MIN_SIZE = 64
    mesh = make_mesh(2, 2, backend="gloo", device="cpu")
    common = dict(spec["common"], device="cpu", log=lambda s: None, handle_signals=False)
    out = {"coords": mesh.coords}
    for mode in (None, "zero1", "fsdp"):
        run = train_run(fsdp_source(), mesh=mesh, param_sharding=mode, init_from=spec["init"], **common)
        out[str(mode)] = {"losses": run["losses"], "params": _whole(run), "layout": _layout(run)}
    run = train_run(fsdp_source(), mesh=mesh, param_sharding="zero1", ema_decay=0.9, **common)
    out["zero1_ema"] = {"losses": run["losses"], "layout": _layout(run)}
    root = spec["root"]
    full = train_run(fsdp_source(), mesh=mesh, param_sharding="fsdp", checkpoint_dir=f"{root}/full", **common)
    train_run(fsdp_source(), mesh=mesh, param_sharding="fsdp", checkpoint_dir=f"{root}/part", save_every=2,
              max_steps_this_run=2, **common)
    rest = train_run(fsdp_source(), mesh=mesh, param_sharding="fsdp", checkpoint_dir=f"{root}/part", resume=True,
                     **common)
    out["roundtrip"] = {"full": _whole(full), "resumed": _whole(rest), "steps": rest["steps_done"],
                        "checkpoint": full["checkpoint"]}
    hybrid = make_hybrid_mesh(2, 1, 2, backend="gloo", device="cpu")
    hy = {k: v for k, v in common.items() if k not in ("batch_size", "log_every", "steps", "peak_lr")}
    run = train_run(fsdp_source(), mesh=hybrid, steps=2, batch_size=2, peak_lr=1e-3, log_every=1,
                    checkpoint_dir=f"{root}/hybrid", **hy)
    out["hybrid"] = {"shape": hybrid.shape, "coords": hybrid.coords, "steps": run["steps_done"],
                     "losses": run["losses"]}
    return out


def cli_task(rank: int, world: int, port: int, args: list) -> dict:
    """``train --data-parallel`` on this rank under the launch environment
    torchrun would set (spawned with ``init=False``: the command joins the
    process group itself); what it printed, and what of JAX it imported."""
    import contextlib
    import io

    from anemoi_models_tpu_torch.commands import main

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(port)})
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = main(["train", *args])
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "anemoi_models_tpu"))
    return {"rc": rc, "printed": printed.getvalue(), "group_left": not dist.is_initialized(), "leaked": leaked}
