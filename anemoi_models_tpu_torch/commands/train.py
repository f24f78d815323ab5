"""``train`` command: full training runs on real or synthetic datasets.

Counterpart of ``anemoi_models_tpu/commands/train.py`` on the port's
``train_run``, with ``--device``. ``--data-parallel N`` trains on N ranks,
each a process: the command reads the launch environment ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK``
picks a rank's card), joins the default process group over the
``--backend`` the caller names (``gloo`` or ``nccl``, as ``make_mesh``
takes it) and trains on ``make_mesh(data=N)``::

    torchrun --nproc-per-node 2 -m anemoi_models_tpu_torch train --synthetic \
        --data-parallel 2 --backend nccl

The reference leaves training to the external anemoi-training package; this
command makes the framework self-sufficient: point it at a dataset directory
(``save_memmap_dataset`` layout) or ``.h5`` file — or pass ``--synthetic``
for a generated one — and it builds the graph from the data's own grid,
trains with checkpoint/resume, and reports rollout skill.
"""

from __future__ import annotations

from anemoi_models_tpu_torch.commands import add_device_argument, register_command


def _parse_schedule(text):
    """'0:1,5000:2' -> [(0, 1), (5000, 2)]; clear errors for malformed input."""
    if not text:
        return None
    out = []
    for part in text.split(","):
        fields = part.split(":")
        if len(fields) != 2 or not all(f.strip().lstrip("-").isdigit() for f in fields):
            raise SystemExit(
                f"--rollout-schedule: expected 'step:length' pairs, got {part!r}"
            )
        out.append((int(fields[0]), int(fields[1])))
    if not any(s == 0 for s, _ in out):
        raise SystemExit("--rollout-schedule must include a step-0 entry")
    return out


@register_command("train")
class Train:
    """Train a forecast model on a dataset (memmap dir, .h5, or synthetic)."""

    def add_arguments(self, parser) -> None:
        parser.add_argument("dataset", nargs="?", help="dataset path (dir or .h5)")
        parser.add_argument("--synthetic", action="store_true", help="use generated data")
        parser.add_argument("--grid-lat", type=int, default=24, help="synthetic grid size")
        parser.add_argument("--num-vars", type=int, default=8, help="synthetic variable count")
        parser.add_argument("--num-steps", type=int, default=512, help="synthetic time steps")
        parser.add_argument("--flavor", default="graphtransformer",
                            choices=("graphtransformer", "gnn", "transformer"))
        parser.add_argument("--forcing", nargs="*", default=[], help="forcing variable names")
        parser.add_argument("--diagnostic", nargs="*", default=[], help="diagnostic-only names")
        parser.add_argument("--steps", type=int, default=200)
        parser.add_argument("--batch-size", type=int, default=2)
        parser.add_argument("--rollout", type=int, default=1,
                            help="autoregressive steps trained through per update")
        parser.add_argument("--rollout-schedule", default=None,
                            help="curriculum, e.g. '0:1,5000:2,8000:4' (step:length)")
        parser.add_argument("--ensemble", type=int, default=1,
                            help="ensemble members per sample (AIFS-CRPS style)")
        parser.add_argument("--perturb-sigma", type=float, default=0.05)
        parser.add_argument("--loss", default=None, choices=("mse", "crps"),
                            help="objective (default: crps when --ensemble>1, else mse)")
        parser.add_argument("--channels", type=int, default=64)
        parser.add_argument("--layers", type=int, default=4)
        parser.add_argument("--heads", type=int, default=4)
        parser.add_argument("--mesh-refinements", type=int, default=3)
        parser.add_argument("--architecture", default="enc_proc_dec",
                            choices=("enc_proc_dec", "hierarchical"))
        parser.add_argument("--hidden-levels", type=int, default=2,
                            help="mesh-pyramid depth (hierarchical only)")
        parser.add_argument("--lr", type=float, default=1e-3)
        parser.add_argument("--ema", type=float, default=None, help="EMA decay (e.g. 0.999)")
        parser.add_argument("--checkpoint-dir", default=None)
        parser.add_argument("--save-every", type=int, default=0)
        parser.add_argument("--resume", action="store_true")
        parser.add_argument("--init-from", default=None,
                            help="warm-start parameters from another checkpoint")
        parser.add_argument("--eval-every", type=int, default=0)
        parser.add_argument("--eval-rollout", type=int, default=4)
        parser.add_argument("--data-parallel", type=int, default=0,
                            help="shard the batch over this many ranks (0 = one process); read the launch "
                                 "environment torchrun sets")
        parser.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                            help="the collectives' backend of --data-parallel (required with it)")
        parser.add_argument("--seed", type=int, default=0)
        add_device_argument(parser)

    def run(self, args) -> int:
        from anemoi_models_tpu_torch.training import open_dataset, train_run
        from anemoi_models_tpu_torch.training.dataset import SyntheticSource

        if args.synthetic == (args.dataset is not None):
            raise SystemExit("pass a dataset path or --synthetic (exactly one)")

        if args.synthetic:
            from anemoi_models_tpu_torch.graphs.build import latlon_grid_nodes

            coords = latlon_grid_nodes(args.grid_lat).coords
            source = SyntheticSource(coords, args.num_vars, num_steps=args.num_steps,
                                     seed=args.seed)
        else:
            source = open_dataset(args.dataset)

        unknown = [v for v in list(args.forcing) + list(args.diagnostic)
                   if v not in source.variables]
        if unknown:
            raise SystemExit(f"variables {unknown} not in dataset: {source.variables}")

        mesh, device = None, args.device
        if args.data_parallel:
            mesh, device = _data_parallel_mesh(args.data_parallel, args.backend, args.device)
        try:
            result = train_run(
                source,
                forcing=tuple(args.forcing),
                diagnostic=tuple(args.diagnostic),
                flavor=args.flavor,
                architecture=args.architecture,
                num_hidden_levels=args.hidden_levels,
                mesh_refinements=args.mesh_refinements,
                model_kwargs={
                    "num_channels": args.channels,
                    "num_layers": args.layers,
                    "num_heads": args.heads,
                },
                steps=args.steps,
                batch_size=args.batch_size,
                rollout=args.rollout,
                rollout_schedule=_parse_schedule(args.rollout_schedule),
                ensemble=args.ensemble,
                perturb_sigma=args.perturb_sigma,
                loss=args.loss or ("crps" if args.ensemble > 1 else "mse"),
                peak_lr=args.lr,
                ema_decay=args.ema,
                checkpoint_dir=args.checkpoint_dir,
                save_every=args.save_every,
                resume=args.resume,
                init_from=args.init_from,
                eval_every=args.eval_every,
                eval_rollout=args.eval_rollout,
                mesh=mesh,
                seed=args.seed,
                device=device,
            )
        finally:
            if mesh is not None:
                import torch.distributed as dist

                dist.destroy_process_group()
        losses = result["losses"]
        if losses:
            print(f"loss: first {losses[0]:.5f} -> last {losses[-1]:.5f}")
        if result["eval"]:
            last = result["eval"][-1]
            print(f"final eval: rmse {last['rmse_mean']:.5f} "
                  f"skill {last['skill_mean']:+.3f}")
        if result["checkpoint"]:
            print(f"checkpoint: {result['checkpoint']}")
        return 0


LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _data_parallel_mesh(n: int, backend, device: str):
    """``(mesh, device)`` of ``--data-parallel n``: the default process group
    from the launch environment, over ``backend``, and ``make_mesh(data=n)``
    on this rank's device (``cuda:LOCAL_RANK`` for the card)."""
    import os

    import torch
    import torch.distributed as dist

    from anemoi_models_tpu_torch.parallel import make_mesh

    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise SystemExit(f"--data-parallel {n} runs under a launcher (torchrun): the launch environment lacks "
                         f"{', '.join(missing)}")
    if backend is None:
        raise SystemExit("--data-parallel needs --backend gloo or nccl")
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise SystemExit(f"--data-parallel {n} but the launch environment's WORLD_SIZE is {world}")
    if torch.device(device).type == "cuda" and "LOCAL_RANK" in os.environ:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                            world_size=world, rank=int(os.environ["RANK"]))
    return make_mesh(data=n, backend=backend, device=device), device
