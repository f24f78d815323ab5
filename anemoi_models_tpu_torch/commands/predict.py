"""``predict`` command: run a forecast from a checkpoint and save it.

Counterpart of ``anemoi_models_tpu/commands/predict.py`` on the port's
``predict_rollout``, with ``--device``; it reads either package's
checkpoints.

The anemoi-inference surface of this framework: initial conditions come
from a dataset window, forcings for future lead times are read from the
dataset (as in hindcast/verification runs), the rollout runs on the
card, and the post-processed (physical-space) forecast is
written to an ``.npz`` or to a memmap dataset directory that
``open_dataset`` can read back — forecasts compose with every other tool
here (``evaluate``, the loader, ...).
"""

from __future__ import annotations

from anemoi_models_tpu_torch.commands import add_device_argument, register_command


@register_command("predict")
class Predict:
    """Roll a forecast from a checkpoint; write .npz or a dataset dir."""

    def add_arguments(self, parser) -> None:
        parser.add_argument("checkpoint", help="checkpoint directory")
        parser.add_argument("dataset", help="dataset supplying ICs and future forcings")
        parser.add_argument("--steps", type=int, default=4, help="lead times to forecast")
        parser.add_argument("--start", type=int, default=None,
                            help="initial-window start (default: dataset tail)")
        parser.add_argument("--output", default="forecast.npz",
                            help=".npz path, or a directory for memmap-dataset output")
        parser.add_argument("--ensemble", type=int, default=1,
                            help="members from perturbed initial conditions")
        parser.add_argument("--perturb-sigma", type=float, default=0.01,
                            help="IC perturbation scale in per-variable stdevs")
        parser.add_argument("--seed", type=int, default=0)
        add_device_argument(parser)

    def run(self, args) -> int:
        import os

        import numpy as np
        import torch

        from anemoi_models_tpu_torch.interface import AnemoiModelInterface
        from anemoi_models_tpu_torch.training import open_dataset
        from anemoi_models_tpu_torch.training.dataset import check_source_layout

        iface = AnemoiModelInterface.from_checkpoint(args.checkpoint, device=args.device)
        dev = iface.device
        source = open_dataset(args.dataset)
        check_source_layout(iface, source)
        indices = iface.data_indices
        multi_step = iface.multi_step
        start = args.start
        if start is None:
            start = len(source) - (multi_step + args.steps)
        if start < 0 or start + multi_step + args.steps > len(source):
            raise SystemExit(
                f"window [{start}, {start + multi_step + args.steps}) outside the "
                f"dataset's {len(source)} steps (forcings are read from the dataset)"
            )

        raw = source.window(start, multi_step + args.steps)[None]
        data_node = iface.config.graph.get("data", "data")
        src_idx = iface.graph_data[data_node].attrs.get("source_index")
        perm = None if src_idx is None else np.ascontiguousarray(src_idx[:, 0])
        if perm is not None:
            raw = raw[:, :, perm, :]

        # predict_rollout preprocesses internally: hand it the RAW window at
        # the model-input (inference) width; only the forcings contract asks
        # for preprocessed values
        data_in = np.asarray(indices.data.input.full)
        forcing_in = np.asarray(indices.internal_model.input.forcing)
        ics = raw[:, :multi_step][..., data_in]  # (1, ms, grid, n_in)
        if args.ensemble > 1:
            # members ride the batch axis (one rollout rolls all):
            # physical-space IC noise scaled per variable, forcing columns
            # kept at truth
            rng = np.random.RandomState(args.seed)
            std = np.asarray(
                [source.statistics["stdev"][source.name_to_index[n]]
                 for n, _ in sorted(indices.model.input.name_to_index.items(),
                                    key=lambda kv: kv[1])],
                np.float32,
            )
            noise = rng.standard_normal((args.ensemble,) + ics.shape[1:]).astype(np.float32)
            noise *= args.perturb_sigma * std
            noise[..., np.asarray(indices.model.input.forcing)] = 0.0
            noise[0] = 0.0  # member 0 is the control run
            ics = ics + noise
        batch = torch.as_tensor(np.ascontiguousarray(ics), device=dev)
        forcings = None
        if forcing_in.size:
            pre = iface.pre_processors(torch.as_tensor(np.ascontiguousarray(raw), device=dev), in_place=False)
            internal_in = torch.as_tensor(np.asarray(indices.internal_data.input.full), device=dev)
            future = pre[:, multi_step:, None][..., internal_in].movedim(1, 0)
            forcings = future[..., torch.as_tensor(forcing_in, device=dev)].expand(
                (args.steps, len(batch)) + tuple(future.shape[2:-1]) + (int(forcing_in.size),)
            )

        # physical-space forecast: (steps, members, ensemble=1, grid, n_out)
        preds = iface.predict_rollout(batch, args.steps, forcings=forcings)
        members = preds[:, :, 0].float().cpu().numpy()  # (steps, members, grid, n_out)
        fc = members.mean(axis=1) if args.ensemble > 1 else members[:, 0]
        if perm is not None:  # back to the dataset's own row order
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm), dtype=perm.dtype)
            fc = fc[:, inv, :]
            members = members[:, :, inv, :]

        out_names = [
            n for n, _ in sorted(
                indices.internal_model.output.name_to_index.items(), key=lambda kv: kv[1]
            )
        ]
        if args.output.endswith(".npz"):
            extra = {}
            if args.ensemble > 1:  # forecast= the member mean; spread + members too
                extra = {"members": members, "ens_std": members.std(axis=1)}
            np.savez_compressed(
                args.output, forecast=fc, variables=np.asarray(out_names),
                start=start, lead_steps=np.arange(1, args.steps + 1), **extra,
            )
        else:
            from anemoi_models_tpu_torch.training.dataset import save_memmap_dataset

            save_memmap_dataset(
                args.output, fc, out_names, np.asarray(source.coords),
                statistics={
                    k: np.asarray(v)[[source.name_to_index[n] for n in out_names]]
                    for k, v in source.statistics.items()
                },
            )
            if args.ensemble > 1:  # sidecar arrays: the dataset holds the mean
                np.save(os.path.join(args.output, "members.npy"), members)
                np.save(os.path.join(args.output, "ens_std.npy"), members.std(axis=1))
        ens = f" ({args.ensemble}-member mean)" if args.ensemble > 1 else ""
        print(f"forecast: {args.steps} steps x {fc.shape[1]} points x "
              f"{len(out_names)} vars{ens} -> {args.output}")
        return 0
