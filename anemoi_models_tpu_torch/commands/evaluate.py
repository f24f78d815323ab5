"""``evaluate`` command: score a checkpoint's rollout against a dataset.

Counterpart of ``anemoi_models_tpu/commands/evaluate.py`` on the port's
``evaluate_interface``, with ``--device``; it reads either package's
checkpoints.

Completes the train/serve/evaluate triad (the reference ecosystem splits
this into anemoi-training's validation and external verification tools):
load a self-contained checkpoint, roll it forward on held-out data, and
report area-weighted RMSE/MAE and skill vs persistence per lead time.
"""

from __future__ import annotations

from anemoi_models_tpu_torch.commands import add_device_argument, register_command


@register_command("evaluate")
class Evaluate:
    """Score a trained checkpoint on a dataset (rollout vs persistence)."""

    def add_arguments(self, parser) -> None:
        parser.add_argument("checkpoint", help="checkpoint directory (train --checkpoint-dir)")
        parser.add_argument("dataset", help="dataset path (memmap dir or .h5)")
        parser.add_argument("--rollout", type=int, default=4, help="lead times to score")
        parser.add_argument("--start", type=int, default=None,
                            help="window start (default: dataset tail)")
        parser.add_argument("--acc", action="store_true",
                            help="add anomaly correlation vs dataset climatology")
        parser.add_argument("--ensemble", type=int, default=1,
                            help="score an M-member perturbed-IC ensemble (CRPS, spread)")
        parser.add_argument("--perturb-sigma", type=float, default=0.05)
        parser.add_argument("--json", action="store_true", help="print raw JSON scores")
        add_device_argument(parser)

    def run(self, args) -> int:
        import json

        import numpy as np

        from anemoi_models_tpu_torch.interface import AnemoiModelInterface
        from anemoi_models_tpu_torch.training import evaluate_interface, open_dataset
        from anemoi_models_tpu_torch.training.dataset import check_source_layout

        iface = AnemoiModelInterface.from_checkpoint(args.checkpoint, device=args.device)
        source = open_dataset(args.dataset)
        check_source_layout(iface, source)

        scores = evaluate_interface(
            iface, source, n_steps=args.rollout, start=args.start, acc=args.acc,
            ensemble=args.ensemble, perturb_sigma=args.perturb_sigma,
        )
        if args.json:
            print(json.dumps({k: np.asarray(v).tolist() for k, v in scores.items()}))
            return 0

        prog_set = set(np.asarray(iface.data_indices.internal_model.output.prognostic).tolist())
        prog = [
            n for n, i in sorted(
                iface.data_indices.internal_model.output.name_to_index.items(),
                key=lambda kv: kv[1],
            )
            if i in prog_set
        ]
        acc_hdr = f"  {'acc':>7}" if args.acc else ""
        print(f"{'lead':>5}  {'rmse':>9}  {'mae':>9}  {'persist':>9}  {'skill':>7}{acc_hdr}")
        for t in range(args.rollout):
            acc_col = f"  {np.mean(scores['acc'][t]):>7.4f}" if args.acc else ""
            print(
                f"{t + 1:>5}  {np.mean(scores['rmse'][t]):>9.5f}  "
                f"{np.mean(scores['mae'][t]):>9.5f}  "
                f"{np.mean(scores['persistence_rmse'][t]):>9.5f}  "
                f"{np.mean(scores['skill_vs_persistence'][t]):>+7.3f}{acc_col}"
            )
        print(f"variables: {', '.join(prog)}")
        if args.ensemble > 1:
            print(f"\n{'lead':>5}  {'crps':>9}  {'spread':>9}  {'spread/skill':>12}")
            for t in range(args.rollout):
                print(f"{t + 1:>5}  {scores['crps'][t]:>9.5f}  "
                      f"{scores['spread'][t]:>9.5f}  "
                      f"{scores['spread_skill_ratio'][t]:>12.3f}")
        return 0
