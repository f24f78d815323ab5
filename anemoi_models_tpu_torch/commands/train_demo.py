"""Demo training command: the synthetic end-to-end pipeline as a CLI."""

from __future__ import annotations

from anemoi_models_tpu_torch.commands import add_device_argument, register_command


@register_command("train-demo")
class TrainDemo:
    """Train a tiny model on synthetic weather and report rollout skill."""

    def add_arguments(self, parser) -> None:
        parser.add_argument("--steps", type=int, default=60)
        parser.add_argument("--grid-lat", type=int, default=12)
        parser.add_argument("--channels", type=int, default=32)
        add_device_argument(parser)

    def run(self, args) -> int:
        from anemoi_models_tpu_torch.graphs.build import latlon_grid_nodes
        from anemoi_models_tpu_torch.training import SyntheticSource, train_run

        source = SyntheticSource(latlon_grid_nodes(args.grid_lat).coords, 4, num_steps=128, seed=0)
        result = train_run(
            source, forcing=("var_0",), mesh_refinements=2, steps=args.steps, batch_size=2, peak_lr=3e-3,
            model_kwargs={"num_channels": args.channels, "num_layers": 2, "num_heads": 4, "num_chunks": 1},
            eval_every=args.steps, eval_rollout=4, log_every=max(args.steps // 6, 1), device=args.device,
        )
        last = result["eval"][-1]
        print(f"loss {result['losses'][0]:.5f} -> {result['losses'][-1]:.5f}; rollout-4 rmse "
              f"{last['rmse_mean']:.5f}, skill vs persistence {last['skill_mean']:+.3f}")
        return 0
