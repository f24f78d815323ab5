"""Hello command (parity with reference ``commands/hello.py:12-32``)."""

from __future__ import annotations

from anemoi_models_tpu_torch.commands import register_command


@register_command("hello")
class Hello:
    """Say hello."""

    def add_arguments(self, parser) -> None:
        parser.add_argument("--name", default="world")

    def run(self, args) -> int:
        print(f"Hello, {args.name}!")
        return 0
