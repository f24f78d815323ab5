"""The port's command line: ``python -m anemoi_models_tpu_torch <command>``.

Counterpart of ``anemoi_models_tpu/commands/``: an argparse registry with
``train``, ``predict``, ``evaluate``, ``bench``, ``info``, ``hello`` and
``train-demo``, each taking the JAX package's arguments plus ``--device``
(the card unless it names another; ``--device cpu`` runs the kernels' plain
versions). ``bench`` prints bench.py's JSON line of grid points/s, timed on
the card; ``plan`` (the TPU kernel planner) is not ported. ``train --data-parallel N`` runs under a
launcher (``torchrun``), one process a rank.
"""

from __future__ import annotations

import argparse
from typing import Callable

__all__ = ["COMMANDS", "register_command", "main"]

COMMANDS: dict[str, Callable[[argparse.ArgumentParser], None]] = {}


def register_command(name: str):
    def deco(cls):
        COMMANDS[name] = cls()
        return cls

    return deco


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", help="torch device to run on (default: the card)")


from anemoi_models_tpu_torch.commands import bench, evaluate, hello, info, predict, train, train_demo  # noqa: E402,F401


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="anemoi_models_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, cmd in COMMANDS.items():
        p = sub.add_parser(name, help=cmd.__doc__)
        cmd.add_arguments(p)
    args = parser.parse_args(argv)
    return COMMANDS[args.command].run(args) or 0
