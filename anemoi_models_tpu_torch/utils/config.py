"""Configuration utilities: DotDict + ``_target_`` instantiation.

Counterpart of ``anemoi_models_tpu/utils/config.py``. The JAX package's
``utils`` package imports jax on import, so the port carries its own copy of
the two pieces the serving path needs. ``_target_`` strings in the reference
namespace (``anemoi.models.*``) resolve to this package's classes, so the
JAX package's configs build port models unmodified.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

__all__ = ["DotDict", "instantiate", "resolve_target"]

_TARGET_PREFIX = "anemoi.models."
_PORT_PREFIX = "anemoi_models_tpu_torch."


class DotDict(dict):
    """A dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        for key, value in list(self.items()):
            self[key] = self._wrap(value)

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, DotDict):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: Any, value: Any) -> None:
        super().__setitem__(name, self._wrap(value))


def resolve_target(target: str) -> Callable:
    """``anemoi.models.a.b.C`` -> ``anemoi_models_tpu_torch.a.b.C``; any other
    dotted path is imported as written."""
    if target.startswith(_TARGET_PREFIX):
        target = _PORT_PREFIX + target[len(_TARGET_PREFIX):]
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ValueError(f"Cannot resolve instantiate target {target!r}")
    return getattr(importlib.import_module(module_name), attr)


def instantiate(config: Any, *args: Any, **kwargs: Any) -> Any:
    """Build ``config["_target_"]`` with the config's other keys plus
    ``kwargs`` (non-recursive: nested dicts are passed through as configs)."""
    cfg = dict(config)
    cfg.pop("_recursive_", None)
    cfg.pop("_convert_", None)
    target = cfg.pop("_target_", None)
    if target is None:
        raise ValueError(f"Config has no _target_ entry: {config}")
    return resolve_target(target)(*args, **{**cfg, **kwargs})
