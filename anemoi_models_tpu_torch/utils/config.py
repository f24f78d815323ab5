"""Configuration utilities: DotDict + ``_target_`` instantiation.

Counterpart of ``anemoi_models_tpu/utils/config.py``. The JAX package's
``utils`` package imports jax on import, so the port carries its own copy.
``_target_`` strings resolve through an explicit registry
(:func:`register`) first; in the reference namespace (``anemoi.models.*``)
they resolve to this package's classes, so the JAX package's configs build
port models unmodified.
"""

from __future__ import annotations

import importlib
from collections.abc import Mapping
from typing import Any, Callable

__all__ = ["DotDict", "as_dotdict", "instantiate", "register", "resolve_target"]

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

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def to_dict(self) -> dict:
        """Deep-convert back to plain dicts and lists."""
        return _unwrap(dict(self))


def _unwrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_unwrap(v) for v in value)
    return value


def as_dotdict(config: Any) -> DotDict:
    """Deep-convert any Mapping into a DotDict."""
    return DotDict(_unwrap(config))


_REGISTRY: dict[str, Callable] = {}


def register(name: str) -> Callable[[Callable], Callable]:
    """Decorator registering a callable under an explicit target name, which
    :func:`resolve_target` looks up before any path (under its own name or,
    for an ``anemoi.models.*`` target, under the port's)."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn

    return deco


def resolve_target(target: str) -> Callable:
    """The registered callable, else ``anemoi.models.a.b.C`` ->
    ``anemoi_models_tpu_torch.a.b.C``; any other dotted path is imported as
    written."""
    if target in _REGISTRY:
        return _REGISTRY[target]
    if target.startswith(_TARGET_PREFIX):
        target = _PORT_PREFIX + target[len(_TARGET_PREFIX):]
        if target in _REGISTRY:
            return _REGISTRY[target]
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
