"""Variable-index views for routing variables through the model.

Capability parity with the reference's ``data_indices/tensor.py`` (an index
view exposes ``full`` / ``prognostic`` / ``diagnostic`` / ``forcing`` int
arrays resolved against a ``name_to_index`` table), built differently: every
variable is classified ONCE into a role — ``prognostic`` (in both the input
and output of the model), ``side`` (exclusive to this side of the model:
forcing for inputs, diagnostic for outputs), or ``absent`` (not part of this
view at all) — and each published array is a single role-filtered selection
over the table. Indices are plain ``numpy`` int32 arrays, fixed when the
model is built.

The port's copy of ``anemoi_models_tpu/data_indices/tensor.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BaseTensorIndex", "InputTensorIndex", "OutputTensorIndex", "lookup_indices"]

# Roles a variable can hold within one tensor view.
_PROGNOSTIC = 0  # present in this view AND carried through the model
_SIDE = 1  # present in this view only (forcing on inputs, diagnostic on outputs)
_ABSENT = 2  # not materialised in this view's tensor


def lookup_indices(name_to_index: dict[str, int], names: list[str]) -> np.ndarray:
    """Sorted dataset positions of ``names`` (all must exist in the table)."""
    return np.array(sorted(name_to_index[n] for n in names), dtype=np.int32)


def _select(name_to_index: dict[str, int], roles: dict[str, int], *wanted: int) -> np.ndarray:
    """Sorted positions of every variable whose role is one of ``wanted``."""
    keep = set(wanted)
    picked = [i for name, i in name_to_index.items() if roles[name] in keep]
    return np.array(sorted(picked), dtype=np.int32)


class BaseTensorIndex:
    """Index arrays (full/prognostic/diagnostic/forcing) for one tensor view.

    ``includes`` are this side's exclusive variables, ``excludes`` are the
    variables the view drops; everything else is prognostic. Subclasses say
    which of forcing/diagnostic plays which role.
    """

    def __init__(self, *, includes: list[str], excludes: list[str], name_to_index: dict[str, int]) -> None:
        self.includes = includes
        self.excludes = excludes
        self.name_to_index = name_to_index

        unknown = [v for v in excludes if v not in name_to_index]
        assert not unknown, f"Index excludes name variables absent from the dataset table: {unknown}"
        unknown = [v for v in includes if v not in name_to_index]
        assert not unknown, f"Index includes name variables absent from the dataset table: {unknown}"

        roles = {name: _PROGNOSTIC for name in name_to_index}
        roles.update((name, _SIDE) for name in includes)
        roles.update((name, _ABSENT) for name in excludes)
        self._roles = roles

        self.full = _select(name_to_index, roles, _PROGNOSTIC, _SIDE)
        self.prognostic = _select(name_to_index, roles, _PROGNOSTIC)
        self._side = _select(name_to_index, roles, _SIDE)
        self._absent = _select(name_to_index, roles, _ABSENT)
        # Subclasses alias these onto forcing/diagnostic.
        self.diagnostic: np.ndarray = NotImplemented
        self.forcing: np.ndarray = NotImplemented

    # The side-exclusive/dropped arrays under the names downstream code reads.
    @property
    def _only(self) -> np.ndarray:
        return self._side

    @property
    def _removed(self) -> np.ndarray:
        return self._absent

    def __len__(self) -> int:
        return len(self.full)

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(includes={self.includes}, excludes={self.excludes}, "
            f"name_to_index={self.name_to_index})"
        )

    def __eq__(self, other: object):
        if not isinstance(other, BaseTensorIndex):
            return NotImplemented
        ours, theirs = self.todict(), other.todict()
        arrays_equal = all(np.array_equal(ours[k], theirs[k]) for k in ours)
        return arrays_equal and self.includes == other.includes and self.excludes == other.excludes

    def __getitem__(self, key: str):
        return getattr(self, key)

    def todict(self) -> dict:
        return {
            "full": self.full,
            "prognostic": self.prognostic,
            "diagnostic": self.diagnostic,
            "forcing": self.forcing,
        }


class InputTensorIndex(BaseTensorIndex):
    """Input view: forcing is side-exclusive, diagnostics are absent."""

    def __init__(self, *, includes: list[str], excludes: list[str], name_to_index: dict[str, int]) -> None:
        super().__init__(includes=includes, excludes=excludes, name_to_index=name_to_index)
        self.forcing = self._side
        self.diagnostic = self._absent


class OutputTensorIndex(BaseTensorIndex):
    """Output view: diagnostics are side-exclusive, forcing is absent."""

    def __init__(self, *, includes: list[str], excludes: list[str], name_to_index: dict[str, int]) -> None:
        super().__init__(includes=includes, excludes=excludes, name_to_index=name_to_index)
        self.diagnostic = self._side
        self.forcing = self._absent
