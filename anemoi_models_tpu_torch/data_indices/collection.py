"""IndexCollection: the four-level variable routing table.

Reproduces the reference's ``data_indices/collection.py:24-98`` semantics:
four index levels — ``data`` / ``internal_data`` / ``model`` /
``internal_model`` — each with input and output views, built from three config
lists: ``config.data.forcing`` (inputs only), ``config.data.diagnostic``
(outputs only) and ``config.data.remapped`` (1→N variable remappings whose
products are appended at the end of the *internal* tensors).
"""

from __future__ import annotations

import operator
from typing import Any

from anemoi_models_tpu_torch.data_indices.index import DataIndex, ModelIndex

__all__ = ["IndexCollection"]


def _as_list(value: Any) -> list:
    if value is None:
        return []
    return list(value)


def _dense_index(names, drop) -> dict[str, int]:
    """Dense ``{name: position}`` over ``names`` with ``drop`` removed."""
    dropped = set(drop)
    kept = (name for name in names if name not in dropped)
    return {name: position for position, name in enumerate(kept)}


def _append(table: dict[str, int], name: str) -> None:
    """Give ``name`` the next free position at the tail of ``table``."""
    table[name] = len(table)


class IndexCollection:
    """The four-level (data/internal_data/model/internal_model) routing table."""

    def __init__(self, config: Any, name_to_index: dict[str, int]) -> None:
        self.config = config
        self.name_to_index = dict(sorted(name_to_index.items(), key=operator.itemgetter(1)))
        data_cfg = config["data"] if isinstance(config, dict) else config.data
        self.forcing = _as_list(data_cfg.get("forcing"))
        self.diagnostic = _as_list(data_cfg.get("diagnostic"))
        remapped = data_cfg.get("remapped")
        self.remapped = dict(remapped) if remapped else {}
        self.forcing_remapped = self.forcing.copy()

        both = set(self.diagnostic).intersection(self.forcing)
        if both:
            raise ValueError(
                f"Variables {sorted(both)} are listed as both diagnostic and forcing; "
                "a variable can be model-input-only or model-output-only, not both."
            )
        remapped_diag = set(self.remapped).intersection(self.diagnostic)
        if remapped_diag:
            raise ValueError(
                f"Remapping of diagnostic variables ({sorted(remapped_diag)}) is unsupported."
            )
        unknown = set(self.remapped).difference(self.name_to_index)
        if unknown:
            raise KeyError(
                f"config.data.remapped names variables absent from the dataset: {sorted(unknown)}"
            )

        # Phase 1: filter. Each table keeps dataset ordering and renumbers
        # positions densely after dropping the excluded names. The model level
        # drops output-only (diagnostic) names from inputs and input-only
        # (forcing) names from outputs; the internal levels additionally drop
        # the remap *source* variables (their products are appended in phase 2).
        dataset_order = list(self.name_to_index)
        model_input = _dense_index(dataset_order, drop=self.diagnostic)
        model_output = _dense_index(dataset_order, drop=self.forcing)
        internal_data_input = _dense_index(dataset_order, drop=self.remapped)
        internal_model_input = _dense_index(model_input, drop=self.remapped)
        internal_model_output = _dense_index(model_output, drop=self.remapped)

        # Phase 2: append each remap product at the tail of every internal
        # table it belongs to. Products of a forcing source are themselves
        # input-only: they join the remapped forcing list instead of the
        # output table, and the consumed source leaves it.
        for source, products in self.remapped.items():
            for product in products:
                _append(internal_data_input, product)
                _append(internal_model_input, product)
                if source in self.forcing:
                    self.forcing_remapped.append(product)
                else:
                    _append(internal_model_output, product)
            if source in self.forcing:
                self.forcing_remapped.remove(source)

        self.data = DataIndex(self.diagnostic, self.forcing, self.name_to_index)
        self.internal_data = DataIndex(self.diagnostic, self.forcing_remapped, internal_data_input)
        self.model = ModelIndex(self.diagnostic, self.forcing, model_input, model_output)
        self.internal_model = ModelIndex(
            self.diagnostic,
            self.forcing_remapped,
            internal_model_input,
            internal_model_output,
        )

    def __repr__(self) -> str:
        return f"IndexCollection(config={self.config}, name_to_index={self.name_to_index})"

    def __eq__(self, other: object):
        if not isinstance(other, IndexCollection):
            return NotImplemented
        return (
            self.model == other.model
            and self.data == other.data
            and self.internal_model == other.internal_model
            and self.internal_data == other.internal_data
        )

    def __getitem__(self, key: str):
        return getattr(self, key)

    def todict(self) -> dict:
        return {
            "data": self.data.todict(),
            "model": self.model.todict(),
            "internal_model": self.internal_model.todict(),
            "internal_data": self.internal_data.todict(),
        }
