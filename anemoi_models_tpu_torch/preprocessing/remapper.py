"""Remapper dispatcher: routes a config to the Monomapper or the Multimapper.

Counterpart of ``anemoi_models_tpu/preprocessing/remapper.py``, with its
rule and its errors: all methods 1 -> 1 (or none): Monomapper; all 1 -> N:
Multimapper; only unknown methods: ValueError; a mix: NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Optional

from anemoi_models_tpu_torch.preprocessing import BasePreprocessor
from anemoi_models_tpu_torch.preprocessing.monomapper import Monomapper
from anemoi_models_tpu_torch.preprocessing.multimapper import Multimapper

__all__ = ["Remapper", "Monomapper", "Multimapper"]


class Remapper(BasePreprocessor):
    """Factory selecting the mono- or multi-variable remapper."""

    def __new__(cls, config: Any = None, data_indices: Optional[Any] = None, statistics=None):
        _, _, method_config = cls._process_config(config or {})

        def classify(method: str) -> str:
            if method in Monomapper.supported_methods:
                return "mono"
            if method in Multimapper.supported_methods:
                return "multi"
            return "unknown"

        kinds = {classify(method) for method in method_config}
        if kinds <= {"mono"}:  # an empty config defaults to the width-preserving mapper
            return Monomapper(config, data_indices, statistics)
        if kinds == {"multi"}:
            return Multimapper(config, data_indices, statistics)
        if kinds == {"unknown"}:
            raise ValueError("Remapper config selects no supported transform.")
        raise NotImplementedError(
            "Remapper cannot mix width-preserving and width-changing transforms in one block: "
            f"{list(method_config)}"
        )
