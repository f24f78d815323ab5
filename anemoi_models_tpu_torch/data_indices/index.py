"""Input/output view pairs at the data and model levels.

Capability parity with the reference's ``data_indices/index.py``: a
``DataIndex`` views the raw dataset tensor (diagnostics absent from input,
forcings absent from output); a ``ModelIndex`` views the model tensors where
those variables were already dropped, so nothing is absent — forcing and
diagnostic are purely side-exclusive there. Both are one call to the shared
``_view_pair`` builder with different absence rules.
"""

from __future__ import annotations

from anemoi_models_tpu_torch.data_indices.tensor import InputTensorIndex, OutputTensorIndex

__all__ = ["BaseIndex", "DataIndex", "ModelIndex"]


def _view_pair(
    *,
    forcing: list[str],
    diagnostic: list[str],
    input_table: dict[str, int],
    output_table: dict[str, int],
    dropped_from_views: bool,
) -> tuple[InputTensorIndex, OutputTensorIndex]:
    """Build the (input, output) views for one level.

    ``dropped_from_views=True`` means the tables still contain the other
    side's variables, so each view must mark them absent (the data level);
    ``False`` means the tables were already narrowed (the model level).
    """
    absent_in = diagnostic if dropped_from_views else []
    absent_out = forcing if dropped_from_views else []
    return (
        InputTensorIndex(includes=forcing, excludes=absent_in, name_to_index=input_table),
        OutputTensorIndex(includes=diagnostic, excludes=absent_out, name_to_index=output_table),
    )


class BaseIndex:
    """An (input, output) pair of tensor views."""

    input: InputTensorIndex
    output: OutputTensorIndex

    def __eq__(self, other: object):
        if not isinstance(other, BaseIndex):
            return NotImplemented
        return self.input == other.input and self.output == other.output

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(input={self.input}, output={self.output})"

    def __getitem__(self, key: str):
        return getattr(self, key)

    def todict(self) -> dict:
        return {"input": self.input.todict(), "output": self.output.todict()}


class DataIndex(BaseIndex):
    """Views into the raw dataset tensor (one shared name table)."""

    def __init__(self, diagnostic: list[str], forcing: list[str], name_to_index: dict[str, int]) -> None:
        self.input, self.output = _view_pair(
            forcing=forcing,
            diagnostic=diagnostic,
            input_table=name_to_index,
            output_table=name_to_index,
            dropped_from_views=True,
        )


class ModelIndex(BaseIndex):
    """Views into the model's (already-narrowed) input/output tensors."""

    def __init__(
        self,
        diagnostic: list[str],
        forcing: list[str],
        name_to_index_model_input: dict[str, int],
        name_to_index_model_output: dict[str, int],
    ) -> None:
        self.input, self.output = _view_pair(
            forcing=forcing,
            diagnostic=diagnostic,
            input_table=name_to_index_model_input,
            output_table=name_to_index_model_output,
            dropped_from_views=False,
        )
