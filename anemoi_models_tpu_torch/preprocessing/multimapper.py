"""1 -> N variable remapping (``cos_sin``), width-changing.

Counterpart of ``anemoi_models_tpu/preprocessing/multimapper.py``: maps an
angle variable to (cos, sin) columns appended at the internal tensor levels
and back through atan2; also remaps the training loss mask. The width change
is why the ``internal_*`` index levels exist (``config.data.remapped``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from anemoi_models_tpu_torch.preprocessing import BasePreprocessor
from anemoi_models_tpu_torch.preprocessing.mappings import atan2_converter, cos_converter, sin_converter

__all__ = ["Multimapper"]


def _index(idx: list, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=device)


class Multimapper(BasePreprocessor):
    """Remap single variables to 2+ variables (``cos_sin``) and back."""

    supported_methods = {
        method: [f, inv]
        for method, f, inv in zip(["cos_sin"], [[cos_converter, sin_converter]], [atan2_converter])
    }

    def __init__(self, config: Any = None, data_indices: Optional[Any] = None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        self._create_remapping_indices(statistics)
        self._validate_indices()

    def _validate_indices(self) -> None:
        counts = {
            "train-in": len(self.index_training_input),
            "infer-in": len(self.index_inference_input),
            "train-out": len(self.index_training_output),
            "infer-out": len(self.index_inference_output),
            "mappers": len(self.remappers),
        }
        ok = (
            counts["train-in"] == counts["infer-in"] <= counts["mappers"]
            and counts["train-out"] == counts["infer-out"] <= counts["mappers"]
        )
        if not ok:
            raise RuntimeError(f"Multimapper column bookkeeping is inconsistent: {counts}")
        covered = len(set(self.index_training_input + self.indices_keep_training_input))
        if covered != self.num_training_input_vars:
            raise ValueError(
                "Multimapper: some variables listed under config.data.remapped have no "
                "mapping method configured — the internal tensor would carry dead columns."
            )

    def _create_remapping_indices(self, statistics=None) -> None:
        di = self.data_indices
        train_in, infer_in = di.data.input.name_to_index, di.model.input.name_to_index
        train_remapped_in = di.internal_data.input.name_to_index
        infer_remapped_in = di.internal_model.input.name_to_index
        train_remapped_out = di.internal_data.output.name_to_index
        infer_remapped_out = di.internal_model.output.name_to_index
        train_out, infer_out = di.data.output.name_to_index, di.model.output.name_to_index

        self.num_training_input_vars = len(train_in)
        self.num_inference_input_vars = len(infer_in)
        self.num_remapped_training_input_vars = len(train_remapped_in)
        self.num_remapped_inference_input_vars = len(infer_remapped_in)
        self.num_remapped_training_output_vars = len(train_remapped_out)
        self.num_remapped_inference_output_vars = len(infer_remapped_out)
        self.num_training_output_vars = len(train_out)
        self.num_inference_output_vars = len(infer_out)

        self.indices_keep_training_input = [i for k, i in train_in.items() if k in train_remapped_in]
        self.indices_keep_inference_input = [i for k, i in infer_in.items() if k in infer_remapped_in]
        self.indices_keep_training_output = [i for k, i in train_out.items() if k in train_remapped_out]
        self.indices_keep_inference_output = [i for k, i in infer_out.items() if k in infer_remapped_out]

        self.index_training_input, self.index_training_remapped_input = [], []
        self.index_inference_input, self.index_inference_remapped_input = [], []
        self.index_training_output, self.index_training_backmapped_output = [], []
        self.index_inference_output, self.index_inference_backmapped_output = [], []
        self.remappers, self.backmappers = [], []

        for name in train_in:
            method = self.methods.get(name, self.default)
            if method == "none":
                continue
            if method != "cos_sin":
                raise ValueError(f"Multimapper: no such transform '{method}' (variable '{name}')")
            self.index_training_input.append(train_in[name])
            self.index_training_output.append(train_out[name])
            self.index_inference_input.append(infer_in[name])
            self.index_inference_output.append(infer_out.get(name))

            tr_in, in_in, tr_out, in_out = [], [], [], []
            for name_dst in self.method_config[method][name]:
                if name_dst not in train_remapped_in:
                    raise KeyError(
                        f"Multimapper: target column '{name_dst}' for '{name}' was never "
                        f"declared — add '{name}': [...,'{name_dst}'] under config.data.remapped."
                    )
                tr_in.append(train_remapped_in[name_dst])
                tr_out.append(train_remapped_out[name_dst])
                in_in.append(infer_remapped_in[name_dst])
                in_out.append(infer_remapped_out.get(name_dst))
            self.index_training_remapped_input.append(tr_in)
            self.index_inference_remapped_input.append(in_in)
            self.index_training_backmapped_output.append(tr_out)
            self.index_inference_backmapped_output.append(in_out)
            self.remappers.append([cos_converter, sin_converter])
            self.backmappers.append(atan2_converter)

    def transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        if x.shape[-1] == self.num_training_input_vars:
            index, remapped = self.index_training_input, self.index_training_remapped_input
            keep, width = self.indices_keep_training_input, self.num_remapped_training_input_vars
        elif x.shape[-1] == self.num_inference_input_vars:
            index, remapped = self.index_inference_input, self.index_inference_remapped_input
            keep, width = self.indices_keep_inference_input, self.num_remapped_inference_input_vars
        else:
            raise ValueError(
                f"Remapper got a {x.shape[-1]}-wide tensor; expected the training width "
                f"{self.num_training_input_vars} or the inference width {self.num_inference_input_vars}"
            )
        out = torch.zeros(x.shape[:-1] + (width,), dtype=x.dtype, device=x.device)
        out[..., : len(keep)] = x.index_select(-1, _index(keep, x.device))
        for idx_dst, remapper, idx_src in zip(remapped, self.remappers, index):
            if idx_src is not None:
                for jj, ii in enumerate(idx_dst):
                    out[..., ii] = remapper[jj](x[..., idx_src])
        return out

    def inverse_transform(self, x: torch.Tensor, in_place: bool = False) -> torch.Tensor:
        if x.shape[-1] == self.num_remapped_training_output_vars:
            index, remapped = self.index_training_output, self.index_training_backmapped_output
            keep, width = self.indices_keep_training_output, self.num_training_output_vars
        elif x.shape[-1] == self.num_remapped_inference_output_vars:
            index, remapped = self.index_inference_output, self.index_inference_backmapped_output
            keep, width = self.indices_keep_inference_output, self.num_inference_output_vars
        else:
            raise ValueError(
                f"Remapper got a {x.shape[-1]}-wide tensor; expected the training width "
                f"{self.num_remapped_training_output_vars} or the inference width "
                f"{self.num_remapped_inference_output_vars}"
            )
        out = torch.zeros(x.shape[:-1] + (width,), dtype=x.dtype, device=x.device)
        out[..., _index(keep, x.device)] = x[..., : len(keep)]
        for idx_dst, backmapper, idx_src in zip(index, self.backmappers, remapped):
            if idx_dst is not None:
                out[..., idx_dst] = backmapper(x.index_select(-1, _index(idx_src, x.device)))
        return out

    def transform_loss_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """Remap the training loss mask onto the internal output width."""
        index, remapped = self.index_inference_backmapped_output, self.index_inference_output
        keep = self.indices_keep_inference_output
        out = torch.zeros(mask.shape[:-1] + (mask.shape[-1] + len(remapped),), dtype=mask.dtype, device=mask.device)
        out[..., : len(keep)] = mask.index_select(-1, _index(keep, mask.device))
        for idx_src, idx_dst in zip(remapped, index):
            if idx_dst is not None:
                for ii in idx_dst:
                    out[..., ii] = mask[..., idx_src]
        return out
