"""The variable routing table.

The port's own copy of the JAX package's ``data_indices`` (``collection.py``,
``index.py``, ``tensor.py``): host-side numpy code that resolves variable
names into the index arrays the model and the processors route by.
"""

from anemoi_models_tpu_torch.data_indices.collection import IndexCollection
from anemoi_models_tpu_torch.data_indices.index import BaseIndex, DataIndex, ModelIndex
from anemoi_models_tpu_torch.data_indices.tensor import BaseTensorIndex, InputTensorIndex, OutputTensorIndex

__all__ = [
    "IndexCollection",
    "BaseIndex",
    "DataIndex",
    "ModelIndex",
    "BaseTensorIndex",
    "InputTensorIndex",
    "OutputTensorIndex",
]
