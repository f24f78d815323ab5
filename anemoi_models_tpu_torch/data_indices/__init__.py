"""The variable routing table.

Framework-free host code: the port uses the JAX package's own
(``anemoi_models_tpu.data_indices``), which imports neither jax nor flax; this
module only makes it available under the port's module paths.
"""

from anemoi_models_tpu.data_indices import IndexCollection

__all__ = ["IndexCollection"]
