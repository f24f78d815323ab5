"""Graph builders and the static graph container.

They are host-side numpy code, free of any framework, so the port uses the
JAX package's own (``anemoi_models_tpu.graphs``: ``build.py``,
``container.py``), which import neither jax nor flax; this module only makes
them available under the port's module paths.
"""

from anemoi_models_tpu.graphs.build import build_enc_proc_dec_graph
from anemoi_models_tpu.graphs.container import EdgeSet, HeteroGraph, NodeSet

__all__ = ["EdgeSet", "HeteroGraph", "NodeSet", "build_enc_proc_dec_graph"]
