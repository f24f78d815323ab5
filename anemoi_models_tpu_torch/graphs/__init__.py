"""Graph builders and the static graph container.

The port's own copies of the JAX package's ``graphs/build.py`` and
``graphs/container.py``: host-side numpy and scipy code that builds the
encoder, processor and decoder edge sets of the enc-proc-dec model and the
level pyramid of the hierarchical model.
"""

from anemoi_models_tpu_torch.graphs.build import build_enc_proc_dec_graph, build_hierarchical_graph, nodes_from_coords
from anemoi_models_tpu_torch.graphs.container import EdgeSet, HeteroGraph, NodeSet

__all__ = ["EdgeSet", "HeteroGraph", "NodeSet", "build_enc_proc_dec_graph", "build_hierarchical_graph",
           "nodes_from_coords"]
