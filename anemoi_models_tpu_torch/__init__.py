"""anemoi-models-tpu, PyTorch and CUDA port.

The encoder-processor-decoder model in its three processor families
(GraphTransformer, GNN, sliding-window Transformer) and the hierarchical
model, their serving path, train step and data pipeline (normalizer,
imputers, remappers, output boundings), ported from the JAX package ``anemoi_models_tpu`` (which
stays the reference) to PyTorch, with every Pallas kernel rewritten by hand
in CUDA C++ for Hopper: the edge-attention forward (``csrc/edge_attention.cu``)
and backward (``csrc/edge_attention_bwd.cu``), bound in
``ops/edge_attention.py``; the GNN edge-MLP conv (``csrc/gnn_conv.cu``,
``ops/gnn_conv.py``); band-masked attention (``csrc/flash_attention.cu``,
``ops/flash_attention.py``).

Module paths mirror the JAX package's, so each module's counterpart is easy
to find. The package imports nothing of the JAX package, nor jax or flax: it
carries its own copies of the host-side code it needs (the graph builders,
the variable routing table, the config utilities). Its entry points build on
the card (``device="cuda"``) unless the caller names another device.
"""

__version__ = "0.3.0"
