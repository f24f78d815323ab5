"""anemoi-models-tpu, PyTorch and CUDA port.

The GraphTransformer encoder-processor-decoder, its serving path and its
train step, ported from the JAX package ``anemoi_models_tpu`` (which stays
the reference) to PyTorch, with the Pallas edge-attention kernels rewritten
by hand in CUDA C++ for Hopper: the forward in ``csrc/edge_attention.cu``,
the backward in ``csrc/edge_attention_bwd.cu``, both bound in
``ops/edge_attention.py``.

Module paths mirror the JAX package's, so each module's counterpart is easy
to find. The package imports nothing of the JAX package, nor jax or flax: it
carries its own copies of the host-side code it needs (the graph builders,
the variable routing table, the config utilities). Its entry points build on
the card (``device="cuda"``) unless the caller names another device.
"""

__version__ = "0.2.0"
