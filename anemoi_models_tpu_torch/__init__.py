"""anemoi-models-tpu, PyTorch and CUDA port.

The serving path of the GraphTransformer encoder-processor-decoder, ported
from the JAX package ``anemoi_models_tpu`` (which stays the reference) to
PyTorch, with the Pallas edge-attention kernel rewritten by hand in CUDA C++
for Hopper (``csrc/edge_attention.cu``, bound in ``ops/edge_attention.py``).

Module paths mirror the JAX package's, so each module's counterpart is easy
to find. The graph builders, the variable routing table and the native
graph-sorting helpers are framework-free and are imported from the JAX
package (``anemoi_models_tpu.graphs``, ``.data_indices``, ``.native``); this
package itself never imports ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
