"""PyTorch port, the GNN conv at the production width (C = 1024, the layered
route's width on the card) against the JAX package on the CPU.

On the card C = 1024 runs ``csrc/gnn_conv_layered.cu``; here ``GNNConv``
runs its plain version, ``gnn_conv_plain``, whose function and rounding
points the kernels hold to. The reference is ``planned_gnn_conv(...,
impl="reference")``, the JAX twin of the Pallas kernel, which takes any
MLP depth (``anemoi_models_tpu/ops/slot_gnn.py:128-129`` limits only the
Pallas kernel to three Dense). Sizes: the hidden self-graph of
``grid_lat=6, mesh_refinements=2`` (162 nodes, 1,260 edges), as
``tests/test_torch_port_flavors.py`` uses.

Tolerances. fp32: 2e-5 (the reference's, ``tests/layers/test_commuted.py``);
the two sum the first Dense in another order (the port factors the per-node
terms, JAX takes one K = 3C dot). bf16: normwise, ``max |port - JAX| <=
2e-2 * max(1, max |JAX|)``, the card's bf16 bound: JAX rounds to bf16 after
every Dense, before the activation, and rounds ``agg`` to bf16, where the
port rounds after the activation only and keeps ``agg`` in fp32, so a value
lands a few bf16 steps (2^-8 relative each) apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch import one_torch_thread  # noqa: F401 (autouse)
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.graphs.kernel_plan import build_edge_kernel_plan
from anemoi_models_tpu.ops.slot_gnn import planned_gnn_conv
from anemoi_models_tpu_torch.ops import gnn_conv as gc
from anemoi_models_tpu_torch.ops.edge_attention import csr_from_edge_index

C = 1024
OUT = dict(atol=2e-5, rtol=2e-5)
BF16_NORMWISE = 2e-2


@pytest.fixture(scope="module")
def case():
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    plan = build_edge_kernel_plan(es.edge_index, n, n, block_nodes=32, cap=32, slab_width=168)
    assert len(plan.outlier_src) == 0 and np.all(plan.slot_of_edge >= 0)
    rng = np.random.RandomState(1024)
    rowptr, src = (torch.from_numpy(t) for t in csr_from_edge_index(es.edge_index, n, n))
    return dict(plan=plan, rowptr=rowptr, src=src, x=rng.randn(1, n, C).astype(np.float32),
                e=rng.randn(1, es.num_edges, C).astype(np.float32), rng=rng)


def _tree(rng, n_dense):
    """A flax MLP tree at width C with n_dense Dense layers (fan-in scaled)."""
    tree = {f"Dense_{i}": {"kernel": (rng.randn(k, C) * k ** -0.5).astype(np.float32),
                           "bias": (0.1 * rng.randn(C)).astype(np.float32)}
            for i, k in enumerate([3 * C] + [C] * (n_dense - 1))}
    ln = {"scale": (1 + 0.1 * rng.randn(C)).astype(np.float32), "bias": (0.1 * rng.randn(C)).astype(np.float32)}
    return {**tree, "AutocastLayerNorm_0": {"LayerNorm_0": ln}}


def _port_params(tree):
    n = sum(k.startswith("Dense_") for k in tree)
    params = [torch.tensor(tree[f"Dense_{i}"][k].T if k == "kernel" else tree[f"Dense_{i}"][k])
              for i in range(n) for k in ("kernel", "bias")]
    ln = tree["AutocastLayerNorm_0"]["LayerNorm_0"]
    return params + [torch.tensor(ln["scale"]), torch.tensor(ln["bias"])]


def _normwise(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("n_dense", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gnn_conv_at_production_width_matches_jax(case, dtype, n_dense):
    """agg and msg of GNNConv at C = 1024 (three Dense, and four: one extra
    hidden Dense) against planned_gnn_conv's reference twin; msg maps from
    the slot layout back to edge order."""
    plan = case["plan"]
    tree = _tree(np.random.RandomState(n_dense), n_dense)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    agg_ref, edges = planned_gnn_conv(jnp.asarray(case["x"], jdt), jnp.asarray(case["e"], jdt),
                                      jax.tree_util.tree_map(jnp.asarray, tree), plan, "SiLU", impl="reference")
    msg_ref = np.asarray(edges.slots.astype(jnp.float32))[:, plan.slot_of_edge]
    agg_ref = np.asarray(agg_ref.astype(jnp.float32))
    x, e = (torch.from_numpy(case[k]).to(tdt) for k in ("x", "e"))
    with torch.no_grad():
        agg, msg = gc.GNNConv.apply(x, x, e, case["rowptr"], case["src"], "SiLU", *_port_params(tree))
    assert agg.dtype == torch.float32 and msg.dtype == tdt
    assert agg.shape == (1, x.shape[1], C) and msg.shape == e.shape
    if dtype == "float32":
        np.testing.assert_allclose(agg.numpy(), agg_ref, **OUT)
        np.testing.assert_allclose(msg.numpy(), msg_ref, **OUT)
    else:
        assert _normwise(agg, agg_ref) <= BF16_NORMWISE
        assert _normwise(msg.float(), msg_ref) <= BF16_NORMWISE

