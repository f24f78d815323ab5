"""PyTorch port, the GNN conv at every activation of the reference's
registry, against the JAX package on the CPU.

The GNN conv kernels take every activation that
``anemoi_models_tpu/layers/utils.py`` registers (LeakyReLU, ELU, softplus
and mish among them; the card's cases are in ``tests/test_torch_port_cuda.py``).
Here the plain version the wrapper runs for CPU tensors is held, for each of
them, against ``planned_gnn_conv(..., impl="reference")`` on the processor's
edge set of ``grid_lat=6, mesh_refinements=2`` at C = 16, fp32, within the
reference's output tolerance 2e-5 (``tests/layers/test_commuted.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch import one_torch_thread  # noqa: F401 (autouse)
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.graphs.kernel_plan import build_edge_kernel_plan
from anemoi_models_tpu.layers.utils import _ACTIVATIONS as JAX_ACTIVATIONS
from anemoi_models_tpu.ops.slot_gnn import planned_gnn_conv
from anemoi_models_tpu_torch.layers.utils import _ACTIVATIONS
from anemoi_models_tpu_torch.ops import gnn_conv as gc
from anemoi_models_tpu_torch.ops.edge_attention import csr_from_edge_index

C = 16
OUT = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def case():
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    es = graph[("hidden", "to", "hidden")]
    n = graph["hidden"].num_nodes
    plan = build_edge_kernel_plan(es.edge_index, n, n, block_nodes=32, cap=32, slab_width=168)
    assert len(plan.outlier_src) == 0 and np.all(plan.slot_of_edge >= 0)
    rng = np.random.RandomState(16)
    rowptr, src = (torch.from_numpy(t) for t in csr_from_edge_index(es.edge_index, n, n))
    tree = {f"Dense_{i}": {"kernel": (rng.randn(k, C) * k ** -0.5).astype(np.float32),
                           "bias": (0.1 * rng.randn(C)).astype(np.float32)} for i, k in enumerate([3 * C, C, C])}
    tree["AutocastLayerNorm_0"] = {"LayerNorm_0": {"scale": (1 + 0.1 * rng.randn(C)).astype(np.float32),
                                                   "bias": (0.1 * rng.randn(C)).astype(np.float32)}}
    # x at scale 10: the activations' tails (softplus of +-30) are reached
    return dict(plan=plan, rowptr=rowptr, src=src, tree=tree, x=(10 * rng.randn(1, n, C)).astype(np.float32),
                e=rng.randn(1, es.num_edges, C).astype(np.float32))


def test_kernels_take_every_registered_activation():
    """Every name of both registries has a kernel code, and the two
    registries name the same activations."""
    assert set(_ACTIVATIONS) == set(JAX_ACTIVATIONS)
    assert set(gc._ACT_CODES) == set(_ACTIVATIONS)


@pytest.mark.parametrize("activation", ["LeakyReLU", "ELU", "Softplus", "Mish"])
def test_gnn_conv_activation_matches_jax(case, activation):
    """agg and msg of GNNConv with each activation the kernels took last
    against the JAX package's planned_gnn_conv reference twin."""
    plan, tree = case["plan"], case["tree"]
    agg_ref, edges = planned_gnn_conv(jnp.asarray(case["x"]), jnp.asarray(case["e"]),
                                      jax.tree_util.tree_map(jnp.asarray, tree), plan, activation, impl="reference")
    msg_ref = np.asarray(edges.slots)[:, plan.slot_of_edge]
    params = [torch.tensor(tree[f"Dense_{i}"][k].T if k == "kernel" else tree[f"Dense_{i}"][k])
              for i in range(3) for k in ("kernel", "bias")]
    ln = tree["AutocastLayerNorm_0"]["LayerNorm_0"]
    params += [torch.tensor(ln["scale"]), torch.tensor(ln["bias"])]
    x, e = torch.from_numpy(case["x"]), torch.from_numpy(case["e"])
    with torch.no_grad():
        agg, msg = gc.GNNConv.apply(x, x, e, case["rowptr"], case["src"], activation, *params)
    np.testing.assert_allclose(agg.numpy(), np.asarray(agg_ref), **OUT)
    np.testing.assert_allclose(msg.numpy(), msg_ref, **OUT)
