"""PyTorch port, the GNN flavor at every width and MLP depth: which kernel
route the card takes (``ops.gnn_conv._gnn_route``), and the GNN model at a
width the fused kernel does not take and with deeper MLPs, against the JAX
package on the CPU.

On the card, C in {32, 64, 128, 256} with three Dense layers runs the fused
kernels of ``csrc/gnn_conv.cu``; every other width (padded with zero
columns to a multiple of 8 where it is not one) and every other depth the
layered route of ``csrc/gnn_conv_layered.cu``; both compute
``gnn_conv_plain``'s function, which runs here. Sizes: ``grid_lat=6,
mesh_refinements=2``, 2 processor layers. Tolerances follow the reference's
tests: outputs 2e-5 (``tests/layers/test_commuted.py``), fp32 gradients 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu.training import weighted_mse as jax_weighted_mse
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec
from anemoi_models_tpu_torch.ops.gnn_conv import _gnn_route
from anemoi_models_tpu_torch.training import weighted_mse
from anemoi_models_tpu_torch.weights import load_flax_params, to_flax_params

OUT = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("n_dense", [3, 4, 5])
def test_gnn_route(n_dense):
    """Fused exactly for C in {32, 64, 128, 256} with three Dense layers,
    layered for every other C up to 1024."""
    for c in range(1, 1025):
        want = "fused" if c in (32, 64, 128, 256) and n_dense == 3 else "layered"
        assert _gnn_route(c, n_dense) == want, (c, n_dense)


@pytest.mark.parametrize("c", [1, 4, 12, 100, 1020, 1023])
def test_gnn_route_refuses_widths_off_the_16_byte_rule(c):
    """A width off the GEMM's 16-byte rule (C % 8 != 0) is no longer refused:
    it takes the layered route, padded to the next multiple of 8
    (``ops/gnn_conv.py:_padded``); only a width below 1 is refused."""
    assert _gnn_route(c, 3) == "layered"
    with pytest.raises(ValueError, match="C > 0"):
        _gnn_route(0, 3)


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("channels, extra", [(48, 1), (512, 1), (12, 0)])
def test_gnn_model_matches_jax(channels, extra):
    """The GNN flavor (GNN mappers and processor, every edge MLP with
    ``mlp_extra_layers`` more hidden Dense) at a width the fused kernel does
    not take (C = 12 also off the 16-byte rule): forward (2e-5) and every parameter's gradient of the MSE loss
    (5e-4) against the JAX model, whose deeper MLPs run its jnp twin."""
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    cfg = make_config("gnn", num_channels=channels)
    for part in ("encoder", "processor", "decoder"):
        cfg.model[part]["mlp_extra_layers"] = extra
    di = IndexCollection(cfg, dict(VARS))
    rng = np.random.RandomState(60 + extra)
    n_grid = graph["data"].num_nodes
    x = rng.randn(1, 2, 1, n_grid, len(di.internal_model.input)).astype(np.float32)
    y = rng.randn(1, 1, n_grid, len(di.internal_model.output)).astype(np.float32)
    jmodel = JaxModel(model_config=cfg, data_indices=di, graph_data=graph)
    params = jax.jit(jmodel.init)(jax.random.key(channels), jnp.asarray(x))
    # perturbed: zero-init trainables carry no signal
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)

    def loss(p):
        pred = jmodel.apply(p, jnp.asarray(x))
        return jax_weighted_mse(pred, jnp.asarray(y)), pred

    (loss_ref, pred_ref), grads_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    model = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph, device="cpu")
    model.load_state_dict(load_flax_params(params), strict=True)
    assert model.processor.proc[0].blocks[0].conv.mlp.num_dense == 3 + extra
    out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(pred_ref), **OUT)
    loss_port = weighted_mse(out, torch.from_numpy(y))
    loss_port.backward()
    np.testing.assert_allclose(loss_port.item(), float(loss_ref), **OUT)
    got = _flat(to_flax_params({k: p.grad for k, p in model.named_parameters()}))
    want = _flat(grads_ref)
    assert got.keys() == want.keys()
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, err_msg=name, **GRAD)
