"""PyTorch port, the multi-step forecast: ``make_rollout_fn``,
``AnemoiModelInterface.predict_rollout`` and ``make_rollout_train_step``
against the JAX package's on the CPU.

Inputs come from numpy seeds and reach both frameworks as numpy arrays; the
parameters are the JAX model's initialisation, perturbed (zero-init
trainables carry no signal). The model is the GraphTransformer of
``helpers_models.make_config`` (one forcing, one diagnostic, C=16, 2
processor layers) on ``grid_lat=6, mesh_refinements=2``, in fp32.
Tolerances: each lead time within 2e-5 * max(1, mean |ref|), the drift
harness of ``tests/models/test_torch_e2e_parity.py`` held against the JAX
rollout; loss traces ``rtol=6e-4`` (``tests/parallel/test_fsdp.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config, make_statistics
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.interface import AnemoiModelInterface as JaxInterface
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu.training import make_optimizer as jax_make_optimizer
from anemoi_models_tpu.training import make_rollout_fn as jax_make_rollout_fn
from anemoi_models_tpu.training import make_rollout_train_step as jax_make_rollout_train_step
from anemoi_models_tpu.training.step import TrainState
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec
from anemoi_models_tpu_torch.training import make_optimizer, make_rollout_fn, make_rollout_train_step
from anemoi_models_tpu_torch.weights import load_flax_params

N_STEPS = 4
STEP_TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    n_grid, n_in = graph["data"].num_nodes, len(di.internal_model.input)
    rng = np.random.RandomState(40)
    x0 = rng.randn(1, 2, 1, n_grid, n_in).astype(np.float32)
    forcings = rng.randn(N_STEPS, 1, 1, n_grid, len(di.internal_model.input.forcing)).astype(np.float32)
    jmodel = JaxModel(model_config=cfg, data_indices=di, graph_data=graph)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x0))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    return dict(graph=graph, cfg=cfg, di=di, jmodel=jmodel, params=params, x0=x0, forcings=forcings)


def _port_model(s):
    model = AnemoiModelEncProcDec(model_config=s["cfg"].to_dict(), data_indices=s["di"], graph_data=s["graph"],
                                  device="cpu")
    model.load_state_dict(load_flax_params(s["params"]), strict=True)
    return model


def _assert_steps_close(got, want):
    assert got.shape == want.shape
    for t in range(want.shape[0]):
        scale = max(1.0, float(np.abs(want[t]).mean()))
        err = float(np.abs(got[t] - want[t]).max())
        assert err <= STEP_TOL * scale, f"lead time {t}: max err {err:.3e} > {STEP_TOL * scale:.3e}"


def test_rollout_matches_jax(setup):
    """Four lead times with random forcings: every prediction and the final
    window against the JAX rollout (lax.scan)."""
    s = setup
    rollout = jax.jit(jax_make_rollout_fn(s["jmodel"], s["di"], N_STEPS))
    x_ref, preds_ref = rollout(s["params"], jnp.asarray(s["x0"]), jnp.asarray(s["forcings"]))
    model = _port_model(s)
    with torch.no_grad():
        x_got, preds = make_rollout_fn(model, s["di"], N_STEPS)(torch.from_numpy(s["x0"]),
                                                                torch.from_numpy(s["forcings"]))
    _assert_steps_close(preds.numpy(), np.asarray(preds_ref))
    _assert_steps_close(x_got.numpy()[None], np.asarray(x_ref)[None])


def test_rollout_without_forcings_raises(setup):
    """A model with forcing variables refuses forcings=None with the JAX
    package's message."""
    s = setup
    with pytest.raises(ValueError) as jax_err:
        jax_make_rollout_fn(s["jmodel"], s["di"], 2)(s["params"], jnp.asarray(s["x0"]), None)
    with pytest.raises(ValueError) as port_err:
        make_rollout_fn(_port_model(s), s["di"], 2)(torch.from_numpy(s["x0"]), None)
    assert str(port_err.value) == str(jax_err.value)


def test_predict_rollout_matches_jax(setup):
    """The serving surface: pre-process, roll out with pre-processed
    forcings, post-process every lead time; against the JAX interface."""
    s = setup
    stats = make_statistics()
    n_in = len(s["di"].data.input.full)
    batch = (stats["mean"][:n_in] + stats["stdev"][:n_in]
             * np.random.RandomState(41).randn(1, 3, s["x0"].shape[3], n_in)).astype(np.float32)
    ref = JaxInterface(config=s["cfg"], graph_data=s["graph"], statistics=stats, data_indices=s["di"])
    want = np.asarray(ref.predict_rollout(jnp.asarray(batch), N_STEPS, jnp.asarray(s["forcings"]), params=s["params"]))
    iface = AnemoiModelInterface(config=s["cfg"], graph_data=s["graph"], statistics=stats, data_indices=s["di"],
                                 device="cpu")
    iface.load_params(s["params"])
    got = iface.predict_rollout(torch.from_numpy(batch), N_STEPS, torch.from_numpy(s["forcings"])).numpy()
    _assert_steps_close(got, want)
    first = iface.predict_step(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(got[0], first)  # the first lead time is predict_step's answer


def test_rollout_train_step_matches_jax(setup):
    """Three steps of make_rollout_train_step (two lead times each, forcings
    read from the truth) + make_optimizer against the JAX package's loss
    trace."""
    s = setup
    n_steps = 2
    rng = np.random.RandomState(42)
    n_grid = s["x0"].shape[3]
    truth = rng.randn(n_steps, 1, 1, n_grid, len(s["di"].internal_model.input)).astype(np.float32)
    targets = rng.randn(n_steps, 1, 1, n_grid, len(s["di"].internal_model.output)).astype(np.float32)
    opt_kw = dict(warmup_steps=1, total_steps=10, weight_decay=0.1, clip_norm=1.0)

    jopt = jax_make_optimizer(1e-3, **opt_kw)
    _, jstep = jax_make_rollout_train_step(s["jmodel"], s["di"], jopt, n_steps)
    jstep = jax.jit(jstep)
    state = TrainState(params=s["params"], opt_state=jopt.init(s["params"]), step=jnp.zeros((), jnp.int32))
    want = []
    for _ in range(3):
        state, loss = jstep(state, jnp.asarray(s["x0"]), jnp.asarray(truth), jnp.asarray(targets))
        want.append(float(loss))

    model = _port_model(s)
    step = make_rollout_train_step(model, s["di"], make_optimizer(model.parameters(), 1e-3, **opt_kw), n_steps)
    got = [step(*map(torch.from_numpy, (s["x0"], truth, targets))).item() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=6e-4, atol=2e-5)
    assert want[-1] < want[0]
