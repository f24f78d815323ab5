"""PyTorch port, the AIFS data path against the JAX package on the CPU: the
output boundings, the variable mappings, the Monomapper, Multimapper and
Remapper dispatch, the four imputers, the processor pipeline's fit and
state, and a tiny model served and trained through the whole pipeline
(normalizer, imputer, remapper, boundings), including a JAX checkpoint with
imputer state.

Inputs come from numpy seeds and reach both frameworks as numpy arrays.
Tolerances: boundings bit for bit; mappings 1e-6; processors at their
elementwise arithmetic's (1e-6); ``predict_step`` 2e-5
(``tests/layers/test_commuted.py``); loss traces rtol 6e-4
(``tests/parallel/test_fsdp.py``). The model is the GraphTransformer of
``helpers_models.make_config`` (C = 16, 2 processor layers) on
``grid_lat=6, mesh_refinements=2``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import make_config
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.data_indices import IndexCollection as JaxIndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.interface import AnemoiModelInterface as JaxInterface
from anemoi_models_tpu.layers import bounding as jb
from anemoi_models_tpu.preprocessing import Processors as JaxProcessors
from anemoi_models_tpu.preprocessing import imputer as jimp
from anemoi_models_tpu.preprocessing import mappings as jmap
from anemoi_models_tpu.preprocessing.monomapper import Monomapper as JaxMonomapper
from anemoi_models_tpu.preprocessing.multimapper import Multimapper as JaxMultimapper
from anemoi_models_tpu.preprocessing.remapper import Remapper as JaxRemapper
from anemoi_models_tpu.training import WeightedMSELoss as JaxWeightedMSELoss
from anemoi_models_tpu.training import make_optimizer as jax_make_optimizer
from anemoi_models_tpu.training import make_train_step as jax_make_train_step
from anemoi_models_tpu.utils import DotDict
from anemoi_models_tpu_torch.data_indices import IndexCollection
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.layers import bounding as tb
from anemoi_models_tpu_torch.preprocessing import Processors
from anemoi_models_tpu_torch.preprocessing import imputer as timp
from anemoi_models_tpu_torch.preprocessing import mappings as tmap
from anemoi_models_tpu_torch.preprocessing.monomapper import Monomapper
from anemoi_models_tpu_torch.preprocessing.multimapper import Multimapper
from anemoi_models_tpu_torch.preprocessing.remapper import Remapper
from anemoi_models_tpu_torch.training import WeightedMSELoss, loss_mask, make_optimizer, make_train_step

OUT = dict(atol=2e-5, rtol=2e-5)
ELEM = dict(atol=1e-6, rtol=1e-6)
NAME_TO_INDEX = {"a": 0, "b": 1, "total": 2, "c": 3}

# the AIFS-style variables: a forcing, prognostic fields with a land-masked
# sst, cloud cover, precipitation and its convective part, a diagnostic
AIFS_VARS = {"lsm": 0, "z_500": 1, "sst": 2, "tcc": 3, "tp": 4, "cp": 5, "t2m": 6}
BOUNDING = [
    {"_target_": "anemoi.models.layers.bounding.ReluBounding", "variables": ["tp"]},
    {"_target_": "anemoi.models.layers.bounding.HardtanhBounding", "variables": ["tcc"], "min_val": 0.0,
     "max_val": 1.0},
    {"_target_": "anemoi.models.layers.bounding.FractionBounding", "variables": ["cp"], "min_val": 0.0,
     "max_val": 1.0, "total_var": "tp"},
    {"_target_": "anemoi.models.layers.bounding.LeakyReluBounding", "variables": ["z_500"]},
]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# boundings and mappings
# ---------------------------------------------------------------------------


def _bounding_pair(kind):
    kw = dict(name_to_index=NAME_TO_INDEX)
    if kind == "relu":
        return [(jb.ReluBounding(variables=["a", "b"], **kw), tb.ReluBounding(variables=["a", "b"], **kw))]
    if kind == "leaky":
        return [(jb.LeakyReluBounding(variables=["a"], **kw), tb.LeakyReluBounding(variables=["a"], **kw))]
    if kind == "hardtanh":
        args = dict(variables=["a", "c"], min_val=-0.5, max_val=0.75, **kw)
        return [(jb.HardtanhBounding(**args), tb.HardtanhBounding(**args))]
    if kind == "fraction":
        args = dict(variables=["b"], min_val=0.0, max_val=1.0, total_var="total", **kw)
        return [(jb.FractionBounding(**args), tb.FractionBounding(**args))]
    # config order: a ReLU on the total before the fraction of it, and the other way round
    return _bounding_pair("relu") + _bounding_pair("fraction") + _bounding_pair("leaky") + _bounding_pair("hardtanh")


@pytest.mark.parametrize("kind", ["relu", "leaky", "hardtanh", "fraction", "chain"])
def test_bounding_matches_jax_bitwise(kind):
    """Each bounding, and all four in config order, bit for bit; the port's
    bounding builds a new tensor and is differentiable (no in-place write
    into a tensor autograd saved)."""
    x = np.random.RandomState(1).randn(2, 3, 17, 4).astype(np.float32)
    want, got = jnp.asarray(x), torch.tensor(x, requires_grad=True)
    out = got
    for jax_b, port_b in _bounding_pair(kind):
        want, out = jax_b(want), port_b(out)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    out.square().sum().backward()
    assert torch.isfinite(got.grad).all() and np.array_equal(got.detach().numpy(), x)


def test_mappings_match_jax():
    """Every converter, boxcox and its inverse at lambda = 0.5 and 0 too."""
    rng = np.random.RandomState(2)
    pos = (rng.rand(5, 33) * 4 + 0.05).astype(np.float32)
    angle = (rng.rand(5, 33) * 720 - 180).astype(np.float32)
    small = (rng.rand(5, 33) * 1.5).astype(np.float32)
    cases = [("noop", angle, {}), ("cos_converter", angle, {}), ("sin_converter", angle, {}),
             ("log1p_converter", pos, {}), ("sqrt_converter", pos, {}), ("expm1_converter", small, {}),
             ("square_converter", angle / 100, {}), ("boxcox_converter", pos, {}),
             ("boxcox_converter", pos, {"lambd": 0}), ("inverse_boxcox_converter", small, {}),
             ("inverse_boxcox_converter", small, {"lambd": 0})]
    for name, x, kw in cases:
        np.testing.assert_allclose(getattr(tmap, name)(torch.from_numpy(x), **kw).numpy(),
                                   np.asarray(getattr(jmap, name)(jnp.asarray(x), **kw)), err_msg=name, **ELEM)
    pairs = np.stack([np.cos(np.deg2rad(angle)), np.sin(np.deg2rad(angle))], axis=-1).astype(np.float32)
    np.testing.assert_allclose(tmap.atan2_converter(torch.from_numpy(pairs)).numpy(),
                               np.asarray(jmap.atan2_converter(jnp.asarray(pairs))), atol=1e-4, rtol=1e-6)


# ---------------------------------------------------------------------------
# remappers
# ---------------------------------------------------------------------------


def _indices(cfg, n2i):
    return JaxIndexCollection(DotDict(cfg), dict(n2i)), IndexCollection(DotDict(cfg), dict(n2i))


def test_monomapper_matches_jax():
    """log1p, sqrt and boxcox columns at the training and inference widths,
    both directions."""
    n2i = {"x": 0, "y": 1, "f": 2, "w": 3, "d": 4}
    jdi, tdi = _indices({"data": {"forcing": ["f"], "diagnostic": ["d"]}}, n2i)
    cfg = {"log1p": ["x"], "sqrt": ["y", "f"], "boxcox": ["w"]}
    jm, tm = JaxMonomapper(config=DotDict(cfg), data_indices=jdi), Monomapper(config=DotDict(cfg), data_indices=tdi)
    rng = np.random.RandomState(3)
    for width in (len(jdi.data.input.full), len(jdi.model.input.full)):
        x = (rng.rand(2, 3, 11, width) * 5).astype(np.float32)
        np.testing.assert_allclose(tm.transform(torch.from_numpy(x)).numpy(), np.asarray(jm.transform(jnp.asarray(x))),
                                   **ELEM)
    for width in (len(jdi.data.output.full), len(jdi.model.output.full)):
        y = (rng.rand(2, 11, width) * 2).astype(np.float32)
        np.testing.assert_allclose(tm.inverse_transform(torch.from_numpy(y)).numpy(),
                                   np.asarray(jm.inverse_transform(jnp.asarray(y))), **ELEM)
    with pytest.raises(ValueError, match="wide tensor"):
        tm.transform(torch.zeros(2, 9))


def test_multimapper_matches_jax():
    """cos_sin: transform, inverse and transform_loss_mask at both widths."""
    n2i = {"x": 0, "d": 1, "f": 2, "y": 3}
    cfg = {"data": {"forcing": ["f"], "diagnostic": [], "remapped": {"d": ["cos_d", "sin_d"]}}}
    jdi, tdi = _indices(cfg, n2i)
    mcfg = DotDict({"cos_sin": {"d": ["cos_d", "sin_d"]}})
    jm, tm = JaxMultimapper(config=mcfg, data_indices=jdi), Multimapper(config=mcfg, data_indices=tdi)
    rng = np.random.RandomState(4)
    for width in (len(jdi.data.input.full), len(jdi.model.input.full)):
        x = (rng.rand(2, 7, width) * 360).astype(np.float32)
        np.testing.assert_allclose(tm.transform(torch.from_numpy(x)).numpy(), np.asarray(jm.transform(jnp.asarray(x))),
                                   **ELEM)
    for width in (len(jdi.internal_data.output.full), len(jdi.internal_model.output.full)):
        y = rng.randn(2, 7, width).astype(np.float32)
        np.testing.assert_allclose(tm.inverse_transform(torch.from_numpy(y)).numpy(),
                                   np.asarray(jm.inverse_transform(jnp.asarray(y))), atol=1e-4, rtol=1e-6)
    mask = (rng.rand(7, len(jdi.model.output.full)) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(tm.transform_loss_mask(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jm.transform_loss_mask(jnp.asarray(mask))))


def test_remapper_dispatch_matches_jax():
    """The same class for mono, multi and empty configs; the same errors for
    a mix of kinds and for unknown methods."""
    n2i = {"x": 0, "d": 1}
    jdi, tdi = _indices({"data": {"forcing": [], "diagnostic": [], "remapped": {"d": ["cos_d", "sin_d"]}}}, n2i)
    mdi, ndi = _indices({"data": {"forcing": [], "diagnostic": []}}, n2i)
    for cfg, jax_di, port_di in (({"log1p": ["x"]}, mdi, ndi), ({}, mdi, ndi),
                                 ({"cos_sin": {"d": ["cos_d", "sin_d"]}}, jdi, tdi)):
        got = Remapper(config=DotDict(cfg), data_indices=port_di)
        want = JaxRemapper(config=DotDict(cfg), data_indices=jax_di)
        assert type(got).__name__ == type(want).__name__
    for cfg in ({"cos_sin": {"d": ["cos_d", "sin_d"]}, "log1p": ["x"]}, {"nope": ["x"]}):
        with pytest.raises(Exception) as jax_err:
            JaxRemapper(config=DotDict(cfg), data_indices=jdi)
        with pytest.raises(type(jax_err.value)) as port_err:
            Remapper(config=DotDict(cfg), data_indices=tdi)
        assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# imputers
# ---------------------------------------------------------------------------

IMP_N2I = {"x": 0, "y": 1, "z": 2, "q": 3, "other": 4}
IMP_STATS = {"mean": np.array([1.0, 2.0, 3.0, 4.5, 3.0]), "maximum": np.array([11.0, 10.0, 10.0, 10.0, 10.0]),
             "minimum": np.array([1.0, 1.0, 1.0, 1.0, 1.0])}


@pytest.mark.parametrize("kind", ["InputImputer", "ConstantImputer", "DynamicInputImputer", "DynamicConstantImputer"])
def test_imputer_matches_jax(kind):
    """Transform at the training and the inference widths, the NaN mask and
    loss_mask_training, and the inverse re-inserting NaNs at both output
    widths: the same values and the same NaN positions as JAX."""
    jdi, tdi = _indices({"data": {"forcing": ["z"], "diagnostic": ["other"]}}, IMP_N2I)
    cfg = ({"default": "none", "mean": ["y"], "maximum": ["x"], "minimum": ["q"]} if "Input" in kind
           else {"default": "none", 0: ["x"], 3.5: ["y", "q"]})
    stats = IMP_STATS if "Input" in kind else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jimpt = getattr(jimp, kind)(config=DotDict(cfg), data_indices=jdi, statistics=stats)
        timpt = getattr(timp, kind)(config=DotDict(cfg), data_indices=tdi, statistics=stats)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 2, 9, 5).astype(np.float32)
    x[..., rng.rand(9, 5) < 0.3] = np.nan
    jimpt.fit(jnp.asarray(x))
    timpt.fit(torch.from_numpy(x))
    for cols in ([0, 1, 2, 3, 4], [0, 1, 2, 3]):  # the training and the inference input widths
        got = timpt.transform(torch.from_numpy(x[..., cols])).numpy()
        want = np.asarray(jimpt.transform(jnp.asarray(x[..., cols])))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **ELEM)
    np.testing.assert_array_equal(_np(timpt.loss_mask_training), np.asarray(jimpt.loss_mask_training))
    if "Dynamic" not in kind:
        np.testing.assert_array_equal(_np(timpt.nan_locations), np.asarray(jimpt.nan_locations))
    for width in (len(jdi.data.output.full), len(jdi.model.output.full)):
        y = rng.randn(2, 9, width).astype(np.float32)
        got = timpt.inverse_transform(torch.from_numpy(y)).numpy()
        want = np.asarray(jimpt.inverse_transform(jnp.asarray(y)))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **ELEM)


def test_processors_fit_threads_transforms_and_state_round_trips():
    """Processors.fit threads each processor's transform into the next (an
    imputer after a remapper sees the remapped width), as JAX's does; the
    state dict round-trips into a fresh pipeline, in the port's form and in
    the JAX package's (numpy arrays)."""
    n2i = {"x": 0, "y": 1, "f": 2}
    jdi, tdi = _indices({"data": {"forcing": ["f"], "diagnostic": []}}, n2i)
    stats = {"mean": np.array([0.5, 1.0, 2.0]), "stdev": np.array([2.0, 1.0, 1.0]),
             "minimum": np.zeros(3), "maximum": np.ones(3) * 4}

    def build(ns, di):
        norm = ns["norm"](config=DotDict({"default": "mean-std"}), data_indices=di, statistics=stats)
        mono = ns["mono"](config=DotDict({"sqrt": ["y"]}), data_indices=di)
        imp = ns["imp"](config=DotDict({"default": "none", "mean": ["x", "y"]}), data_indices=di, statistics=stats)
        return [["normalizer", norm], ["remapper", mono], ["imputer", imp]]

    from anemoi_models_tpu.preprocessing.normalizer import InputNormalizer as JaxNorm
    from anemoi_models_tpu_torch.preprocessing.normalizer import InputNormalizer

    x = (np.random.RandomState(6).rand(1, 2, 8, 3) * 3 + 1).astype(np.float32)
    x[0, :, 3, 0] = np.nan
    jpre = JaxProcessors(build({"norm": JaxNorm, "mono": JaxMonomapper, "imp": jimp.InputImputer}, jdi))
    tprocs = build({"norm": InputNormalizer, "mono": Monomapper, "imp": timp.InputImputer}, tdi)
    tpre = Processors(tprocs)
    jpre.fit(jnp.asarray(x))
    tpre.fit(torch.from_numpy(x))
    np.testing.assert_allclose(tpre(torch.from_numpy(x)).numpy(), np.asarray(jpre(jnp.asarray(x))), **ELEM)
    state = tpre.state_dict()
    assert set(state) == {"imputer"} and set(state["imputer"]) == {"nan_locations", "loss_mask_training"}
    for source in (state, {k: {n: np.asarray(v) for n, v in s.items()} for k, s in jpre.state_dict().items()}):
        fresh = Processors(build({"norm": InputNormalizer, "mono": Monomapper, "imp": timp.InputImputer}, tdi))
        fresh.load_state_dict(source)
        for name in ("nan_locations", "loss_mask_training"):
            np.testing.assert_array_equal(getattr(fresh.processors["imputer"], name).numpy(),
                                          state["imputer"][name].numpy())
    with pytest.raises(ValueError, match="does not have"):
        tpre.load_state_dict({"ghost": {}})


# ---------------------------------------------------------------------------
# a model through the whole pipeline
# ---------------------------------------------------------------------------


def aifs_config():
    """make_config's GraphTransformer under the AIFS data path: normalizer,
    an InputImputer on sst, a log1p Monomapper on tp and cp, and the four
    boundings in config order."""
    cfg = make_config("graphtransformer", bounding=BOUNDING)
    cfg.data.forcing, cfg.data.diagnostic = ["lsm"], ["t2m"]
    cfg.data.processors = {
        "normalizer": {"_target_": "anemoi.models.preprocessing.normalizer.InputNormalizer",
                       "config": {"default": "mean-std", "std": ["tp", "cp"], "none": ["tcc"]}},
        "imputer": {"_target_": "anemoi.models.preprocessing.imputer.InputImputer",
                    "config": {"default": "none", "mean": ["sst"]}},
        "remapper": {"_target_": "anemoi.models.preprocessing.remapper.Remapper",
                     "config": {"log1p": ["tp", "cp"]}},
    }
    return cfg


def aifs_statistics():
    n = len(AIFS_VARS)
    return {"mean": np.array([0.5, 5.0, 0.3, 0.5, 1.0, 0.5, 2.0]), "stdev": np.array([0.5, 2.0, 1.0, 0.3, 1.5, 1.5, 1.0]),
            "minimum": np.zeros(n), "maximum": np.ones(n) * 10}


def aifs_batch(n_grid, seed=7, steps=3):
    """(1, steps, grid, input vars) physical values at the model's input
    width (the diagnostic dropped): precipitation and cloud cover in their
    ranges, sst NaN on a seeded land mask."""
    rng = np.random.RandomState(seed)
    x = rng.randn(1, steps, n_grid, len(AIFS_VARS)).astype(np.float32)
    x[..., AIFS_VARS["tp"]] = rng.gamma(1.0, 1.0, (1, steps, n_grid))
    x[..., AIFS_VARS["cp"]] = x[..., AIFS_VARS["tp"]] * rng.rand(1, steps, n_grid)
    x[..., AIFS_VARS["tcc"]] = rng.rand(1, steps, n_grid)
    land = np.random.RandomState(seed + 100).rand(n_grid) < 0.3
    x[..., AIFS_VARS["lsm"]] = land
    x[:, :, land, AIFS_VARS["sst"]] = np.nan
    return np.delete(x, AIFS_VARS["t2m"], axis=-1), land


@pytest.fixture(scope="module")
def aifs():
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    cfg = aifs_config()
    jdi = JaxIndexCollection(cfg, dict(AIFS_VARS))
    stats = aifs_statistics()
    batch, land = aifs_batch(graph["data"].num_nodes)
    jax_iface = JaxInterface(config=cfg, graph_data=graph, statistics=stats, data_indices=jdi)
    rng = np.random.RandomState(8)
    params = jax.jit(jax_iface.model.init)(jax.random.key(0), jax_iface.example_input())
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    jax_iface.params = params
    jax_iface.fit_processors(jnp.asarray(batch))
    return dict(graph=graph, cfg=cfg, jdi=jdi, stats=stats, batch=batch, land=land, jax_iface=jax_iface,
                params=params)


def _port_iface(s):
    iface = AnemoiModelInterface(config=s["cfg"], graph_data=s["graph"], statistics=s["stats"],
                                 data_indices=IndexCollection(s["cfg"], dict(AIFS_VARS)), device="cpu")
    iface.load_params(s["params"])
    return iface


def test_aifs_pipeline_predict_step_matches_jax(aifs):
    """fit_processors then predict_step through normalizer, imputer,
    remapper, model and boundings: within 2e-5 of JAX, NaN exactly at the
    imputer's land points, the bounded variables within their bounds."""
    s = aifs
    want = np.asarray(s["jax_iface"].make_predict_fn()(s["params"], jnp.asarray(s["batch"])))
    iface = _port_iface(s)
    iface.fit_processors(torch.from_numpy(s["batch"]))
    got = iface.predict_step(torch.from_numpy(s["batch"])).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **OUT)
    out_n2i = iface.data_indices.model.output.name_to_index
    sst = got[..., out_n2i["sst"]]
    np.testing.assert_array_equal(np.isnan(sst[0, 0]), s["land"])
    assert np.isfinite(np.delete(got, out_n2i["sst"], axis=-1)).all()
    tp, cp, tcc = (got[..., out_n2i[v]] for v in ("tp", "cp", "tcc"))
    assert (tp >= 0).all() and (tcc >= 0).all() and (tcc <= 1).all() and (cp >= 0).all()


def test_aifs_train_trace_with_loss_mask_matches_jax(aifs):
    """Four make_train_step steps with the imputer's loss mask
    (training.loss_mask of the fitted pipeline) through WeightedMSELoss,
    against the JAX loss trace at rtol 6e-4."""
    s = aifs
    iface = _port_iface(s)
    iface.fit_processors(torch.from_numpy(s["batch"]))
    mask = loss_mask(iface.pre_processors)
    jmask = np.asarray(s["jax_iface"].pre_processors.processors["imputer"].loss_mask_training)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert (mask == 0).any()
    pre = s["jax_iface"].pre_processors(jnp.asarray(s["batch"]))
    x = np.array(pre)[:, :2, None]
    y = np.random.RandomState(9).randn(1, 1, x.shape[3], len(s["jdi"].internal_model.output)).astype(np.float32)
    opt_kw = dict(warmup_steps=1, total_steps=10, weight_decay=0.1, clip_norm=1.0)
    jopt = jax_make_optimizer(1e-3, **opt_kw)
    init, jstep = jax_make_train_step(s["jax_iface"].model, jopt, JaxWeightedMSELoss(loss_mask=jnp.asarray(jmask)))
    from anemoi_models_tpu.training.step import TrainState

    state = TrainState(params=s["params"], opt_state=jopt.init(s["params"]), step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jstep)
    want = []
    for _ in range(4):
        state, loss = jstep(state, jnp.asarray(x), jnp.asarray(y))
        want.append(float(loss))
    model = iface.model
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-3, **opt_kw), WeightedMSELoss(loss_mask=mask))
    got = [step(torch.from_numpy(x), torch.from_numpy(y)).item() for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=6e-4, atol=2e-5)
    assert want[-1] < want[0]


def test_jax_checkpoint_with_imputer_state_serves(aifs, tmp_path):
    """A JAX checkpoint of the fitted AIFS-path model (boundings and imputer
    state in it) served by from_checkpoint(device="cpu") without fitting:
    the same NaN mask and predict_step within 2e-5; the port's own save
    round-trips the imputer state and serves bit for bit."""
    s = aifs
    path = s["jax_iface"].save(str(tmp_path / "jax"), step=3)
    want = np.asarray(s["jax_iface"].make_predict_fn()(s["params"], jnp.asarray(s["batch"])))
    iface = AnemoiModelInterface.from_checkpoint(path, device="cpu")
    imputer = iface.pre_processors.processors["imputer"]
    np.testing.assert_array_equal(
        imputer.nan_locations.numpy(),
        np.asarray(s["jax_iface"].pre_processors.processors["imputer"].nan_locations))
    got = iface.predict_step(torch.from_numpy(s["batch"])).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **OUT)
    again = AnemoiModelInterface.from_checkpoint(iface.save(str(tmp_path / "port")), device="cpu")
    np.testing.assert_array_equal(again.pre_processors.processors["imputer"].nan_locations.numpy(),
                                  imputer.nan_locations.numpy())
    np.testing.assert_array_equal(again.predict_step(torch.from_numpy(s["batch"])).numpy(), got)
