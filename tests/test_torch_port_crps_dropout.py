"""PyTorch port, the ensemble objective and attention-weight dropout on the
CPU: ``crps_ensemble`` against the JAX package's; the dropout mask, which the
kernels and the plain blockwise version draw from one counter-based stream
(Philox4x32-10 keyed by seed, step, layer and lead time), held to an
independent reference, shared by the forward and its recompute, at its keep
rate, exact at rate 0; the dropout train step (mirroring
``tests/training/test_dropout.py``); and the head-width rules of the edge
and band attention kernels, pinned for every head width up to 1024.

The JAX package draws its dropout with ``jax.random``, so the two packages
drop different pairs at the same rate: dropout is held to its rate, its
semantics (normalized probabilities dropped, the normalizer undropped) and
to rate 0 parity, as ROADMAP Queue 1 #6 asks. Inputs come from numpy seeds.
Sizes are those of the port's other tests (``grid_lat=6, mesh_refinements=2``,
C = 8 or 16, 2 processor layers).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.training.loss import crps_ensemble as jax_crps
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec
from anemoi_models_tpu_torch.ops import edge_attention as ea
from anemoi_models_tpu_torch.ops import flash_attention as fa
from anemoi_models_tpu_torch.training import (
    WeightedCRPSLoss,
    crps_ensemble,
    dropout_twin,
    make_optimizer,
    make_rollout_fn,
    make_rollout_train_step,
    make_train_step,
)
from anemoi_models_tpu_torch.training.run import _wants_dropout
from anemoi_models_tpu_torch.weights import init_params


@pytest.fixture(scope="module")
def graph():
    return build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)


@pytest.mark.parametrize("members", [1, 2, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_crps_matches_jax(members, weighted):
    """The fair CRPS (sorted members, coefficients 2k - M + 1; M = 1 the
    MAE) with and without node weights, variable weights and a loss mask,
    against the JAX package's, within 1e-6; the target with and without its
    ensemble axis."""
    rng = np.random.RandomState(members + 10 * weighted)
    grid, nvar = 37, 3
    pred = rng.randn(2, members, grid, nvar).astype(np.float32)
    target = rng.randn(2, 1, grid, nvar).astype(np.float32)
    kw = {}
    if weighted:
        kw = dict(node_weights=rng.rand(grid).astype(np.float32) + 0.5,
                  variable_weights=rng.rand(nvar).astype(np.float32) + 0.5,
                  loss_mask=(rng.rand(grid, nvar) > 0.2).astype(np.float32))
    want = float(jax_crps(jnp.asarray(pred), jnp.asarray(target), **{k: jnp.asarray(v) for k, v in kw.items()}))
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = float(crps_ensemble(torch.from_numpy(pred), torch.from_numpy(target), **tkw))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    squeezed = float(WeightedCRPSLoss(**tkw)(torch.from_numpy(pred).bfloat16(), torch.from_numpy(target[:, 0])))
    assert abs(squeezed - float(crps_ensemble(torch.from_numpy(pred).bfloat16().float(),
                                              torch.from_numpy(target), **tkw))) <= 1e-6


def _reference_dropout_attention(q, k, v, window, rate, key):
    """An independent plain version: the whole (N, N) band at once, the
    normalized weights dropped by the mask and divided by 1 - rate."""
    b, h, n, d = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / math.sqrt(d)
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    s = s.masked_fill((i - j).abs() > window, -1e30)
    w = torch.softmax(s, dim=-1)
    keep = fa.dropout_keep(key, fa.keep_threshold(rate), torch.arange(b * h).view(b, h, 1, 1), i, j)
    return torch.einsum("bhqk,bhkd->bhqd", torch.where(keep, w / (1 - rate), 0.0), v.double())


def test_dropout_mask_is_shared_by_forward_and_recompute():
    """Attention dropout with one key: the blockwise version (at two block
    sizes) equals an independent whole-band reference; FlashAttention's
    backward, which redraws the forward's mask from its key, gives the
    gradients of that same function (fp32, to 1e-5: an explicit backward
    sums in another order than autograd); another key
    (the next step) draws another mask; and the keep rate over the band is
    within 5 sigma of 1 - rate."""
    rng = np.random.RandomState(3)
    b, h, n, d, window, rate = 1, 2, 40, 8, 5, 0.3
    q, k, v = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32)) for _ in range(3))
    key = fa.fold_key(11, 4, 1)  # seed, step, layer
    want = _reference_dropout_attention(q, k, v, window, rate, key)
    for block in (512, 16):
        got = fa.blockwise_attention(q, k, v, window_size=window, dropout_rate=rate, dropout_key=key,
                                     block_size=block)
        torch.testing.assert_close(got.double(), want, atol=2e-6, rtol=2e-6)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.FlashAttention.apply(*leaves, window, False, rate, key)
    g = torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32))
    grads = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fa.blockwise_attention(*ref_leaves, window_size=window, dropout_rate=rate, dropout_key=key)
    for got_g, want_g in zip(grads, torch.autograd.grad(ref, ref_leaves, g)):
        torch.testing.assert_close(got_g, want_g, atol=1e-5, rtol=1e-5)
    other = fa.blockwise_attention(q, k, v, window_size=window, dropout_rate=rate, dropout_key=fa.fold_key(11, 5, 1))
    assert not torch.equal(other, out.detach())
    # keep rate over a full band of 4 heads x 512 x 1536 pairs
    keep = fa.dropout_keep(key, fa.keep_threshold(0.1), torch.arange(4).view(4, 1, 1),
                           torch.arange(512).view(1, 512, 1), torch.arange(1536).view(1, 1, 1536))
    pairs = keep.numel()
    assert abs(float(keep.float().mean()) - 0.9) <= 5 * math.sqrt(0.9 * 0.1 / pairs)


def test_dropout_rate_zero_is_exact(graph):
    """Rate 0 is today's attention bit for bit, with or without a key; a
    Transformer model built non-deterministic with dropout_p = 0 gives the
    deterministic model's output exactly."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 30, 8).astype(np.float32)) for _ in range(3))
    base = fa.blockwise_attention(q, k, v, window_size=4)
    assert torch.equal(fa.flash_attention(q, k, v, 4, False, 0.0, fa.fold_key(1, 2)), base)
    assert torch.equal(fa.FlashAttention.apply(q, k, v, 4, False, 0.0, None), base)
    cfg = make_config("transformer", num_channels=8)
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.randn(1, 2, 1, graph["data"].num_nodes, 4).astype(np.float32))
    twin = dropout_twin(model)
    with torch.no_grad():
        assert torch.equal(twin(x, dropout_key=fa.fold_key(3, 0)), model(x))


def _build(graph, dropout_p):
    cfg = make_config("transformer", num_channels=8)
    cfg.model.processor.dropout_p = dropout_p
    di = IndexCollection(cfg, dict(VARS))
    serve = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph, device="cpu")
    init_params(serve, torch.Generator().manual_seed(0))
    n_grid = graph["data"].num_nodes
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 2, 1, n_grid, 4).astype(np.float32))
    y = torch.from_numpy(0.1 * np.random.RandomState(1).randn(1, 1, n_grid, 4).astype(np.float32))
    return cfg, di, serve, dropout_twin(serve), x, y


def test_dropout_train_step_runs_and_differs(graph):
    """The dropout twin trains: with lr = 0 (parameters frozen) its losses
    differ from the deterministic twin's and from one step to the next (the
    key follows the update count); the deterministic twin's do not."""
    _, _, serve, train, x, y = _build(graph, 0.3)
    opt = make_optimizer(serve.parameters(), 0.0, warmup_steps=1, total_steps=10)
    step_drop = make_train_step(train, opt, dropout_seed=5)
    loss1, loss2 = float(step_drop(x, y)), float(step_drop(x, y))
    step_det = make_train_step(serve, opt)
    det_a, det_b = float(step_det(x, y)), float(step_det(x, y))
    assert det_a == det_b
    assert loss1 != det_a and loss1 != loss2
    assert np.isfinite([loss1, loss2]).all()


def test_dropout_param_tree_matches_serving(graph):
    """The twin's parameters and buffers are the serving model's own tensors,
    so an update of one is an update of the other, and the serving model
    runs the trained parameters unchanged (deterministic)."""
    _, _, serve, train, x, y = _build(graph, 0.3)
    assert [n for n, _ in train.named_parameters()] == [n for n, _ in serve.named_parameters()]
    assert all(a is b for a, b in zip(train.parameters(), serve.parameters()))
    assert all(a is b for a, b in zip(train.buffers(), serve.buffers()))
    assert serve.deterministic and not train.deterministic
    before = {n: p.detach().clone() for n, p in serve.named_parameters()}
    step = make_train_step(train, make_optimizer(serve.parameters(), 1e-3, warmup_steps=1, total_steps=10))
    step(x, y), step(x, y)  # the schedule's first update has lr 0 (optax's warmup from 0)
    assert any(not torch.equal(p, before[n]) for n, p in serve.named_parameters())
    with torch.no_grad():
        a, b = serve(x), serve(x)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_dropout_rollout_and_remat_redraw_the_same_masks(graph):
    """A rollout of the twin needs a key; its lead times draw different
    masks (the lead index is folded in); remat "full", which recomputes each
    chunk's forward in the backward, gives the gradients of remat "none"
    exactly (the recompute redraws the forward's masks); the rollout train
    step runs."""
    cfg, di, serve, train, x, y = _build(graph, 0.3)
    rollout = make_rollout_fn(train, di, 2)
    forcings = torch.zeros(2, 1, 1, x.shape[3], 1)
    with pytest.raises(ValueError, match="dropout_key"):
        rollout(x, forcings)
    with torch.no_grad():
        _, preds = rollout(x, forcings, 7)
        first = train(x, dropout_key=fa.fold_key(7, 0))
        assert torch.equal(preds[0], first)  # lead 0 runs under fold_key(key, 0)
        assert not torch.equal(first, train(x, dropout_key=fa.fold_key(7, 1)))
    assert preds.shape[0] == 2 and bool(torch.isfinite(preds).all())
    grads = []
    for policy in ("full", "none"):
        for chunk in train.processor.proc:
            chunk.remat_policy = policy
        train.zero_grad(set_to_none=True)
        WeightedCRPSLoss()(train(x, dropout_key=fa.fold_key(9, 2)), y).backward()
        grads.append({n: p.grad.clone() for n, p in train.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name
    opt = make_optimizer(serve.parameters(), 1e-3, warmup_steps=1, total_steps=10)
    truth = torch.from_numpy(np.random.RandomState(2).randn(2, 1, 1, x.shape[3], 4).astype(np.float32))
    loss = make_rollout_train_step(train, di, opt, 2, dropout_seed=1)(x, truth, 0.1 * truth)
    assert bool(torch.isfinite(loss)) and opt.count == 1
    assert not _wants_dropout(make_config("transformer", num_channels=8).model)
    assert _wants_dropout(cfg.model) and not _wants_dropout(make_config("graphtransformer").model)


def test_head_width_rules_for_every_width_up_to_1024():
    """The padding rules of both attention kernels, for every head width D
    from 1 to 1024: the band attention runs D itself on a tile kernel where
    one is built for it (bf16 16, 32, 64, 128, 256, 512; fp32 16-128),
    else the next such width, and above the widest on the row kernel
    unpadded; the edge attention pads D (1, 3 and 4 heads) as
    ``_kernel_head`` says, to a width its lane layout takes."""
    for d in range(1, 1025):
        for dt, widths in ((torch.bfloat16, (16, 32, 64, 128, 256, 512)), (torch.float32, (16, 32, 64, 128))):
            want = next((w for w in widths if w >= d), d)
            assert fa._tile_width(d, dt) == want, (d, dt)
        for h in (1, 3, 4):
            dp = ea._kernel_head(h * d, h)
            vb, lanes, group = ea._lane_layout(h * dp, h)
            assert dp >= d and group % dp == 0 and lanes <= 32 and dp % vb == 0, (d, h)
            if d <= 256:
                assert dp == (d if d % 8 == 0 or (d in (1, 2, 4) and h * d % 32 == 0) else -(-d // 8) * 8), (d, h)
            else:
                step = 16 if d <= 512 else 32
                assert dp == -(-d // step) * step and group == dp and vb == step, (d, h)
