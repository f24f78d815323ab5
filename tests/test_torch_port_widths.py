"""PyTorch port, edge attention at every width: the lane layout both Hopper
kernels share, the plain versions at widths beyond the flagship's against the
JAX package's Pallas feats kernel in interpret mode, and the model's
routing-width check against the JAX model's.

Sizes are those of the port's other tests (``grid_lat=6,
mesh_refinements=2``). Tolerances follow the reference's tests: outputs 2e-5
(``tests/layers/test_commuted.py``), fp32 gradients 5e-4 (the same file's
gradient checks).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.graphs.kernel_plan import build_edge_kernel_plan
from anemoi_models_tpu.models import AnemoiModelEncProcDec as JaxModel
from anemoi_models_tpu.ops import slot_attention as jsa
from anemoi_models_tpu.ops.pallas.edge_attention import slot_attention_feats_kernel
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec
from anemoi_models_tpu_torch.ops import edge_attention as ea

F, A = 16, 5
OUT = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


def _accepted_widths(max_channels=1024):
    """Every (C, H) with C <= max_channels that the forward wrapper takes."""
    widths = []
    for c in range(1, max_channels + 1):
        for h in range(1, c + 1):
            if c % h == 0:
                try:
                    ea._check_heads(c, h)
                except ValueError:
                    continue
                widths.append((c, h))
    return widths


def test_lane_layout_takes_every_width_the_forward_takes():
    """The backward takes what the forward takes: every (C, H) up to C =
    1024 (head widths up to 1024), each head padded with zero channels to the
    width the kernels run it at (``_kernel_head``: D itself where it is a
    multiple of 8 up to 256, or 1, 2, 4 with C a multiple of 32, or above 256
    a multiple of its 16 or 32 channels a lane; else the next such width).
    The layout of the padded row puts a group of whole heads of at most 256
    channels, or one wider head, on at most 32 lanes, in 16-byte slices, a
    head on a power of two of lanes (D / VB rounded up; the lanes past D / VB
    pad it), with the first kernel's VF = max(1, D / 32) channels a thread
    dividing a lane's VB where D is a power of two (those layouts pad
    nothing and are the ones PRs before took)."""
    widths = _accepted_widths()
    assert len(widths) == sum(1 for c in range(1, 1025) for h in range(1, c + 1) if c % h == 0)
    for c, h in widths:
        d = c // h
        dp = ea._kernel_head(c, h)
        assert d <= dp < d + (8 if d <= 256 else 16 if d <= 512 else 32), (c, h)
        native = d % 8 == 0 if d <= 256 else d % (16 if d <= 512 else 32) == 0
        assert (dp == d) == (native or (d in (1, 2, 4) and c % 32 == 0)), (c, h)
        vb, lanes, group = ea._lane_layout(h * dp, h)
        lb = ea._pow2_at_least(dp // vb)  # lanes of a head
        assert vb in (1, 2, 4, 8, 16, 32) and lanes == group // dp * lb and lanes <= 32, (c, h)
        assert group % dp == 0 and group <= max(256, dp) and h * dp % group == 0, (c, h)
        assert dp % vb == 0 and group * 2 % 16 == 0, (c, h)
        assert 32 * vb >= group and (vb == 1 or 16 * vb < group), (c, h)  # the smallest such power of two
        if dp & (dp - 1) == 0:
            assert lanes * vb == group and vb % max(1, dp // 32) == 0, (c, h)
    assert ea._lane_layout(1024, 16) == (8, 32, 256)
    assert ea._lane_layout(192, 6) == (8, 24, 192)
    assert ea._lane_layout(32, 4) == (1, 32, 32)
    assert ea._lane_layout(1024, 4) == (8, 32, 256)  # D = 256: one head on the warp
    assert ea._lane_layout(384, 4) == (8, 32, 192)  # D = 96: two heads, each 12 lanes padded to 16
    assert ea._lane_layout(192, 4) == (8, 32, 192)  # D = 48: four heads, each 6 lanes padded to 8
    assert ea._lane_layout(1280, 4) == (16, 32, 320)  # D = 320: 20 lanes of 16, padded to 32
    assert ea._lane_layout(1024, 2) == (16, 32, 512) and ea._lane_layout(1024, 1) == (32, 32, 1024)
    for c, h, dp in ((36, 3, 16), (20, 1, 24), (40, 4, 16), (1032, 2, 544), (1000, 1, 1024)):
        assert ea._kernel_head(c, h) == dp, (c, h)  # D = 12, 20, 10, 516, 1000 off the rule: padded
    with pytest.raises(ValueError, match="head widths"):
        ea._check_heads(2048, 1)


def test_bwd_partials_follow_the_shape_alone():
    """The backward's dw_aug sum splits the destination rows into parts
    (about 528 CTAs over the (column, attribute) tiles, at least 32 rows a
    part), a function of (rows, C, attributes) only, so every card sums in
    the same order. Pinned at the main path's shapes, and at 64 attributes."""
    assert ea._bwd_parts(10242, 256, 8) == 264  # the flagship's processor: two tiles
    assert ea._bwd_parts(2 * 10242, 256, 8) == 264  # batch 2: the same tiles
    assert ea._bwd_parts(10242, 1024, 8) == 66  # the production width: eight column tiles
    assert ea._bwd_parts(2562, 512, 8) == 81  # the hierarchical model's r4 level: 32 rows a part
    assert ea._bwd_parts(642, 1024, 8) == 21  # its r3 level, D = 256
    assert ea._bwd_parts(13, 256, 8) == 1  # fewer rows than a part
    assert ea._bwd_parts(10242, 256, 12) == 132  # two attribute tiles
    assert ea._bwd_parts(10242, 1024, 64) == 9  # 64 attributes: 64 tiles


@pytest.fixture(scope="module")
def hidden_edges():
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    return graph[("hidden", "to", "hidden")].edge_index, graph["hidden"].num_nodes


@pytest.mark.parametrize("channels,heads", [(192, 6), (1024, 16), (192, 4), (384, 4), (1024, 4)])
def test_plain_versions_match_pallas_feats_kernel_interpret_at_width(hidden_edges, channels, heads):
    """edge_attn_csr_plain (finalized output) and edge_attn_csr_bwd_plain
    (through KVProj + EdgeAttnCSR: q, feats, w_kv, b_kv, the raw attributes
    and w_aug) against the Pallas feats kernel and its backward kernel, in
    interpret mode, at 6 heads of 32, 16 heads of 64, and 4 heads of 48, 96
    and 256 (the head widths the lanes pad, and the hierarchical model's
    coarsest)."""
    edge_index, n = hidden_edges
    c, h, d = channels, heads, channels // heads
    rng = np.random.RandomState(20 + h)
    x = dict(
        q=rng.randn(n, c).astype(np.float32),
        feats=rng.randn(n, F).astype(np.float32),
        w_kv=(rng.randn(F, 2 * c) * 0.3).astype(np.float32),  # flax (in, out) layout
        b_kv=(rng.randn(2 * c) * 0.1).astype(np.float32),
        a=rng.randn(edge_index.shape[1], A).astype(np.float32),
        w_aug=(rng.randn(A + 1, c) * 0.3).astype(np.float32),  # bias as the last row
    )
    g = rng.randn(n, c).astype(np.float32)  # output cotangent
    plan = build_edge_kernel_plan(edge_index, n, n, block_nodes=32, cap=32, slab_width=168)
    assert len(plan.outlier_src) == 0

    def jax_out(q, feats, w_kv, b_kv, a, w_aug):
        p = slot_attention_feats_kernel(
            q.reshape(n, h, d), feats, w_kv, b_kv, jsa._slot_attrs(a, plan), w_aug.reshape(A + 1, h, d),
            plan, True,
        )
        return jsa.finalize_partials(p, jnp.float32).reshape(n, c)

    names = ("q", "feats", "w_kv", "b_kv", "a", "w_aug")
    jargs = [jnp.asarray(x[k]) for k in names]
    ref = np.asarray(jax_out(*jargs))
    want = jax.grad(lambda *args: (jax_out(*args) * g).sum(), argnums=tuple(range(6)))(*jargs)

    leaves = [torch.tensor(x[k], requires_grad=True) for k in names]
    q, feats, w_kv, b_kv, a, w_aug = leaves
    rowptr, src = (torch.from_numpy(t) for t in ea.csr_from_edge_index(edge_index, n, n))
    csr_t = ea.CSRTranspose(*(torch.from_numpy(t) for t in ea.csr_transpose(rowptr, src, n)))
    kv = ea.KVProj.apply(feats, w_kv.t(), b_kv)
    a1 = torch.cat([a, torch.ones(a.shape[0], 1)], dim=-1)
    num, den, m = ea.EdgeAttnCSR.apply(q, kv, a1, w_aug, rowptr, src, h, csr_t)
    out = ea.finalize_partials(ea.AttentionPartials(num, den, m), torch.float32).reshape(n, c)
    np.testing.assert_allclose(out.detach().numpy(), ref, **OUT)
    (out * torch.from_numpy(g)).sum().backward()
    for name, leaf, w in zip(names, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), err_msg=name, **GRAD)


def test_routing_width_check_matches_jax():
    """An index collection whose internal output names one diagnostic index
    too many (len(prognostic) != len(full) - len(diagnostic)): the JAX
    model's routing-width assertion fires, and the port raises ValueError (a
    check that ``python -O`` keeps)."""
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    out_idx = di.internal_model.output
    assert len(out_idx.prognostic) == len(out_idx.full) - len(out_idx.diagnostic)
    bad = copy.deepcopy(di)
    bad.internal_model.output.diagnostic = np.append(out_idx.diagnostic, out_idx.prognostic[0])
    n_grid = graph["data"].num_nodes
    x = np.zeros((1, 2, 1, n_grid, len(di.internal_model.input)), np.float32)
    with pytest.raises(AssertionError, match="Routing-table width"):
        JaxModel(model_config=cfg, data_indices=bad, graph_data=graph).init(jax.random.key(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="routing-table width"):
        AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=bad, graph_data=graph, device="cpu")
    # the untouched collection builds
    AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph, device="cpu")
