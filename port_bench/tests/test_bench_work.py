"""The work model behind mfu and the roofline shares, against hand counts."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from port_bench.harness import work

VARIABLES = SimpleNamespace(inputs=["a", "b", "c"], outputs=["a", "b"])
SIZES = {"data": 10, "hidden": 5, "enc": 20, "proc": 15, "dec": 30, "edge_attr_dim": 3}


def _config(flavor: str) -> dict:
    return {"flavor": flavor, "num_channels": 8, "num_heads": 2, "num_layers": 2, "mlp_hidden_ratio": 4,
            "window_size": 1 if flavor == "transformer" else None, "multistep_input": 2, "trainable_hidden": 8,
            "trainable_edges": 8}


def _kernels(ns, nd, e, train):
    """One GraphTransformer conv at C = 8, 2 heads, A2 = 3 + 8 + 1 = 12, by hand."""
    kv = 2 * ns * 8 * 16
    fwd = e * (4 * 8 + 4 * 12 * 2) + nd * 4 * 12 * 8
    bwd = e * (10 * 8 + 12 * 12 * 2) + nd * 10 * 12 * 8
    return kv + fwd + ((2 * kv + bwd) if train else 0)


def _dense_gt_dst(nd):  # [q | r], projection, the two MLP products
    return 2 * nd * 8 * 16 + 2 * nd * 8 * 8 + 2 * (2 * nd * 8 * 32)


def _dense_mappers():
    data_in = 2 * 3 + 4 + 8  # two steps of 3 inputs, sin/cos of (lat, lon), 8 trainable
    return (2 * 10 * data_in * 8 + 2 * 5 * 12 * 8 + _dense_gt_dst(5)  # encoder: both embeddings
            + 2 * 10 * data_in * 8 + _dense_gt_dst(10) + 2 * 10 * 8 * 2)  # decoder: embedding, block, extractor


@pytest.mark.parametrize("train", [False, True])
def test_graphtransformer_flops_by_hand(train):
    s = work.Shapes.of(_config("graphtransformer"), SIZES, VARIABLES)
    dense = _dense_mappers() + 2 * _dense_gt_dst(5)
    kernels = _kernels(10, 5, 20, train) + 2 * _kernels(5, 5, 15, train) + _kernels(5, 10, 30, train)
    assert work.model_flops(s, train) == dense * (3 if train else 1) + kernels
    assert work.model_flops(s, False) == 68480  # the sum above, written out once


@pytest.mark.parametrize("train", [False, True])
def test_transformer_flops_by_hand(train):
    s = work.Shapes.of(_config("transformer"), SIZES, VARIABLES)
    pairs = 2 + 3 + 3 + 3 + 2  # |i - j| <= 1 over 5 positions
    per_layer = 2 * 5 * 8 * 24 + 2 * 5 * 8 * 8 + 2 * (2 * 5 * 8 * 32)
    flash = 2 * (4 * 4 * pairs * 2 + (10 * 4 * pairs * 2 if train else 0))  # 2 layers, D = 4, 2 heads
    dense = _dense_mappers() + 2 * per_layer
    kernels = _kernels(10, 5, 20, train) + _kernels(5, 10, 30, train)
    assert work.model_flops(s, train) == dense * (3 if train else 1) + kernels + flash


@pytest.mark.parametrize("n,w", [(5, 1), (17, 4), (100, 0), (7, 50)])
def test_band_pairs_counts_every_pair(n, w):
    assert work.band_pairs(n, w) == sum(abs(i - j) <= w for i in range(n) for j in range(n))


def test_least_time_takes_the_larger_bound():
    assert work.least_s(989e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12) == pytest.approx(1.0)
    s = work.Shapes.of(_config("graphtransformer"), SIZES, VARIABLES)
    calls = work.edge_calls(s, train=True)
    assert [c[0] for c in calls[:3]] == ["kv_proj", "edge_attn_csr", "edge_attn_csr_bwd"] and len(calls) == 12
    # the encoder's kv_proj: f (10 x 8) and w (16 x 8) in, kv (10 x 16) out in bf16, the bias fp32
    assert calls[0][2] == 2 * (10 * 8 + 16 * 8 + 10 * 16) + 4 * 16
