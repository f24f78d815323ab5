"""PyTorch port, its own host code: the graph builders and the variable
routing table that the port carries as copies, against the JAX package's; and
the card as the entry points' default device.

The JAX builders call a native helper where one is built; its subdivision
differs from numpy's in the last bit of some coordinates. The port keeps the
numpy code paths only, so the comparison runs the JAX builders with the
native helper turned off, and asks for equal arrays.
"""

import numpy as np
import pytest
import torch
from helpers_models import VARS, make_config
from helpers_torch import one_torch_thread  # noqa: F401 (autouse)

from anemoi_models_tpu import native
from anemoi_models_tpu.data_indices import IndexCollection as JaxIndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph as jax_build
from anemoi_models_tpu_torch.data_indices import IndexCollection
from anemoi_models_tpu_torch.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu_torch.interface import AnemoiModelInterface
from anemoi_models_tpu_torch.models import AnemoiModelEncProcDec


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(grid_lat=6, mesh_refinements=2),
        dict(grid_lat=16, mesh_refinements=3, grid="octahedral"),
        dict(grid_lat=8, mesh_refinements=2, data_order="mesh", decoder_knn=4),
    ],
    ids=["latlon", "octahedral", "mesh-order"],
)
def test_graph_builder_equals_jax_numpy_path(monkeypatch, kwargs):
    monkeypatch.setattr(native, "_lib", lambda: None)
    got, want = build_enc_proc_dec_graph(**kwargs), jax_build(**kwargs)
    assert list(got.nodes) == list(want.nodes) and list(got.edges) == list(want.edges)
    for name, ns in want.node_items():
        np.testing.assert_array_equal(got[name].coords, ns.coords)
        assert got[name].attrs.keys() == ns.attrs.keys()
        for key, value in ns.attrs.items():
            np.testing.assert_array_equal(got[name].attrs[key], value)
    for key, es in want.edge_items():
        np.testing.assert_array_equal(got[key].edge_index, es.edge_index)
        np.testing.assert_array_equal(got[key].dst_ptr, es.dst_ptr)
        assert got[key].attrs.keys() == es.attrs.keys()
        for name, value in es.attrs.items():
            np.testing.assert_array_equal(got[key].attrs[name], value)


def test_index_collection_equals_jax():
    cfg = make_config("graphtransformer")
    cfg.data.remapped = {"z_500": ["z_500_a", "z_500_b"]}
    got, want = IndexCollection(cfg, dict(VARS)), JaxIndexCollection(cfg, dict(VARS))
    for level in ("data", "internal_data", "model", "internal_model"):
        for side in ("input", "output"):
            g, w = getattr(getattr(got, level), side), getattr(getattr(want, level), side)
            for part in ("full", "prognostic", "diagnostic", "forcing"):
                np.testing.assert_array_equal(getattr(g, part), getattr(w, part), err_msg=f"{level}.{side}.{part}")
            assert g.name_to_index == w.name_to_index


def test_entry_points_default_to_the_card():
    """Without ``device=`` the interface and the model build on CUDA; on a
    machine without a card that raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: building without device= succeeds here")
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnemoiModelInterface(config=cfg, graph_data=graph, statistics={}, data_indices=di)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph)
    model = AnemoiModelEncProcDec(model_config=cfg.to_dict(), data_indices=di, graph_data=graph, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
