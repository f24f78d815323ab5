"""PyTorch port, the data layer against the JAX package's on the CPU: the
synthetic source and generator, the memmap, zarr (every blosc inner codec
and shuffle the writer has, and a snappy chunk) and HDF5 stores, each
package reading the other's, the window sampler's order and restore, the
threaded loader with several workers, and ``device_prefetch`` on the CPU.

The port keeps its own copies of these numpy modules (it imports nothing of
the JAX package), so these tests hold the copies to the originals bit for
bit at a tiny grid (``latlon_grid_nodes(6)``).
"""

import struct

import numpy as np
import pytest
import torch

from helpers_torch import one_torch_thread  # noqa: F401 (autouse)
from anemoi_models_tpu.graphs import latlon_grid_nodes
from anemoi_models_tpu.training import data as jdata
from anemoi_models_tpu.training import dataset as jds
from anemoi_models_tpu.training import loader as jloader
from anemoi_models_tpu.training import zarr_store as jzs
from anemoi_models_tpu_torch.training import data as pdata
from anemoi_models_tpu_torch.training import dataset as pds
from anemoi_models_tpu_torch.training import loader as ploader
from anemoi_models_tpu_torch.training import zarr_store as pzs


@pytest.fixture(scope="module")
def coords():
    return latlon_grid_nodes(6).coords


def _record(source, steps):
    return np.stack([source.window(t, 1)[0] for t in range(steps)])


def test_synthetic_source_and_weather_match_jax(coords):
    """The same seed gives the same windows, statistics and noisy batches."""
    for seed in (0, 3):
        a, b = jds.SyntheticSource(coords, 5, num_steps=12, seed=seed), pds.SyntheticSource(coords, 5, num_steps=12,
                                                                                          seed=seed)
        assert a.variables == b.variables and len(a) == len(b)
        np.testing.assert_array_equal(a.window(3, 4), b.window(3, 4))
        for k in a.statistics:
            np.testing.assert_array_equal(a.statistics[k], b.statistics[k])
        ja, pa = jdata.SyntheticWeather(coords, 3, seed=seed), pdata.SyntheticWeather(coords, 3, seed=seed)
        np.testing.assert_array_equal(ja.batch(2, 3, t0=1.0), pa.batch(2, 3, t0=1.0))
    with pytest.raises(IndexError):
        b.window(10, 4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_memmap_and_h5_stores_read_across_packages(tmp_path, coords, writer):
    """A memmap directory and an HDF5 file written by one package read back
    through the other's ``open_dataset`` with the same windows, variables,
    coordinates and statistics."""
    src = jds.SyntheticSource(coords, 4, num_steps=10, seed=2)
    data = _record(src, 10)
    w, r = (jds, pds) if writer == "jax" else (pds, jds)
    w.save_memmap_dataset(str(tmp_path / "mm"), data, src.variables, src.coords)
    pytest.importorskip("h5py")
    w.H5Dataset.write(str(tmp_path / "d.h5"), data, src.variables, src.coords)
    for path in (str(tmp_path / "mm"), str(tmp_path / "d.h5")):
        a, b = w.open_dataset(path), r.open_dataset(path)
        assert type(b).__name__ == type(a).__name__ and a.variables == b.variables
        np.testing.assert_array_equal(a.window(2, 5), b.window(2, 5))
        np.testing.assert_array_equal(b.window(0, 10), data)
        np.testing.assert_array_equal(a.coords, b.coords)
        for k in a.statistics:
            np.testing.assert_array_equal(a.statistics[k], b.statistics[k])


BLOSC = [None, {"id": "zlib", "level": 1}] + [
    {"id": "blosc", "cname": cname, "clevel": 3, "shuffle": shuffle, "blocksize": 64}
    for cname in ("lz4", "blosclz", "zlib") for shuffle in (0, 1, 2)
]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_zarr_stores_read_across_packages(tmp_path, coords, writer):
    """An anemoi-layout zarr store written by one package (uncompressed,
    zlib, and blosc with the lz4, blosclz and zlib inner codecs under no,
    byte and bit shuffle, in blocks small enough to split) reads back
    through the other's reader bit for bit, as a dataset and as arrays."""
    src = jds.SyntheticSource(coords, 3, num_steps=6, seed=4)
    data = _record(src, 6)
    w, r = (jds, pds) if writer == "jax" else (pds, jds)
    wz, rz = (jzs, pzs) if writer == "jax" else (pzs, jzs)
    for i, comp in enumerate(BLOSC):
        path = str(tmp_path / f"s{i}.zarr")
        w.save_zarr_dataset(path, data, src.variables, src.coords, compressor=comp)
        got = r.open_dataset(path)
        assert type(got).__name__ == "ZarrDataset" and got.variables == src.variables
        np.testing.assert_array_equal(got.window(1, 4), data[1:5])
        np.testing.assert_allclose(got.coords, src.coords, atol=1e-6)
        raw = np.random.RandomState(i).randn(5, 3, 1, 7).astype(np.float32)
        wz.write_zarr_array(str(tmp_path / f"g{i}"), "x", raw, chunks=(2, 3, 1, 7), compressor=comp)
        np.testing.assert_array_equal(rz.ZarrArray(str(tmp_path / f"g{i}" / "x"))[1:4], raw[1:4])


def test_zarr_codecs_decode_as_jax():
    """The port's Python LZ4, BloscLZ and snappy decoders and its blosc
    chunk parser give the JAX package's bytes: naive-encoder round trips,
    hand vectors, a split-mode chunk and a snappy chunk; malformed input
    raises in both."""
    rng = np.random.RandomState(0)
    for raw in (b"", b"a" * 300, bytes(rng.randint(0, 4, 700, dtype=np.uint8)), np.arange(300, dtype=np.float32).tobytes()):
        lz, blz = jzs._lz4_compress_naive(raw), jzs._blosclz_compress_naive(raw)
        assert pzs._lz4_decompress(lz, len(raw)) == raw
        if raw:
            assert pzs._blosclz_decompress(blz, len(raw)) == raw
        for ts in (1, 4):
            for shuffle in (0, 1, 2):
                for cname in ("lz4", "blosclz", "zlib"):
                    chunk = jzs._blosc_compress(raw, ts, cname=cname, shuffle=shuffle, blocksize=128)
                    assert pzs._blosc_decompress(chunk) == raw
    with pytest.raises(ValueError):
        pzs._lz4_decompress(b"\x13a\x00\x00\x00", 8)
    assert pzs._snappy_decompress(bytes([8, (1 << 2)]) + b"ab" + bytes([0b01001, 2]), 8) == b"abababab"
    # a snappy blosc chunk: 82 bytes of "ab", one stream
    payload = bytes([82, (1 << 2)]) + b"ab" + bytes([((8 - 4) << 2) | 1, 2]) * 10
    body = struct.pack("<i", len(payload)) + payload
    chunk = (struct.pack("<BBBB", 2, 1, (2 << 5) | 0x10, 1) + struct.pack("<iii", 82, 82, 20 + len(body))
             + struct.pack("<i", 20) + body)
    assert pzs._blosc_decompress(chunk) == jzs._blosc_decompress(chunk) == b"ab" * 41


def test_sampler_order_and_restore_match_jax():
    """The window sampler's epochs (shuffled and not), its state and its
    restore mid-epoch give the JAX package's index batches."""
    for shuffle in (True, False):
        a = jloader.WindowSampler(30, 4, 3, seed=7, shuffle=shuffle)
        b = ploader.WindowSampler(30, 4, 3, seed=7, shuffle=shuffle)
        ia, ib = iter(a), iter(b)
        for _ in range(20):  # across an epoch boundary (9 batches an epoch)
            np.testing.assert_array_equal(next(ia), next(ib))
        assert a.state() == b.state() and a.batches_per_epoch == b.batches_per_epoch == 9
        c = ploader.WindowSampler(30, 4, 3, seed=0, shuffle=shuffle)
        c.restore(a.state())
        ic = iter(c)
        for _ in range(5):
            np.testing.assert_array_equal(next(ia), next(ic))
    with pytest.raises(ValueError):
        ploader.WindowSampler(5, 4, 3)


def test_loader_with_workers_matches_jax_and_prefetch_passes_through(coords):
    """The threaded batch loader with 1 and 3 workers yields the JAX
    package's batches in the same order and stops after max_batches; a
    worker's failure reaches the consumer; on the CPU device_prefetch hands
    the batches through as tensors."""
    src = pds.SyntheticSource(coords, 3, num_steps=20, seed=1)
    want = list(jloader.BatchLoader(jds.SyntheticSource(coords, 3, num_steps=20, seed=1),
                                    jloader.WindowSampler(20, 3, 2, seed=5), max_batches=6))
    for workers in (1, 3):
        loader = ploader.BatchLoader(src, ploader.WindowSampler(20, 3, 2, seed=5), max_batches=6, workers=workers,
                                     depth=2)
        got = list(loader)
        loader.close()
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    out = list(ploader.device_prefetch(iter(want), prefetch=2, device="cpu"))
    assert all(isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), w) for t, w in zip(out, want))

    class Broken:
        def window(self, start, length):
            raise RuntimeError("disk gone")

    with pytest.raises(RuntimeError, match="disk gone"):
        list(ploader.BatchLoader(Broken(), ploader.WindowSampler(20, 3, 2), max_batches=2))


def test_source_layout_check(tmp_path, coords):
    """check_source_layout accepts the training layout and names each
    column that moved; open_dataset refuses an unknown path."""
    src = pds.SyntheticSource(coords, 3, num_steps=4)

    class Iface:
        class data_indices:
            name_to_index = {"var_0": 0, "var_1": 1, "var_2": 2}

    pds.check_source_layout(Iface, src)
    src.variables = ["var_1", "var_0", "var_2"]
    with pytest.raises(ValueError, match="column 0"):
        pds.check_source_layout(Iface, src)
    with pytest.raises(ValueError, match="unrecognized"):
        pds.open_dataset(str(tmp_path / "nothing.txt"))
