"""On-disk dataset access for training runs.

The port's own copy of ``anemoi_models_tpu/training/dataset.py`` (numpy
only; ``h5py`` is imported by :class:`H5Dataset` alone, when it is used):
each package reads the stores the other writes.

The reference trains through the external anemoi-datasets stack (zarr
stores of shape ``(time, vars, ensemble, grid)`` plus per-variable
statistics); anemoi-models itself ships no reader. Here the same tensor
contract is provided self-contained, TPU-loader-friendly:

- every source exposes ``window(start, length) -> (length, grid, vars)``
  float32 plus ``statistics`` / ``variables`` / ``coords`` — exactly what
  the preprocessing stack and the rollout trainer consume;
- `MemmapDataset` reads a directory holding one ``data.npy`` (time, grid,
  vars) via numpy memmap — zero-copy window slices, the format
  ``save_memmap_dataset`` writes;
- `H5Dataset` reads the same layout from HDF5 (``h5py`` is optional);
- `SyntheticSource` wraps ``SyntheticWeather`` so examples and tests can
  run the identical pipeline with no files at all.

Windows are (time, grid, vars) at the *data* level; the loader stacks them
into (batch, time, grid, vars) model batches.
"""

from __future__ import annotations

import json
import os
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

__all__ = [
    "DataSource",
    "H5Dataset",
    "MemmapDataset",
    "SyntheticSource",
    "ZarrDataset",
    "check_source_layout",
    "open_dataset",
    "save_memmap_dataset",
    "save_zarr_dataset",
]


@runtime_checkable
class DataSource(Protocol):
    """Minimal contract every training data source satisfies."""

    variables: list[str]
    coords: np.ndarray  # (grid, 2) lat/lon radians
    statistics: dict  # mean/stdev/minimum/maximum, each (vars,)

    def __len__(self) -> int:  # number of time steps
        ...

    def window(self, start: int, length: int) -> np.ndarray:  # (length, grid, vars)
        ...


def _check_meta(meta: dict) -> None:
    need = {"variables", "statistics", "latitudes", "longitudes"}
    missing = need - meta.keys()
    if missing:
        raise ValueError(f"dataset metadata lacks {sorted(missing)}")


class MemmapDataset:
    """Directory dataset: ``data.npy`` (time, grid, vars) + ``meta.json``.

    The array is memory-mapped, so ``window`` costs one page-aligned read of
    ``length * grid * vars`` floats — the OS page cache is the shuffle
    buffer. Write with :func:`save_memmap_dataset`.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        _check_meta(meta)
        self.variables = list(meta["variables"])
        self.coords = np.stack(
            [np.asarray(meta["latitudes"]), np.asarray(meta["longitudes"])], axis=-1
        ).astype(np.float32)
        self.statistics = {k: np.asarray(v, np.float32) for k, v in meta["statistics"].items()}
        self._data = np.load(os.path.join(path, "data.npy"), mmap_mode="r")
        if self._data.ndim != 3:
            raise ValueError(f"data.npy must be (time, grid, vars); got {self._data.shape}")
        if self._data.shape[2] != len(self.variables):
            raise ValueError(
                f"data.npy has {self._data.shape[2]} variables, meta lists {len(self.variables)}"
            )

    def __len__(self) -> int:
        return self._data.shape[0]

    @property
    def name_to_index(self) -> dict[str, int]:
        return {n: i for i, n in enumerate(self.variables)}

    def window(self, start: int, length: int) -> np.ndarray:
        if start < 0 or start + length > len(self):
            raise IndexError(f"window [{start}, {start + length}) outside {len(self)} steps")
        return np.asarray(self._data[start : start + length], dtype=np.float32)


def save_memmap_dataset(
    path: str,
    data: np.ndarray,
    variables: Sequence[str],
    coords: np.ndarray,
    statistics: dict | None = None,
) -> MemmapDataset:
    """Write ``(time, grid, vars)`` data + metadata in MemmapDataset layout.

    Statistics default to per-variable moments over the written data (what
    the normalizer needs at fit time).
    """
    data = np.asarray(data, np.float32)
    if data.ndim != 3 or data.shape[2] != len(variables):
        raise ValueError(f"need (time, grid, {len(variables)}) data; got {data.shape}")
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "data.npy"), data)
    if statistics is None:
        flat = data.reshape(-1, data.shape[2])
        statistics = {
            "mean": flat.mean(0),
            "stdev": flat.std(0) + 1e-6,
            "minimum": flat.min(0),
            "maximum": flat.max(0),
        }
    coords = np.asarray(coords)
    meta = {
        "variables": list(variables),
        "statistics": {k: np.asarray(v).tolist() for k, v in statistics.items()},
        "latitudes": coords[:, 0].tolist(),
        "longitudes": coords[:, 1].tolist(),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return MemmapDataset(path)


class H5Dataset:
    """HDF5 dataset with the same layout: a ``data`` array (time, grid,
    vars), root attrs ``variables`` and ``latitudes``/``longitudes``, and a
    ``statistics`` group of (vars,) arrays. Requires ``h5py``."""

    def __init__(self, path: str) -> None:
        import h5py  # optional: only an .h5 dataset needs it

        self._file = h5py.File(path, "r")
        self._data = self._file["data"]
        self.variables = [
            v.decode() if isinstance(v, bytes) else str(v)
            for v in self._file.attrs["variables"]
        ]
        self.coords = np.stack(
            [self._file.attrs["latitudes"], self._file.attrs["longitudes"]], axis=-1
        ).astype(np.float32)
        self.statistics = {
            k: np.asarray(v[()], np.float32) for k, v in self._file["statistics"].items()
        }

    def __len__(self) -> int:
        return self._data.shape[0]

    @property
    def name_to_index(self) -> dict[str, int]:
        return {n: i for i, n in enumerate(self.variables)}

    def window(self, start: int, length: int) -> np.ndarray:
        if start < 0 or start + length > len(self):
            raise IndexError(f"window [{start}, {start + length}) outside {len(self)} steps")
        return np.asarray(self._data[start : start + length], dtype=np.float32)

    def close(self) -> None:
        self._file.close()

    @staticmethod
    def write(
        path: str,
        data: np.ndarray,
        variables: Sequence[str],
        coords: np.ndarray,
        statistics: dict | None = None,
    ) -> "H5Dataset":
        import h5py

        data = np.asarray(data, np.float32)
        if statistics is None:
            flat = data.reshape(-1, data.shape[2])
            statistics = {
                "mean": flat.mean(0),
                "stdev": flat.std(0) + 1e-6,
                "minimum": flat.min(0),
                "maximum": flat.max(0),
            }
        coords = np.asarray(coords)
        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=data, chunks=(1, data.shape[1], data.shape[2]))
            f.attrs["variables"] = [str(v) for v in variables]
            f.attrs["latitudes"] = coords[:, 0].astype(np.float32)
            f.attrs["longitudes"] = coords[:, 1].astype(np.float32)
            g = f.create_group("statistics")
            for k, v in statistics.items():
                g.create_dataset(k, data=np.asarray(v, np.float32))
        return H5Dataset(path)


class SyntheticSource:
    """`SyntheticWeather` behind the DataSource contract: a virtual
    ``num_steps``-long record generated on demand (no files, deterministic
    per seed) — lets the full loader pipeline run in tests and examples."""

    def __init__(self, coords: np.ndarray, num_vars: int, num_steps: int = 256, seed: int = 0):
        from anemoi_models_tpu_torch.training.data import SyntheticWeather

        self._gen = SyntheticWeather(coords, num_vars, seed=seed, noise=0.0)
        self.variables = [f"var_{i}" for i in range(num_vars)]
        self.coords = np.asarray(coords, np.float32)
        self.statistics = self._gen.statistics()
        self._steps = num_steps

    def __len__(self) -> int:
        return self._steps

    @property
    def name_to_index(self) -> dict[str, int]:
        return {n: i for i, n in enumerate(self.variables)}

    def window(self, start: int, length: int) -> np.ndarray:
        if start < 0 or start + length > self._steps:
            raise IndexError(f"window [{start}, {start + length}) outside {self._steps} steps")
        return np.stack([self._gen.field(float(t)) for t in range(start, start + length)])


def check_source_layout(iface, source) -> None:
    """Fail fast when a dataset's column layout disagrees with the layout a
    checkpoint was trained on.

    Every tensor index in the checkpoint (data_indices, normalizer columns)
    refers to positions in the *training* dataset's variable order; a dataset
    with the same names in a different order would silently pair each column
    with another variable's statistics. Same-name-same-position is the
    contract, checked explicitly here.
    """
    wrong = []
    for name, idx in iface.data_indices.name_to_index.items():
        if idx >= len(source.variables) or source.variables[idx] != name:
            found = source.variables[idx] if idx < len(source.variables) else "<missing>"
            wrong.append(f"column {idx}: expected {name!r}, dataset has {found!r}")
    if wrong:
        raise ValueError(
            "dataset variable layout does not match the checkpoint's "
            "(indices and statistics are positional):\n  " + "\n  ".join(wrong)
        )


class ZarrDataset:
    """anemoi-datasets zarr store reader (self-contained, see
    ``training/zarr_store.py``).

    Layout contract (what the reference ecosystem's trainer reads and the
    reference interface consumes as dicts,
    anemoi-models' ``interface/__init__.py``):

    - ``data``: (time, variables, ensemble, cell) array;
    - ``mean`` / ``stdev`` / ``minimum`` / ``maximum``: per-variable
      statistics arrays (extra leading/trailing singleton axes tolerated);
    - ``latitudes`` / ``longitudes``: (cell,) coordinates in degrees;
    - ``name_to_index`` group attribute (or ``variables`` name list).

    ``window`` returns member ``ensemble_member`` (default 0) transposed to
    the framework's (time, grid, vars) layout.
    """

    def __init__(self, path: str, ensemble_member: int = 0) -> None:
        from anemoi_models_tpu_torch.training.zarr_store import ZarrGroup

        self.path = path
        group = ZarrGroup(path)
        if "data" not in group:
            raise ValueError(f"{path}: zarr group has no 'data' array")
        self._data = group["data"]
        if len(self._data.shape) != 4:
            raise ValueError(
                f"{path}: data must be (time, vars, ensemble, cell); got {self._data.shape}"
            )
        self._member = int(ensemble_member)
        n_vars = self._data.shape[1]

        n2i = group.attrs.get("name_to_index")
        if n2i:
            order = sorted(n2i.items(), key=lambda kv: kv[1])
            self.variables = [name for name, _ in order]
        elif group.attrs.get("variables"):
            self.variables = list(group.attrs["variables"])
        else:
            raise ValueError(f"{path}: neither name_to_index nor variables in .zattrs")
        if len(self.variables) != n_vars:
            raise ValueError(
                f"{path}: {len(self.variables)} variable names vs {n_vars} data columns"
            )

        def stat(name: str) -> np.ndarray:
            if name in group:
                v = np.asarray(group[name][:], np.float32).reshape(-1)
            elif name in group.attrs:
                v = np.asarray(group.attrs[name], np.float32).reshape(-1)
            else:
                raise ValueError(f"{path}: no {name!r} statistics array")
            if v.size != n_vars:
                raise ValueError(f"{path}: {name} has {v.size} entries for {n_vars} vars")
            return v

        self.statistics = {k: stat(k) for k in ("mean", "stdev", "minimum", "maximum")}

        lat = np.asarray(group["latitudes"][:], np.float64).reshape(-1)
        lon = np.asarray(group["longitudes"][:], np.float64).reshape(-1)
        if np.abs(lat).max() > np.pi:  # stored in degrees (the anemoi convention)
            lat, lon = np.deg2rad(lat), np.deg2rad(lon)
        self.coords = np.stack([lat, lon], axis=-1).astype(np.float32)

    def __len__(self) -> int:
        return self._data.shape[0]

    @property
    def name_to_index(self) -> dict[str, int]:
        return {n: i for i, n in enumerate(self.variables)}

    def window(self, start: int, length: int) -> np.ndarray:
        if start < 0 or start + length > len(self):
            raise IndexError(f"window [{start}, {start + length}) outside {len(self)} steps")
        block = self._data[start : start + length]  # (len, vars, ens, cell)
        member = block[:, :, self._member]  # (len, vars, cell)
        return np.ascontiguousarray(member.transpose(0, 2, 1), dtype=np.float32)


def save_zarr_dataset(
    path: str,
    data: np.ndarray,
    variables: Sequence[str],
    coords: np.ndarray,
    statistics: dict | None = None,
    compressor: dict | None = {"id": "zlib", "level": 1},
) -> "ZarrDataset":
    """Write ``(time, grid, vars)`` data as an anemoi-layout zarr store
    (data transposed to (time, vars, 1, cell), coords in degrees,
    statistics arrays + name_to_index attrs) and reopen it."""
    from anemoi_models_tpu_torch.training.zarr_store import (
        write_zarr_array,
        write_zarr_group_attrs,
    )

    data = np.asarray(data, np.float32)
    if data.ndim != 3 or data.shape[2] != len(variables):
        raise ValueError(f"need (time, grid, {len(variables)}) data; got {data.shape}")
    if statistics is None:
        flat = data.reshape(-1, data.shape[2])
        statistics = {
            "mean": flat.mean(0),
            "stdev": flat.std(0) + 1e-6,
            "minimum": flat.min(0),
            "maximum": flat.max(0),
        }
    coords = np.asarray(coords, np.float64)
    anemoi_layout = np.ascontiguousarray(data.transpose(0, 2, 1)[:, :, None, :])
    write_zarr_group_attrs(
        path,
        {
            "name_to_index": {n: i for i, n in enumerate(variables)},
            "variables": list(variables),
            "ensemble_dimension": 1,
        },
    )
    write_zarr_array(path, "data", anemoi_layout, compressor=compressor)
    for key in ("mean", "stdev", "minimum", "maximum"):
        write_zarr_array(path, key, np.asarray(statistics[key], np.float32))
    write_zarr_array(path, "latitudes", np.rad2deg(coords[:, 0]))
    write_zarr_array(path, "longitudes", np.rad2deg(coords[:, 1]))
    return ZarrDataset(path)


def open_dataset(path: str) -> DataSource:
    """Open a dataset by path: a zarr store (anemoi-datasets layout), a
    MemmapDataset directory, or an ``.h5`` file."""
    if os.path.isdir(path):
        if path.endswith(".zarr") or os.path.exists(os.path.join(path, ".zgroup")):
            return ZarrDataset(path)
        return MemmapDataset(path)
    if path.endswith((".h5", ".hdf5")):
        return H5Dataset(path)
    raise ValueError(
        f"unrecognized dataset path {path!r} (want a .zarr store, a memmap directory, or an .h5 file)"
    )
