"""Simulation output writers: CSV time series, npz frame sequences and
HDF5 frames.

Counterpart of ``chrono_tpu/io/writers.py`` (``CSVWriter``,
``FrameWriter``, ``HDF5Writer``): a buffered column writer for scalar
channels, and frame dumps of particle or body arrays (npz per frame with
an index file, or one HDF5 file; ``h5py`` is imported when an
``HDF5Writer`` is made).  Tensors are written through the host, so a file
is the same whichever device the arrays came from.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _host(v) -> np.ndarray:
    """An array or tensor (any device) as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class CSVWriter:
    """Buffered CSV time-series writer."""

    def __init__(self, path: str, columns: list[str], delimiter=","):
        self.path = path
        self.columns = list(columns)
        self.delimiter = delimiter
        self._rows = []

    def append(self, *values):
        if len(values) != len(self.columns):
            raise ValueError(f"expected {len(self.columns)} values")
        self._rows.append([float(v) for v in values])

    def write(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            f.write(self.delimiter.join(self.columns) + "\n")
            for row in self._rows:
                f.write(self.delimiter.join(f"{v:.9g}" for v in row) + "\n")

    @staticmethod
    def read(path: str, delimiter=","):
        with open(path) as f:
            cols = f.readline().strip().split(delimiter)
        data = np.loadtxt(path, skiprows=1, delimiter=delimiter, ndmin=2)
        return cols, data


class FrameWriter:
    """Frame-sequence writer for particle or body array snapshots."""

    def __init__(self, directory: str, prefix: str = "frame"):
        self.dir = directory
        self.prefix = prefix
        self.frames = []
        os.makedirs(directory, exist_ok=True)

    def write_frame(self, time: float, **arrays):
        idx = len(self.frames)
        fname = f"{self.prefix}_{idx:06d}.npz"
        np.savez_compressed(os.path.join(self.dir, fname),
                            **{k: _host(v) for k, v in arrays.items()})
        self.frames.append({"index": idx, "time": float(time), "file": fname})
        with open(os.path.join(self.dir, "index.json"), "w") as f:
            json.dump(self.frames, f)

    @staticmethod
    def read_frame(directory: str, index: int, prefix: str = "frame"):
        return np.load(os.path.join(directory, f"{prefix}_{index:06d}.npz"))


class HDF5Writer:
    """Frame-sequence HDF5 output: one group per frame with a time
    attribute, named arrays as datasets."""

    def __init__(self, path: str, compression: str = "gzip"):
        import h5py

        self.h5 = h5py.File(path, "w")
        self.compression = compression
        self.n_frames = 0

    def write_frame(self, time: float, **arrays):
        g = self.h5.create_group(f"frames/{self.n_frames:06d}")
        g.attrs["time"] = float(time)
        for k, v in arrays.items():
            a = _host(v)
            g.create_dataset(k, data=a,
                             compression=self.compression
                             if a.ndim and a.size > 64 else None)
        self.n_frames += 1
        self.h5.attrs["n_frames"] = self.n_frames

    def close(self):
        self.h5.close()

    @staticmethod
    def read(path: str):
        """Load all frames → list of (time, {name: array})."""
        import h5py

        out = []
        with h5py.File(path, "r") as f:
            for name in sorted(f["frames"]):
                g = f["frames"][name]
                out.append((float(g.attrs["time"]),
                            {k: np.asarray(g[k]) for k in g}))
        return out
