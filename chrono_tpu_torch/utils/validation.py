"""Golden-data validation oracle.

Counterpart of ``chrono_tpu/utils/validation.py`` (the reference's
``utils::ChValidation``): L2 / RMS / L∞ norms of a simulated trajectory
against recorded golden data, the oracle of the joint and mechanism tests.
Golden files are in the CSV format of ``io.writers.CSVWriter``.  Host
numpy only: tensors are read through the host first.
"""

from __future__ import annotations

import numpy as np

from chrono_tpu_torch.io.writers import CSVWriter, _host


def l2_norm(err: np.ndarray) -> float:
    return float(np.sqrt(np.sum(np.square(err))))


def rms_norm(err: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(err))))


def inf_norm(err: np.ndarray) -> float:
    return float(np.max(np.abs(err)))


NORMS = {"l2": l2_norm, "rms": rms_norm, "inf": inf_norm}


def validate_arrays(sim, ref, norm: str = "rms") -> np.ndarray:
    """Column-wise norm of (sim − ref); arrays (T, C). Returns (C,) norms."""
    sim = np.asarray(_host(sim), float)
    ref = np.asarray(_host(ref), float)
    if sim.shape != ref.shape:
        raise ValueError(f"shape mismatch {sim.shape} vs {ref.shape}")
    fn = NORMS[norm]
    return np.asarray([fn(sim[:, c] - ref[:, c])
                       for c in range(sim.shape[1])])


def validate_csv(sim_path: str, golden_path: str, norm: str = "rms",
                 columns: list[str] | None = None) -> dict:
    """Compare two CSV trajectory files (the reference's file-based flow).

    Both files share the time column (the first); the simulated data is
    resampled linearly onto the golden timestamps before comparison.
    Returns {column: norm value}.
    """
    cols_s, data_s = CSVWriter.read(sim_path)
    cols_g, data_g = CSVWriter.read(golden_path)
    if columns is None:
        columns = [c for c in cols_g[1:] if c in cols_s]
    t_s, t_g = data_s[:, 0], data_g[:, 0]
    fn = NORMS[norm]
    out = {}
    for c in columns:
        ys = np.interp(t_g, t_s, data_s[:, cols_s.index(c)])
        out[c] = fn(ys - data_g[:, cols_g.index(c)])
    return out
