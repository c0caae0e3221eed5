"""Particle samplers (host-side numpy, runs once at scene build).

Counterpart of ``chrono_tpu/utils/samplers.py``.  Copied rather than
imported, because importing ``chrono_tpu.utils`` imports JAX; the code is
the same so both packages give the same points, bit for bit.
"""

from __future__ import annotations

import numpy as np


def grid_sample_box(lo, hi, spacing, jitter=0.0, seed=0) -> np.ndarray:
    """Regular grid with optional random jitter, points at cell centers."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    counts = np.maximum(((hi - lo) / spacing).astype(int), 1)
    axes = [lo[i] + spacing * (np.arange(counts[i]) + 0.5) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        pts = pts + rng.uniform(-jitter, jitter, pts.shape) * spacing
    return pts
