"""BCE (boundary-condition-enforcing) marker generators, host-side numpy.

Counterpart of ``chrono_tpu/fsi/bce.py``.  Copied rather than imported,
because importing ``chrono_tpu.fsi`` imports JAX; the code is the same so
both packages give the same points, bit for bit.  Ported so far:
``box_wall_markers``.  The rigid-body generators and the runtime coupling
(marker kinematics from body states, the per-body force reduction) come
with the vehicle slice.
"""

from __future__ import annotations

import numpy as np


def box_wall_markers(lo, hi, spacing, layers=3, top_open=True) -> np.ndarray:
    """Markers for the inner walls of a box container (``layers`` shells
    outward)."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    pts = []
    nx, ny, nz = [max(int(round((hi[i] - lo[i]) / spacing)) + 1, 2)
                  for i in range(3)]
    xs = np.linspace(lo[0], hi[0], nx)
    ys = np.linspace(lo[1], hi[1], ny)
    zs = np.linspace(lo[2], hi[2], nz)
    for l in range(layers):
        off = l * spacing
        # floor / ceiling
        g = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
        pts.append(np.c_[g, np.full(len(g), lo[2] - off)])
        if not top_open:
            pts.append(np.c_[g, np.full(len(g), hi[2] + off)])
        # x walls
        g = np.stack(np.meshgrid(ys, zs, indexing="ij"), -1).reshape(-1, 2)
        pts.append(np.c_[np.full(len(g), lo[0] - off), g])
        pts.append(np.c_[np.full(len(g), hi[0] + off), g])
        # y walls
        g = np.stack(np.meshgrid(xs, zs, indexing="ij"), -1).reshape(-1, 2)
        pts.append(np.c_[g[:, 0], np.full(len(g), lo[1] - off), g[:, 1]])
        pts.append(np.c_[g[:, 0], np.full(len(g), hi[1] + off), g[:, 1]])
    pts = np.concatenate(pts, axis=0)
    return np.unique(np.round(pts / (spacing * 1e-3)).astype(np.int64),
                     axis=0) * (spacing * 1e-3)
