"""Approximate convex decomposition of closed triangle meshes (VHACD role).

Counterpart of ``chrono_tpu/collision/decomp.py`` (numpy, build time; this
package keeps its own copy):

1. voxelize the mesh interior on a regular grid (z-column ray parity
   against the triangle soup),
2. greedily grow maximal axis-aligned boxes over unclaimed interior
   voxels (largest-seed-first), each box clipped to stay inside the
   voxelization,
3. emit each box as a (center, half-extents) convex part;
   ``decomposition_shapes`` turns the parts into the BOX entries of
   ``collision.pipeline.ConvexShapes`` for the batched MPR pipeline.

Accuracy is controlled by the voxel pitch.
"""

from __future__ import annotations

import numpy as np
import torch

from chrono_tpu_torch.collision import mpr
from chrono_tpu_torch.utils.device import resolve_device


def voxelize(verts, faces, pitch):
    """Interior occupancy grid of a closed mesh by z-column ray parity.

    Returns (occ (nx, ny, nz) bool, origin (3,)) with voxel centers at
    origin + (i + 0.5) * pitch."""
    verts = np.asarray(verts, float)
    faces = np.asarray(faces, int)
    # the 0.5371 (not 0.5) keeps voxel CENTERS off axis-aligned mesh
    # planes — centers exactly on a face make the ray parity degenerate
    lo = verts.min(axis=0) - 0.5371 * pitch
    hi = verts.max(axis=0) + 0.5 * pitch
    dims = np.maximum(np.ceil((hi - lo) / pitch).astype(int), 1)
    nx, ny, nz = dims
    occ = np.zeros((nx, ny, nz), bool)

    xs = lo[0] + (np.arange(nx) + 0.5) * pitch
    ys = lo[1] + (np.arange(ny) + 0.5) * pitch
    zs = lo[2] + (np.arange(nz) + 0.5) * pitch

    tri = verts[faces]                      # (F, 3, 3)
    # per-triangle z-plane crossing for each (x, y) column
    for f in range(len(tri)):
        a, b, c = tri[f]
        xmin, xmax = min(a[0], b[0], c[0]), max(a[0], b[0], c[0])
        ymin, ymax = min(a[1], b[1], c[1]), max(a[1], b[1], c[1])
        i0 = np.searchsorted(xs, xmin)
        i1 = np.searchsorted(xs, xmax, side="right")
        j0 = np.searchsorted(ys, ymin)
        j1 = np.searchsorted(ys, ymax, side="right")
        if i0 >= i1 or j0 >= j1:
            continue
        X, Y = np.meshgrid(xs[i0:i1], ys[j0:j1], indexing="ij")
        # barycentric test in the x-y projection
        d = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(d) < 1e-30:
            continue
        w0 = ((b[1] - c[1]) * (X - c[0]) + (c[0] - b[0]) * (Y - c[1])) / d
        w1 = ((c[1] - a[1]) * (X - c[0]) + (a[0] - c[0]) * (Y - c[1])) / d
        w2 = 1.0 - w0 - w1
        hit = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not hit.any():
            continue
        zhit = w0 * a[2] + w1 * b[2] + w2 * c[2]
        ii, jj = np.nonzero(hit)
        for k in range(len(ii)):
            kz = np.searchsorted(zs, zhit[ii[k], jj[k]])
            # toggle parity for all voxels BELOW the surface crossing
            occ[i0 + ii[k], j0 + jj[k], :kz] ^= True
    return occ, lo


def _grow_box(occ, used, seed):
    """Greedy maximal box from ``seed``: repeatedly try to extend each of
    the 6 faces by one voxel layer while the layer is fully interior and
    unclaimed."""
    nx, ny, nz = occ.shape
    x0 = x1 = seed[0]
    y0 = y1 = seed[1]
    z0 = z1 = seed[2]
    free = occ & ~used

    def ok(xa, xb, ya, yb, za, zb):
        return free[xa:xb + 1, ya:yb + 1, za:zb + 1].all()

    grew = True
    while grew:
        grew = False
        if x1 + 1 < nx and ok(x1 + 1, x1 + 1, y0, y1, z0, z1):
            x1 += 1; grew = True
        if x0 - 1 >= 0 and ok(x0 - 1, x0 - 1, y0, y1, z0, z1):
            x0 -= 1; grew = True
        if y1 + 1 < ny and ok(x0, x1, y1 + 1, y1 + 1, z0, z1):
            y1 += 1; grew = True
        if y0 - 1 >= 0 and ok(x0, x1, y0 - 1, y0 - 1, z0, z1):
            y0 -= 1; grew = True
        if z1 + 1 < nz and ok(x0, x1, y0, y1, z1 + 1, z1 + 1):
            z1 += 1; grew = True
        if z0 - 1 >= 0 and ok(x0, x1, y0, y1, z0 - 1, z0 - 1):
            z0 -= 1; grew = True
    return x0, x1, y0, y1, z0, z1


def decompose_boxes(verts, faces, pitch, max_parts=64,
                    min_fill=0.95):
    """Approximate convex decomposition into axis-aligned boxes.

    Returns a list of (center (3,), half (3,)) parts covering at least
    ``min_fill`` of the interior voxels (or ``max_parts``, whichever
    stops first), largest parts first."""
    occ, lo = voxelize(verts, faces, pitch)
    used = np.zeros_like(occ)
    total = int(occ.sum())
    if total == 0:
        return []
    parts = []
    while len(parts) < max_parts and (occ & ~used).sum() > (1 - min_fill) \
            * total:
        free = occ & ~used
        idx = np.argwhere(free)
        # multi-seed trials, keep the LARGEST grown box (a single
        # centroid seed fragments simple shapes — measured: 16 parts for
        # an L that needs 2): stratified sample across the free set +
        # the centroid-most voxel
        cen = idx.mean(axis=0)
        cand = [idx[np.argmin(((idx - cen) ** 2).sum(axis=1))]]
        stride = max(1, len(idx) // 8)
        cand += list(idx[::stride][:8])
        best, best_vol = None, -1
        for seed in cand:
            box = _grow_box(occ, used, seed)
            x0, x1, y0, y1, z0, z1 = box
            vol = (x1 - x0 + 1) * (y1 - y0 + 1) * (z1 - z0 + 1)
            if vol > best_vol:
                best, best_vol = box, vol
        x0, x1, y0, y1, z0, z1 = best
        used[x0:x1 + 1, y0:y1 + 1, z0:z1 + 1] = True
        c = lo + (np.array([x0 + x1, y0 + y1, z0 + z1]) + 1.0) \
            * 0.5 * pitch
        h = (np.array([x1 - x0, y1 - y0, z1 - z0]) + 1.0) * 0.5 * pitch
        parts.append((c, h))
    parts.sort(key=lambda p: -float(np.prod(p[1])))
    return parts


def decomposition_shapes(parts, body: int, mu: float = 0.5,
                         n_verts: int = 8, device=None):
    """``ConvexShapes`` of the parts of :func:`decompose_boxes` (body-local
    centres and half extents) on ``body``, on the card unless ``device``
    names another."""
    from chrono_tpu_torch.collision.pipeline import ConvexShapes

    device = resolve_device(device, "decomposition_shapes")
    K = len(parts)
    c = np.asarray([p[0] for p in parts], np.float32).reshape(K, 3)
    h = np.asarray([p[1] for p in parts], np.float32).reshape(K, 3)
    rot = np.zeros((K, 4), np.float32)
    rot[:, 0] = 1.0

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return ConvexShapes(
        body=t(np.full(K, body, np.int32), torch.int32),
        kind=t(np.full(K, mpr.BOX, np.int32), torch.int32), pos=t(c),
        rot=t(rot), data=t(h), verts=t(np.zeros((K, n_verts, 3), np.float32)),
        mu=t(np.full(K, mu, np.float32)))
