"""BCE (boundary-condition-enforcing) markers: generators and the
rigid-body coupling.

Counterpart of part of ``chrono_tpu/fsi/bce.py``.  The generators are
host-side numpy, copied rather than imported, because importing
``chrono_tpu.fsi`` imports JAX; the code is the same so both packages give
the same points, bit for bit: ``box_wall_markers`` and the rigid-body
shells ``sphere_body_markers``, ``box_body_markers`` and
``cylinder_body_markers``.  At run time, ``update_rigid_markers`` moves the
rigid markers with their bodies and ``rigid_body_forces`` reduces the
granular or fluid reaction on them to per-body forces and torques.  The
JAX package sums that reduction with ``.at[b].add``; here each body's
markers are summed in a fixed order with no atomics, through one stable
sort of the markers by body (``utils.segment``).  Heightmap, mesh, OBJ and
cylindrical-container markers are not ported (ROADMAP Queue 1 items 3, 6
and 8).
"""

from __future__ import annotations

import numpy as np
import torch

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.fsi.sph.state import RIGID_BCE
from chrono_tpu_torch.fsi.sph.wcsph import particle_mass
from chrono_tpu_torch.utils.segment import segment_sum_sorted, sorted_segments


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


def sphere_body_markers(radius, spacing, layers=3) -> np.ndarray:
    """Marker shells on/inside a sphere surface (body-local coords)."""
    pts = []
    for l in range(layers):
        r = radius - l * spacing
        if r <= spacing * 0.5:
            break
        n_theta = max(int(np.pi * r / spacing), 4)
        for it in range(n_theta + 1):
            th = np.pi * it / n_theta
            n_phi = max(int(2 * np.pi * r * np.sin(th) / spacing), 1)
            for ip in range(n_phi):
                ph = 2 * np.pi * ip / n_phi
                pts.append([r * np.sin(th) * np.cos(ph),
                            r * np.sin(th) * np.sin(ph),
                            r * np.cos(th)])
    return np.asarray(pts)


def box_body_markers(half, spacing, layers=3) -> np.ndarray:
    """Marker shells on a box surface (body-local coords)."""
    half = np.asarray(half, float)
    pts = []
    for l in range(layers):
        h = half - l * spacing
        if np.any(h <= 0):
            break
        ns = np.maximum((2 * h / spacing).astype(int) + 1, 2)
        xs, ys, zs = [np.linspace(-h[i], h[i], ns[i]) for i in range(3)]
        g = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
        pts.append(np.c_[g, np.full(len(g), -h[2])])
        pts.append(np.c_[g, np.full(len(g), h[2])])
        g = np.stack(np.meshgrid(ys, zs[1:-1], indexing="ij"), -1
                     ).reshape(-1, 2)
        pts.append(np.c_[np.full(len(g), -h[0]), g])
        pts.append(np.c_[np.full(len(g), h[0]), g])
        g = np.stack(np.meshgrid(xs[1:-1], zs[1:-1], indexing="ij"), -1
                     ).reshape(-1, 2)
        pts.append(np.c_[g[:, 0], np.full(len(g), -h[1]), g[:, 1]])
        pts.append(np.c_[g[:, 0], np.full(len(g), h[1]), g[:, 1]])
    return np.concatenate(pts, axis=0)


def cylinder_body_markers(radius, height, spacing, layers=3, axis="z"):
    """Marker shells on a closed cylinder surface (body-local, axis z)."""
    pts = []
    for l in range(layers):
        r = radius - l * spacing
        if r <= spacing * 0.5:
            break
        zs = np.arange(-height / 2, height / 2 + spacing * 0.5, spacing)
        n_phi = max(int(2 * np.pi * r / spacing), 4)
        phis = 2 * np.pi * np.arange(n_phi) / n_phi
        for z in zs:
            pts.append(np.c_[r * np.cos(phis), r * np.sin(phis),
                             np.full(n_phi, z)])
        # caps
        rr = np.arange(0, r, spacing)
        for rc in rr:
            n_p = max(int(2 * np.pi * rc / spacing), 1)
            ph = 2 * np.pi * np.arange(n_p) / n_p
            for zc in (-height / 2 - l * spacing, height / 2 + l * spacing):
                pts.append(np.c_[rc * np.cos(ph), rc * np.sin(ph),
                                 np.full(n_p, zc)])
    return np.concatenate(pts, axis=0)


# ---------------- runtime coupling ----------------

def update_rigid_markers(pos, vel, kind, body_id, bce_local,
                         body_x, body_q, body_v, body_w):
    """Refresh RIGID_BCE marker positions and velocities from body states:
    x_m = x_b + R(q_b) ξ_m, v_m = v_b + ω_b × (R ξ_m), with ω_b the body's
    local angular velocity rotated to the world.  Other markers keep
    theirs.  Returns (pos, vel)."""
    b = torch.clamp(body_id, min=0).long()
    q = body_q[b]
    r_world = Q.qrotate(q, bce_local)
    w_world = Q.qrotate(q, body_w[b])
    mpos = body_x[b] + r_world
    mvel = body_v[b] + torch.linalg.cross(w_world, r_world, dim=-1)
    is_rigid = (kind == RIGID_BCE)[:, None]
    return torch.where(is_rigid, mpos, pos), torch.where(is_rigid, mvel, vel)


def rigid_body_forces(params, dv_dt, kind, body_id, pos, body_x, n_bodies):
    """The reaction on RIGID_BCE markers reduced to per-body forces and
    torques: f_m = m_marker · (dv/dt)_m, τ_m = (x_m − x_b) × f_m, each
    body's markers summed in marker order (a stable sort by body once a
    call, ``torch.segment_reduce`` over the runs: no atomics, the order of
    a sequential ``.at[b].add``).  Returns (force (B, 3) world, torque
    (B, 3) world)."""
    m = particle_mass(params)
    is_rigid = kind == RIGID_BCE
    b = torch.clamp(body_id, min=0).long()
    f_m = m * dv_dt
    tau_m = torch.linalg.cross(pos - body_x[b], f_m, dim=-1)
    seg = sorted_segments(b, n_bodies, keep=is_rigid)
    both = segment_sum_sorted(seg, torch.cat([f_m, tau_m], dim=1))
    return both[:, :3].contiguous(), both[:, 3:].contiguous()
