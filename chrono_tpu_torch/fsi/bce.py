"""BCE (boundary-condition-enforcing) markers: generators and the
rigid-body coupling.

Counterpart of part of ``chrono_tpu/fsi/bce.py``.  The generators are
host-side numpy, copied rather than imported, because importing
``chrono_tpu.fsi`` imports JAX; the code is the same so both packages give
the same points, bit for bit: ``box_wall_markers``, the rigid-body
shells ``sphere_body_markers``, ``box_body_markers`` and
``cylinder_body_markers``, and the scene builders ``heightmap_markers``,
``cylinder_container_markers`` and ``cylinder_fluid_fill``.  At run time, ``update_rigid_markers`` moves the
rigid markers with their bodies and ``rigid_body_forces`` reduces the
granular or fluid reaction on them to per-body forces and torques.  The
JAX package sums that reduction with ``.at[b].add``; here each body's
markers are summed in a fixed order with no atomics, through one stable
sort of the markers by body (``utils.segment``).  The mesh and OBJ
generators (``mesh_body_markers``, ``obj_body_markers``) wait for the
port of ``io/`` and the native sampler (ROADMAP Queue 1 item 8).
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


def heightmap_markers(heights, origin, dx, spacing, layers=3,
                      depth=None):
    """A scene from a heightmap: ``heights`` (Nx, Ny) is the surface z(x,
    y) on a grid of pitch ``dx`` from ``origin`` (x0, y0).  Returns
    ``(bce, fluid)``: ``layers`` BCE sheets under the surface, ``spacing``
    apart, and with ``depth`` a fluid block filling [surface, surface +
    depth] (else None)."""
    heights = np.asarray(heights, float)
    nx, ny = heights.shape
    x = origin[0] + np.arange(nx) * dx
    y = origin[1] + np.arange(ny) * dx
    xs = np.arange(x[0], x[-1] + 0.5 * spacing, spacing)
    ys = np.arange(y[0], y[-1] + 0.5 * spacing, spacing)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")

    def interp(px, py):
        ix = np.clip((px - x[0]) / dx, 0, nx - 1 - 1e-9)
        iy = np.clip((py - y[0]) / dx, 0, ny - 1 - 1e-9)
        i0, j0 = ix.astype(int), iy.astype(int)
        fx, fy = ix - i0, iy - j0
        h00 = heights[i0, j0]
        h10 = heights[np.minimum(i0 + 1, nx - 1), j0]
        h01 = heights[i0, np.minimum(j0 + 1, ny - 1)]
        h11 = heights[np.minimum(i0 + 1, nx - 1), np.minimum(j0 + 1, ny - 1)]
        return ((1 - fx) * (1 - fy) * h00 + fx * (1 - fy) * h10
                + (1 - fx) * fy * h01 + fx * fy * h11)

    hz = interp(gx, gy)
    bce = np.concatenate([
        np.stack([gx, gy, hz - (l + 0.5) * spacing], -1).reshape(-1, 3)
        for l in range(layers)], axis=0)
    fluid = None
    if depth is not None:
        cols = []
        for k in range(int(np.ceil(depth / spacing))):
            z = hz + (k + 0.5) * spacing
            keep = z <= hz + depth
            cols.append(np.stack([gx[keep], gy[keep], z[keep]], -1))
        fluid = np.concatenate(cols, axis=0)
    return bce, fluid


def cylinder_container_markers(radius, height, spacing, layers=3,
                               top_open=True):
    """BCE markers of a cylindrical container (side wall, floor and, with
    ``top_open=False``, a lid), axis +z, floor at z = 0; the layers grow
    outward, so the innermost shell sits at ``radius``."""
    pts = []
    nz = max(2, int(round(height / spacing)) + 1)
    for l in range(layers):
        r = radius + l * spacing
        ntheta = max(8, int(round(2 * np.pi * r / spacing)))
        th = 2 * np.pi * np.arange(ntheta) / ntheta
        ring = np.stack([r * np.cos(th), r * np.sin(th),
                         np.zeros(ntheta)], axis=1)
        for k in range(nz):
            pts.append(ring + np.array([0.0, 0.0, k * height / (nz - 1)]))
    caps = [(-l * spacing) for l in range(1, layers + 1)]
    if not top_open:
        caps += [height + l * spacing for l in range(1, layers + 1)]
    for z in caps:
        nr = int(np.floor((radius + (layers - 0.5) * spacing) / spacing))
        for i in range(nr + 1):
            r = i * spacing
            ntheta = max(1, int(round(2 * np.pi * max(r, spacing * 0.5)
                                      / spacing))) if i else 1
            th = 2 * np.pi * np.arange(ntheta) / ntheta
            pts.append(np.stack([r * np.cos(th), r * np.sin(th),
                                 np.full(ntheta, z)], axis=1))
    return np.concatenate(pts, axis=0)


def cylinder_fluid_fill(radius, depth, spacing, inner_radius=0.0, z0=None):
    """Fluid markers filling a cylindrical (or annular) column, axis +z,
    from half a spacing above the floor."""
    z0 = 0.5 * spacing if z0 is None else z0
    xs = np.arange(-radius + spacing / 2, radius, spacing)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    r2 = X**2 + Y**2
    keep = (r2 < (radius - spacing / 2) ** 2)
    if inner_radius > 0:
        keep &= r2 > (inner_radius + spacing / 2) ** 2
    base = np.stack([X[keep], Y[keep]], axis=1)
    zs = np.arange(z0, depth, spacing)
    return np.concatenate([np.concatenate(
        [base, np.full((len(base), 1), z)], axis=1) for z in zs], axis=0)
