"""DEM ↔ triangle-mesh coupling: a kinematic triangle soup on a moving
frame, with the force and torque on it fed back.

Counterpart of ``chrono_tpu/dem/mesh.py`` (``TriangleMesh``, ``MeshBins``,
``bin_triangles_numpy``, ``mesh_world_triangles``, ``sphere_mesh_forces``,
``load_obj_numpy``, ``make_triangle_mesh``).  The triangles are binned on
the host into the particles' uniform grid (a triangle goes to every cell
its bounding box, grown by a margin, overlaps; at most ``cap`` a cell);
each particle tests the triangles of its own cell through
``collision.narrowphase.sphere_triangle``: fixed capacity, masked, and
every sum over a fixed axis (no scatter).
"""

from __future__ import annotations

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, cell_index
from chrono_tpu_torch.collision.narrowphase import sphere_triangle
from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.dem.params import DEMParams, hertz_coefficients
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.tree import static_field, tensor_dataclass


@tensor_dataclass
class TriangleMesh:
    """A triangle soup attached to a moving frame (one mesh family)."""

    v0: torch.Tensor           # (T, 3) vertices in mesh-local coordinates
    v1: torch.Tensor
    v2: torch.Tensor
    frame_pos: torch.Tensor    # (3,) world position of the mesh frame
    frame_rot: torch.Tensor    # (4,)
    frame_vel: torch.Tensor    # (3,)
    frame_omega: torch.Tensor  # (3,) world angular velocity

    @property
    def n_tris(self) -> int:
        return self.v0.shape[0]


@tensor_dataclass
class MeshBins:
    """Triangle → cell table, valid while the mesh moves less than the
    binning margin."""

    tri_ids: torch.Tensor      # (n_cells, cap) int32, −1 empty
    cap: int = static_field(default=8)


def bin_triangles_numpy(grid: GridSpec, tris_world, cap=8, margin=0.0, *,
                        device=None):
    """Host-side binning of world triangles ``(v0, v1, v2)`` (numpy
    (T, 3) each) by their bounding boxes grown by ``margin``.  Returns
    ``(MeshBins on device, the fullest cell's count)``: past ``cap`` a
    cell keeps its first ``cap`` (and counts ``cap``), as in JAX."""
    device = resolve_device(device, "bin_triangles_numpy")
    v0, v1, v2 = (np.asarray(v) for v in tris_world)
    nx, ny, nz = grid.dims
    origin = np.asarray(grid.origin)
    cs = grid.cell_size
    table = -np.ones((nx * ny * nz, cap), np.int32)
    counts = np.zeros(nx * ny * nz, np.int32)
    lo = np.minimum(np.minimum(v0, v1), v2) - margin
    hi = np.maximum(np.maximum(v0, v1), v2) + margin
    top = np.asarray([nx - 1, ny - 1, nz - 1])
    ilo = np.clip(((lo - origin) / cs).astype(int), 0, top)
    ihi = np.clip(((hi - origin) / cs).astype(int), 0, top)
    for t in range(len(v0)):
        for i in range(ilo[t, 0], ihi[t, 0] + 1):
            for jj in range(ilo[t, 1], ihi[t, 1] + 1):
                for k in range(ilo[t, 2], ihi[t, 2] + 1):
                    c = (i * ny + jj) * nz + k
                    if counts[c] < cap:
                        table[c, counts[c]] = t
                        counts[c] += 1
    return (MeshBins(tri_ids=torch.as_tensor(table, device=device), cap=cap),
            int(counts.max()))


def mesh_world_triangles(mesh: TriangleMesh):
    """The local triangle soup in world coordinates."""
    def world(v):
        return mesh.frame_pos + Q.qrotate(mesh.frame_rot[None, :], v)

    return world(mesh.v0), world(mesh.v1), world(mesh.v2)


def sphere_mesh_forces(params: DEMParams, grid: GridSpec, bins: MeshBins,
                       mesh: TriangleMesh, pos, vel, omega):
    """Hertzian sphere–triangle forces with single-step (viscous,
    Coulomb-capped) friction and no history.

    The wall material's Hertz coefficients with m* = m and r* = r, capped
    at the wall material's μ.  Returns (force (N, 3) and torque (N, 3) on
    the particles, force (3,) on the mesh, torque (3,) on the mesh about
    its frame origin)."""
    r = params.radius
    kn, gn, kt, gt = hertz_coefficients(params.wall_material, params.mass, r)
    v0w, v1w, v2w = mesh_world_triangles(mesh)
    cand = bins.tri_ids[cell_index(grid, pos)]                 # (N, cap)
    valid = cand >= 0
    t = torch.clamp(cand, min=0).long()
    gap, n, p = sphere_triangle(pos[:, None, :], pos.new_full((), r),
                                v0w[t], v1w[t], v2w[t])
    overlap = torch.clamp(-gap, min=0.0)
    active = valid & (overlap > 0)

    # the mesh surface's velocity at the contact point
    rp = p - mesh.frame_pos
    v_mesh = mesh.frame_vel + torch.linalg.cross(
        mesh.frame_omega.expand_as(rp), rp, dim=-1)
    arm = r - 0.5 * overlap
    lever = -arm[..., None] * n
    v_part = vel[:, None, :] + torch.linalg.cross(
        omega[:, None, :].expand_as(lever), lever, dim=-1)
    # n points from the sphere toward the triangle: the push is along −n
    v_rel = v_mesh - v_part
    sq = torch.sqrt(overlap)
    q4 = torch.sqrt(sq)
    vn_s = torch.sum(v_rel * n, dim=-1)
    fn_mag = torch.clamp(kn * sq * overlap - gn * q4 * vn_s, min=0.0)
    f_n = -fn_mag[..., None] * n
    vt = v_rel - vn_s[..., None] * n
    ft = gt * q4[..., None] * vt
    ft_mag = torch.sqrt(torch.sum(ft * ft, dim=-1) + 1e-18)
    cap_f = params.wall_material.mu_s * fn_mag
    ft = ft * torch.where(ft_mag > cap_f, cap_f / ft_mag, 1.0)[..., None]

    f_pair = torch.where(active[..., None], f_n + ft, 0.0)
    f_particles = torch.sum(f_pair, dim=1)
    tau_particles = torch.sum(torch.linalg.cross(lever, f_pair, dim=-1),
                              dim=1)
    f_mesh_pairs = -f_pair
    force_mesh = torch.sum(f_mesh_pairs, dim=(0, 1))
    torque_mesh = torch.sum(torch.linalg.cross(rp, f_mesh_pairs, dim=-1),
                            dim=(0, 1))
    return f_particles, tau_particles, force_mesh, torque_mesh


def load_obj_numpy(path: str):
    """Vertices (float32) and fan-triangulated faces (int32) of an OBJ
    file."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def make_triangle_mesh(verts, faces, dtype=torch.float32, *,
                       device=None) -> TriangleMesh:
    """A mesh at the world origin, at rest, on ``device`` (the card unless
    told otherwise)."""
    device = resolve_device(device, "make_triangle_mesh")
    verts = np.asarray(verts)
    faces = np.asarray(faces)

    def corner(k):
        return torch.as_tensor(verts[faces[:, k]], dtype=dtype,
                               device=device)

    def zeros():
        return torch.zeros(3, dtype=dtype, device=device)

    return TriangleMesh(v0=corner(0), v1=corner(1), v2=corner(2),
                        frame_pos=zeros(),
                        frame_rot=Q.qidentity((), dtype, device),
                        frame_vel=zeros(), frame_omega=zeros())
