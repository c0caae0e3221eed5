"""Analytic narrowphase primitives.

Counterpart of ``chrono_tpu/collision/narrowphase.py``: branch-free,
batched pair functions.  Each returns ``(gap, normal, point)`` where ``gap
< 0`` means penetration, ``normal`` points from shape A toward shape B, and
``point`` is the world contact point (midway in the overlap).
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q


def sphere_sphere(ca: Tensor, ra: Tensor, cb: Tensor, rb: Tensor,
                  eps: float = 1e-12):
    """Sphere A (center ca, radius ra) vs sphere B. Broadcasts leading
    axes."""
    d = cb - ca
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + eps)
    n = d / dist[..., None]
    gap = dist - (ra + rb)
    p = ca + n * (ra + 0.5 * gap)[..., None]
    return gap, n, p


def sphere_point(c: Tensor, r: Tensor, p_surf: Tensor, eps: float = 1e-12):
    """Sphere vs a point (used for degenerate box corners)."""
    return sphere_sphere(c, r, p_surf, torch.zeros_like(r), eps)


def sphere_plane(c: Tensor, r: Tensor, p0: Tensor, n_plane: Tensor):
    """Sphere (A) vs infinite plane (B) with outward normal ``n_plane``;
    the normal points from the sphere toward the plane."""
    h = torch.sum((c - p0) * n_plane, dim=-1)       # signed height of center
    gap = torch.abs(h) - r
    n = -torch.sign(h)[..., None] * n_plane
    p = c + n * (r + 0.5 * gap)[..., None]
    return gap, n, p


def sphere_box(c: Tensor, r: Tensor, box_pos: Tensor, box_rot: Tensor,
               half: Tensor, eps: float = 1e-9):
    """Sphere (A) vs oriented box (B): branch-free inside/outside handling.

    Returns gap, world normal pointing sphere→box surface, world contact
    point (on the box surface).
    """
    cl = Q.qrotate_inv(box_rot, c - box_pos)        # sphere center, box frame
    cl, half = torch.broadcast_tensors(cl, half)
    clamped = torch.minimum(torch.maximum(cl, -half), half)
    d = cl - clamped
    d2 = torch.sum(d * d, dim=-1)
    dist_out = torch.sqrt(d2 + eps)
    outside = d2 > 1e-14

    # inside: push out along the face with least penetration
    face_depth = half - torch.abs(cl)               # (…,3) ≥ 0 when inside
    ax = torch.argmin(face_depth, dim=-1)
    sign = torch.sign(torch.gather(cl, -1, ax[..., None]))[..., 0]
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    eye = torch.eye(3, dtype=cl.dtype, device=cl.device)
    n_in = sign[..., None] * eye[ax]                # outward face normal
    depth_in = torch.gather(face_depth, -1, ax[..., None])[..., 0]

    # n_local: outward direction at the nearest surface point, continuous
    # across the surface
    n_local = torch.where(outside[..., None], d / dist_out[..., None], n_in)
    gap = torch.where(outside, dist_out - r, -(depth_in + r))
    surf_local = torch.where(outside[..., None], clamped,
                             cl + n_in * depth_in[..., None])
    n_world = Q.qrotate(box_rot, -n_local)          # sphere → box
    p_world = box_pos + Q.qrotate(box_rot, surf_local)
    p = p_world + 0.0 * n_world                     # contact at box surface
    return gap, n_world, p


def sphere_capsule(c: Tensor, r: Tensor, cap_p0: Tensor, cap_p1: Tensor,
                   cap_r: Tensor, eps: float = 1e-12):
    """Sphere vs capsule (segment p0-p1 with radius cap_r)."""
    ab = cap_p1 - cap_p0
    t = torch.sum((c - cap_p0) * ab, dim=-1) / torch.clamp_min(
        torch.sum(ab * ab, dim=-1), eps)
    t = torch.clamp(t, 0.0, 1.0)
    closest = cap_p0 + t[..., None] * ab
    return sphere_sphere(c, r, closest, cap_r, eps)


def sphere_triangle(c: Tensor, r: Tensor, v0: Tensor, v1: Tensor,
                    v2: Tensor, eps: float = 1e-12):
    """Sphere vs triangle: the closest point on the triangle (face, edge or
    vertex region), branch-free by barycentric clamping."""
    ab = v1 - v0
    ac = v2 - v0
    ap = c - v0
    d1 = torch.sum(ab * ap, dim=-1)
    d2 = torch.sum(ac * ap, dim=-1)
    bp = c - v1
    d3 = torch.sum(ab * bp, dim=-1)
    d4 = torch.sum(ac * bp, dim=-1)
    cp = c - v2
    d5 = torch.sum(ab * cp, dim=-1)
    d6 = torch.sum(ac * cp, dim=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp_min(va + vb + vc, eps)
    v = vb / denom
    w = vc / denom
    p_face = v0 + v[..., None] * ab + w[..., None] * ac

    # region tests → closest point candidates
    t_ab = torch.clamp(d1 / torch.clamp_min(d1 - d3, eps), 0.0, 1.0)
    p_ab = v0 + t_ab[..., None] * ab
    t_ac = torch.clamp(d2 / torch.clamp_min(d2 - d6, eps), 0.0, 1.0)
    p_ac = v0 + t_ac[..., None] * ac
    bc = v2 - v1
    t_bc = torch.clamp((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6),
                                                   eps), 0.0, 1.0)
    p_bc = v1 + t_bc[..., None] * bc

    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    in_edge_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_edge_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    p = p_face
    p = torch.where(in_edge_bc[..., None], p_bc, p)
    p = torch.where(in_edge_ac[..., None], p_ac, p)
    p = torch.where(in_edge_ab[..., None], p_ab, p)
    p = torch.where(in_vert_c[..., None], v2, p)
    p = torch.where(in_vert_b[..., None], v1, p)
    p = torch.where(in_vert_a[..., None], v0, p)

    return sphere_point(c, r, p, eps)
