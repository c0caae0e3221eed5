"""MPR (Minkowski Portal Refinement) narrowphase for general convex pairs.

Counterpart of ``chrono_tpu/collision/mpr.py``: contact between any two
convex shapes defined by their support functions, with a fixed number of
portal refinements (24) and of support-function polish steps (28), so that
no loop ends on data.  The JAX package maps one pair with ``jax.vmap``;
here every function takes shapes whose fields carry leading pair axes (or
none, for one pair), and each loop is a Python loop of fixed count over
masked tensor ops that reads nothing on the host.

Shapes (the reference's ConvexShape menu): sphere, box, capsule, z-axis
cylinder and convex hull (vertices padded by repeating one).  The
Minkowski-difference support is ``sA(d) − sB(−d)``.

Returned contact: ``(gap, normal, point)`` with the analytic narrowphase's
conventions (gap < 0 ⇒ penetration, normal A→B).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.utils.device import resolve_device

# shape type codes
SPHERE, BOX, CAPSULE, CYLINDER, HULL = 0, 1, 2, 3, 4

#: manifold points emitted per (convex, triangle) pair
N_TRI_MANIFOLD = 5


class ConvexShape(NamedTuple):
    """Convex shapes: type + pose + sized parameters, over leading axes.

    data layout by type:
      SPHERE:   data[0] = radius
      BOX:      data[0:3] = half extents
      CAPSULE:  data[0] = radius, data[1] = half length (z axis)
      CYLINDER: data[0] = radius, data[1] = half length (z axis)
      HULL:     verts (V, 3) local vertices (pad by repeating any vertex)
    """

    kind: Tensor     # (...) int32
    pos: Tensor      # (..., 3)
    rot: Tensor      # (..., 4)
    data: Tensor     # (..., 3)
    verts: Tensor    # (..., V, 3) — zeros for non-hull shapes


def make_shape(kind, pos, rot=None, data=(0.0, 0.0, 0.0), verts=None,
               n_verts: int = 8, device=None) -> ConvexShape:
    """One shape, on the card unless ``device`` names another."""
    device = resolve_device(device, "make_shape")
    rot = np.asarray([1.0, 0, 0, 0] if rot is None else rot, np.float32)
    if verts is None:
        v = np.zeros((n_verts, 3), np.float32)
    else:
        verts = np.asarray(verts, np.float32)
        v = (np.concatenate(
            [verts, np.repeat(verts[-1:], n_verts - len(verts), axis=0)])
            if len(verts) < n_verts else verts[:n_verts])

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return ConvexShape(kind=t(np.int32(kind), torch.int32),
                       pos=t(np.asarray(pos, np.float32)), rot=t(rot),
                       data=t(np.asarray(data, np.float32)), verts=t(v))


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _axes(like: Tensor):
    """(e_x, e_y, e_z) of ``like``'s type, built on its device (no host
    copy, so a captured step may call this)."""
    e = torch.eye(3, dtype=like.dtype, device=like.device)
    return e[0], e[1], e[2]


def _expand(shape: ConvexShape, k: int) -> ConvexShape:
    """The shapes with a new axis of ``k`` after their leading axes (views,
    no copy): one shape for each of ``k`` directions."""
    lead = shape.kind.dim()

    def ex(x):
        x = x.unsqueeze(lead)
        size = list(x.shape)
        size[lead] = k
        return x.expand(size)

    return ConvexShape(*(ex(x) for x in shape))


def support(shape: ConvexShape, d_world: Tensor, eps: float = 1e-12
            ) -> Tensor:
    """Farthest point of each shape along ``d_world`` (world frame)."""
    d = Q.qrotate_inv(shape.rot, d_world)            # direction in local
    dn = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + eps)
    _, _, ez = _axes(d)

    r = shape.data[..., 0:1]
    sph = dn * r
    box = torch.sign(d) * shape.data
    # capsule: sphere swept segment along z
    hz = shape.data[..., 1:2]
    cap = dn * r + ez * torch.sign(d[..., 2:3]) * hz
    # cylinder: disc edge + flat cap
    dxy = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + eps)
    cyl = torch.stack([r[..., 0] * d[..., 0] / dxy,
                       r[..., 0] * d[..., 1] / dxy,
                       torch.sign(d[..., 2]) * hz[..., 0]], dim=-1)
    # hull: argmax vertex (the first of equal ones, as jnp.argmax)
    dots = torch.sum(shape.verts * d[..., None, :], dim=-1)
    k = torch.argmax(dots, dim=-1)
    hull = torch.take_along_dim(shape.verts, k[..., None, None], dim=-2)[
        ..., 0, :]

    kind = shape.kind[..., None]
    local = torch.where(kind == SPHERE, sph, torch.where(
        kind == BOX, box, torch.where(kind == CAPSULE, cap, torch.where(
            kind == CYLINDER, cyl, hull))))
    return shape.pos + Q.qrotate(shape.rot, local)


def _mink_support(a: ConvexShape, b: ConvexShape, d: Tensor):
    """Support of the Minkowski difference A − B along d, plus the witness
    point on A (for contact-point recovery)."""
    pa = support(a, d)
    pb = support(b, -d)
    return pa - pb, pa


def _tangents(n: Tensor, eps: float):
    """A unit tangent pair of ``n`` from the axis least aligned with it."""
    ex, ey, _ = _axes(n)
    ax = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    t1 = _cross(n, ax)
    t1 = t1 / torch.sqrt(torch.sum(t1 * t1, dim=-1, keepdim=True) + eps)
    return t1, _cross(n, t1)


def mpr_contact(a: ConvexShape, b: ConvexShape, n_iters: int = 24,
                eps: float = 1e-10):
    """Penetration query via MPR with a fixed refinement count, for every
    pair of ``a`` and ``b`` (their leading axes broadcast).

    Returns (gap, normal (A→B, world), point): gap < 0 with valid
    normal/point when penetrating; for separated pairs gap is a positive
    lower-bound estimate along the final portal normal.
    """
    ex, ey, _ = _axes(a.pos)
    # v0: interior ray origin (difference of centers)
    v0 = a.pos - b.pos
    v0 = torch.where((torch.sum(v0 * v0, dim=-1) < 1e-12)[..., None],
                     1e-5 * ex, v0)

    # initial portal: three supports around the origin ray
    v1, w1 = _mink_support(a, b, -v0)
    d2 = _cross(v1, v0)
    d2 = torch.where((torch.sum(d2 * d2, dim=-1) < 1e-12)[..., None],
                     1e-5 * ey, d2)
    v2, w2 = _mink_support(a, b, d2)
    d3 = _cross(v1 - v0, v2 - v0)
    # orient toward the origin side
    d3 = torch.where((_dot(d3, v0) > 0)[..., None], -d3, d3)
    v3, w3 = _mink_support(a, b, d3)

    n = v0 / torch.sqrt(torch.sum(v0 * v0, dim=-1, keepdim=True) + eps)
    for _ in range(n_iters):
        # portal normal (away from v0); once the portal collapses toward
        # the contact point the triangle degenerates — keep the previous
        n_raw = _cross(v2 - v1, v3 - v1)
        nn = torch.sqrt(torch.sum(n_raw * n_raw, dim=-1, keepdim=True))
        scale2 = (torch.sum((v2 - v1) ** 2, dim=-1, keepdim=True)
                  + torch.sum((v3 - v1) ** 2, dim=-1, keepdim=True) + eps)
        n = torch.where(nn < 1e-5 * scale2, n,
                        n_raw / torch.clamp_min(nn, eps))
        n = torch.where((_dot(n, v1 - v0) < 0)[..., None], -n, n)
        v4, w4 = _mink_support(a, b, n)
        # converged portals stop mutating: a near-duplicate support would
        # degenerate the triangle and poison the final normal
        progress = _dot(n, v4 - v1)
        scale = torch.sqrt(torch.sum(v1 * v1, dim=-1) + 1.0)
        done = progress < 1e-6 * scale
        # replace the vertex so that the triangle still straddles the
        # origin ray (signs of scalar triple products with v0 and v4)
        t1 = _dot(_cross(v4, v1), v0)
        t2 = _dot(_cross(v4, v2), v0)
        t3 = _dot(_cross(v4, v3), v0)
        rep1 = ((t1 >= 0) & (t2 < 0) & ~done)[..., None]
        rep2 = ((t2 >= 0) & (t3 < 0) & ~done)[..., None]
        rep3 = ~rep1 & ~rep2 & ~done[..., None]
        v1, w1 = torch.where(rep1, v4, v1), torch.where(rep1, w4, w1)
        v2 = torch.where(~rep1 & rep2, v4, v2)
        w2 = torch.where(~rep1 & rep2, w4, w2)
        v3, w3 = torch.where(rep3, v4, v3), torch.where(rep3, w4, w3)

    # support-function polish of the normal: the signed translation
    # distance is min over unit n of h(n) = n · s_{A−B}(n); a compass search
    # (± the two tangents, the step halved on failure) seeded at the portal
    # normal makes the depth robust for flat and large shapes.  The running
    # minimum starts from a true support evaluation at the portal normal.
    ae, be = _expand(a, 4), _expand(b, 4)
    s_seed, _ = _mink_support(a, b, n)
    h = _dot(n, s_seed)
    alpha = torch.full_like(h, 0.4)
    for _ in range(28):
        t1, t2 = _tangents(n, eps)
        dirs = torch.stack([t1, -t1, t2, -t2], dim=-2)          # (..., 4, 3)
        nc = n[..., None, :] + alpha[..., None, None] * dirs
        nc = nc / torch.sqrt(torch.sum(nc * nc, dim=-1, keepdim=True) + eps)
        sc, _ = _mink_support(ae, be, nc)
        hs = _dot(nc, sc)                                       # (..., 4)
        k = torch.argmin(hs, dim=-1, keepdim=True)
        hk = torch.take_along_dim(hs, k, dim=-1)[..., 0]
        nk = torch.take_along_dim(nc, k[..., None], dim=-2)[..., 0, :]
        better = hk < h
        n = torch.where(better[..., None], nk, n)
        h = torch.minimum(h, hk)
        alpha = torch.where(better, alpha, 0.5 * alpha)
    depth = h
    gap = -depth
    # witness from the polished normal: the deepest point of each shape
    # along the push-out direction, taken from the shape whose contact
    # feature is pointlike (a small spread of its support point under
    # perturbations of the direction) rather than a face
    wa = support(a, n)
    wb = support(b, -n)
    p1, p2 = _tangents(n, eps)
    delta = 1e-2
    pert = torch.stack([delta * p1, -(delta * p1), delta * p2,
                        -(delta * p2)], dim=-2)

    def spread(shape, d):
        pts = support(shape, d[..., None, :] + pert)            # (..., 4, 3)
        dev = pts - torch.mean(pts, dim=-2, keepdim=True)
        return torch.sum(dev ** 2, dim=(-2, -1))

    half = 0.5 * torch.clamp_min(depth, 0.0)[..., None]
    point = torch.where((spread(ae, n) < spread(be, -n))[..., None],
                        wa - half * n, wb + half * n)
    # the portal normal (away from v0 = c_A − c_B) already points A→B
    return gap, n, point


#: the JAX package's ``vmap`` of :func:`mpr_contact`; here the same
#: function, whose shapes carry the pair axis
mpr_contact_batch = mpr_contact


def _closest_on_triangle(p, v0, v1, v2, eps=1e-12):
    """Closest point on a triangle to ``p`` (branch-free barycentric clamp),
    batched over leading axes; returns (point, on-the-face flag)."""
    ab = v1 - v0
    ac = v2 - v0
    ap = p - v0
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - v1
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp_ = p - v2
    d5 = _dot(ab, cp_)
    d6 = _dot(ac, cp_)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp_min(va + vb + vc, eps)
    v = vb / denom
    w = vc / denom
    p_face = v0 + v[..., None] * ab + w[..., None] * ac
    t_ab = torch.clamp(d1 / torch.clamp_min(d1 - d3, eps), 0.0, 1.0)
    p_ab = v0 + t_ab[..., None] * ab
    t_ac = torch.clamp(d2 / torch.clamp_min(d2 - d6, eps), 0.0, 1.0)
    p_ac = v0 + t_ac[..., None] * ac
    bc = v2 - v1
    t_bc = torch.clamp((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6),
                                                   eps), 0.0, 1.0)
    p_bc = v1 + t_bc[..., None] * bc
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    out = p_face
    out = torch.where(in_bc[..., None], p_bc, out)
    out = torch.where(in_ac[..., None], p_ac, out)
    out = torch.where(in_ab[..., None], p_ab, out)
    out = torch.where(in_c[..., None], v2, out)
    out = torch.where(in_b[..., None], v1, out)
    out = torch.where(in_a[..., None], v0, out)
    face = ~(in_a | in_b | in_c | in_ab | in_ac | in_bc)
    return out, face


def convex_triangle(shape: ConvexShape, v0, v1, v2, eps=1e-9):
    """Convex shapes vs triangles (one each, over leading axes): the
    support-plane narrowphase.

    * face contact: the shape's deepest points against the triangle's
      plane by support calls in −n̂ and in four directions tilted by
      ±ε t1 ± ε t2 (the face manifold's extreme points), gaps along the
      face normal, each kept only where it projects onto the triangle;
    * edge/vertex contact, only when no face candidate is valid: the
      direction from the closest triangle point toward the shape's center,
      the gap re-measured by a support call along it and clamped to the
      plane gap.

    Returns ``(gap (..., 5), n (..., 5, 3), p (..., 5, 3), valid (..., 5))``
    with n the A→B normal (shape → triangle owner).
    """
    nt = _cross(v1 - v0, v2 - v0)
    nt = nt / torch.sqrt(torch.sum(nt * nt, dim=-1, keepdim=True) + eps)
    side = torch.sign(torch.sum(nt * (shape.pos - v0), dim=-1) + eps)
    nt = nt * side[..., None]              # plane normal toward the shape
    # tangent basis of the face for the perturbed manifold directions
    t1, t2 = _tangents(nt, eps)

    gaps, norms, pts, valid = [], [], [], []
    EPSD = 0.05
    deep0 = None
    for (e1, e2) in ((0.0, 0.0), (EPSD, EPSD), (EPSD, -EPSD),
                     (-EPSD, EPSD), (-EPSD, -EPSD)):
        d = -nt + e1 * t1 + e2 * t2
        d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + eps)
        deep = support(shape, d)
        if deep0 is None:
            deep0 = deep                 # the unperturbed point seeds the
            continue                     # edge fallback below
        gap_f = torch.sum(nt * (deep - v0), dim=-1)
        proj = deep - gap_f[..., None] * nt
        cp, _ = _closest_on_triangle(proj, v0, v1, v2)
        gaps.append(gap_f)
        norms.append(-nt)
        pts.append(cp)
        valid.append(torch.sum((cp - proj) ** 2, dim=-1) < 1e-10)
    # edge/vertex fallback: sphere-like direction from the closest triangle
    # point to the shape center, gap re-measured by a support call along it
    gap_f0 = torch.sum(nt * (deep0 - v0), dim=-1)
    proj0 = deep0 - gap_f0[..., None] * nt
    cp0, _ = _closest_on_triangle(proj0, v0, v1, v2)
    on_face0 = torch.sum((cp0 - proj0) ** 2, dim=-1) < 1e-10
    d_e = shape.pos - cp0
    n_e = d_e / torch.sqrt(torch.sum(d_e * d_e, dim=-1, keepdim=True) + eps)
    deep_e = support(shape, -n_e)
    # the triangle is a subset of its plane: the true gap is never more
    # penetrating than the plane gap
    gap_e = torch.maximum(torch.sum(n_e * (deep_e - cp0), dim=-1), gap_f0)
    # the fallback fires only when no face candidate is valid
    any_face = torch.stack(valid, dim=-1).any(dim=-1) | on_face0
    gaps.append(torch.where(on_face0, gap_f0, gap_e))
    norms.append(torch.where(on_face0[..., None], -nt, -n_e))
    pts.append(cp0)
    valid.append(on_face0 | ~any_face)
    return (torch.stack(gaps, dim=-1), torch.stack(norms, dim=-2),
            torch.stack(pts, dim=-2), torch.stack(valid, dim=-1))


#: the JAX package's ``vmap`` of :func:`convex_triangle`
convex_triangle_batch = convex_triangle
