"""Batched ray tests against analytic shapes and triangle soups.

Counterpart of ``chrono_tpu/collision/ray.py`` (the role of the reference's
ChRayTest and of the geometric half of its sensor ray tracing): every query
is an (R,) batch of rays against all primitives as dense (R, S)
min-reductions, no BVH.

All functions return ``t`` = hit distance (∞ where missed), so callers can
min-combine scenes, and the surface normal at the hit.  Ties take the
first primitive, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import torch
from torch import Tensor

INF = float("inf")


def _norm(v, eps=1e-12):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               eps)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _where_inf(ok, t):
    return torch.where(ok, t, torch.full_like(t, INF))


def ray_spheres(o, d, centers, radii):
    """Rays (R,3)+(R,3 unit) vs spheres (S,3),(S,) → (t (R,), n (R,3))."""
    oc = o[:, None, :] - centers[None, :, :]             # (R,S,3)
    b = torch.sum(oc * d[:, None, :], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radii[None, :] ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 1e-6, t0, _where_inf(t1 > 1e-6, t1))
    t = _where_inf(disc >= 0.0, t)                        # (R,S)
    ts, j = torch.min(t, dim=1)
    hit = o + ts[:, None] * d
    return ts, _norm(hit - centers[j])


def ray_boxes(o, d, centers, rots, halfs):
    """Rays vs oriented boxes (S,3) centers, (S,3,3) rotation matrices
    (columns = box axes), (S,3) half extents — slab test."""
    ro = torch.einsum("sij,rsj->rsi", rots.transpose(1, 2),
                      o[:, None, :] - centers[None, :, :])
    rd = torch.einsum("sij,rsj->rsi", rots.transpose(1, 2),
                      d[:, None, :].expand(ro.shape))
    small = torch.where(rd >= 0, torch.full_like(rd, 1e-12),
                        torch.full_like(rd, -1e-12))
    inv = 1.0 / torch.where(torch.abs(rd) < 1e-12, small, rd)
    t1 = (-halfs[None] - ro) * inv
    t2 = (halfs[None] - ro) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)      # (R,S)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = tmax >= torch.clamp_min(tmin, 1e-6)
    t = _where_inf(hit, torch.where(tmin > 1e-6, tmin, tmax))
    ts, j = torch.min(t, dim=1)
    # face normal: dominant axis of the local hit point
    jj = j[:, None, None].expand(-1, 1, 3)
    p_loc = (torch.gather(ro, 1, jj)[:, 0]
             + ts[:, None] * torch.gather(rd, 1, jj)[:, 0])
    q = p_loc / torch.clamp_min(halfs[j], 1e-12)
    ax = torch.argmax(torch.abs(q), dim=-1)
    n_loc = (torch.nn.functional.one_hot(ax, 3).to(q.dtype)
             * torch.sign(torch.gather(q, 1, ax[:, None])))
    n = torch.einsum("rij,rj->ri", rots[j], n_loc)
    return ts, n


def ray_planes(o, d, points, normals):
    """Rays vs infinite planes (S,3),(S,3)."""
    denom = torch.sum(d[:, None, :] * normals[None], dim=-1)
    t = torch.sum((points[None] - o[:, None, :]) * normals[None], dim=-1) \
        / torch.where(torch.abs(denom) < 1e-12,
                      torch.full_like(denom, 1e-12), denom)
    t = _where_inf((torch.abs(denom) > 1e-12) & (t > 1e-6), t)
    ts, j = torch.min(t, dim=1)
    n = normals[j] * -torch.sign(torch.sum(d * normals[j], dim=-1,
                                           keepdim=True))
    return ts, n


def ray_triangles(o, d, v0, v1, v2, chunk=4096):
    """Rays (R,3) vs triangle soup (T,3)×3 — Möller–Trumbore, two-sided.

    Triangles are processed in chunks of ``chunk`` (zero triangles pad the
    last one), each chunk's nearest hit replacing the running one only
    where it is strictly nearer, as the JAX package's scan does."""
    T = v0.shape[0]
    pad = (-T) % chunk
    if pad:
        padv = v0.new_zeros((pad, 3))
        v0 = torch.cat([v0, padv])
        v1 = torch.cat([v1, padv])
        v2 = torch.cat([v2, padv])
    tbest = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
    nbest = torch.zeros_like(o)
    for c0 in range(0, v0.shape[0], chunk):
        a, b_, c = v0[c0:c0 + chunk], v1[c0:c0 + chunk], v2[c0:c0 + chunk]
        e1 = b_ - a                                       # (chunk,3)
        e2 = c - a
        pvec = _cross(d[:, None, :], e2[None])            # (R,chunk,3)
        det = torch.sum(e1[None] * pvec, dim=-1)
        inv = 1.0 / torch.where(torch.abs(det) < 1e-12,
                                torch.full_like(det, 1e-12), det)
        tvec = o[:, None, :] - a[None]
        u = torch.sum(tvec * pvec, dim=-1) * inv
        qvec = _cross(tvec, e1[None])
        v = torch.sum(d[:, None, :] * qvec, dim=-1) * inv
        t = torch.sum(e2[None] * qvec, dim=-1) * inv
        ok = ((torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0)
              & (u + v <= 1) & (t > 1e-6)
              & (torch.sum(e1 * e1 + e2 * e2, dim=-1)[None] > 0))
        t = _where_inf(ok, t)
        ts, j = torch.min(t, dim=1)
        nml = _norm(_cross(e1, e2))[j]
        better = ts < tbest
        nbest = torch.where(
            better[:, None],
            nml * -torch.sign(torch.sum(d * nml, dim=-1, keepdim=True)),
            nbest)
        tbest = torch.where(better, ts, tbest)
    return tbest, nbest


def combine(*hits):
    """min-combine (t, n) results from several primitive families."""
    ts = torch.stack([h[0] for h in hits], dim=0)
    ns = torch.stack([h[1] for h in hits], dim=0)
    t, j = torch.min(ts, dim=0)
    n = torch.gather(ns, 0, j[None, :, None].expand(1, -1, 3))[0]
    return t, n
