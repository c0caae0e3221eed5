"""2-D profile collision shapes: segments + arcs vs circles.

Counterpart of ``chrono_tpu/collision/profile2d.py`` (the reference's
ChCollisionShapeSegment2D / Arc2D pair, used for resolved gear and sprocket
tooth profiles and pin-in-slot mechanisms).  A :class:`Profile2D` is a
piecewise boundary (segments and arcs) fixed in a body's local x–y plane;
its counterpart shapes are circles (pins) on other bodies in the same
plane.  ``profile_circle_contacts`` returns an analytic ``Contacts`` buffer
(one row per circle: its deepest element contact) for
``collision.pipeline.nsc_step``'s ``extra_contacts_fn``.

Branch-free and batched: per circle, the distances to all elements are
computed and the minimum gap wins (the first element of equal ones).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q


class Profile2D(NamedTuple):
    body: int             # carrying body
    frame_rot: tuple      # body-local quaternion: profile plane = frame x-y
    frame_pos: tuple      # body-local origin of the profile plane
    seg_a: Tensor         # (S, 2) segment start (profile coords)
    seg_b: Tensor         # (S, 2) segment end
    arc_c: Tensor         # (A, 2) arc centers
    arc_r: Tensor         # (A,)
    arc_a0: Tensor        # (A,) start angle
    arc_a1: Tensor        # (A,) end angle (a1 > a0, CCW)
    arc_convex: Tensor    # (A,) +1: contact on the OUTSIDE of the arc
    #                       −1: concave (pocket) — contact on the inside


class ProfileCircles(NamedTuple):
    body: Tensor          # (C,) int32
    offset: Tensor        # (C, 2) circle center in the profile plane of
    #                       its own body frame (same frame convention)
    radius: Tensor        # (C,)
    mu: Tensor            # (C,)


def _seg_closest(p, a, b):
    """Closest points on segments: p (C,1,2) vs a,b (1,S,2) → (C,S,2)."""
    ab = b - a
    t = torch.sum((p - a) * ab, dim=-1) / (torch.sum(ab * ab, dim=-1)
                                           + 1e-30)
    t = torch.clamp(t, 0.0, 1.0)
    return a + t[..., None] * ab


def profile_circle_contacts(prof: Profile2D, circles: ProfileCircles,
                            state, mu: float = None):
    """Analytic Contacts (capacity = n_circles) of circles vs the profile,
    resolved in the world frame; normals point from the profile body (A)
    toward the circle body (B)."""
    from chrono_tpu_torch.collision.pipeline import Contacts

    dt, dev = state.x.dtype, state.x.device
    fr = torch.as_tensor(np.asarray(prof.frame_rot, np.float32), dtype=dt,
                         device=dev)
    fp = torch.as_tensor(np.asarray(prof.frame_pos, np.float32), dtype=dt,
                         device=dev)
    qb = state.q[prof.body]
    xb = state.x[prof.body]
    q_pf = Q.qmul(qb, fr)                  # profile frame → world
    o_pf = xb + Q.qrotate(qb, fp)

    # circle centers → world → profile coordinates
    cb = circles.body.long()
    C = cb.shape[0]
    frC = fr.expand(C, 4)
    pc_w = state.x[cb] + Q.qrotate(
        state.q[cb],
        Q.qrotate(frC, torch.cat([circles.offset,
                                  circles.offset.new_zeros((C, 1))], dim=1))
        + fp.expand(C, 3))
    rel = Q.qrotate_inv(q_pf.expand(C, 4), pc_w - o_pf)
    p2 = rel[:, 0:2]                        # (C, 2) profile-plane coords

    cands_pt, cands_gap, cands_n = [], [], []
    if prof.seg_a.shape[0] > 0:
        q = _seg_closest(p2[:, None, :], prof.seg_a[None], prof.seg_b[None])
        d = p2[:, None, :] - q
        dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-30)
        cands_pt.append(q)
        cands_gap.append(dist - circles.radius[:, None])
        cands_n.append(d / dist[..., None])
    if prof.arc_r.shape[0] > 0:
        d = p2[:, None, :] - prof.arc_c[None]           # (C, A, 2)
        dist_c = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-30)
        ang = torch.atan2(d[..., 1], d[..., 0])
        # fold into [a0, a0+2π) to honour the angular extent
        two_pi = 2.0 * np.pi
        rel_a = torch.remainder(ang - prof.arc_a0[None], two_pi)
        span = torch.remainder(prof.arc_a1 - prof.arc_a0, two_pi)
        span = torch.where(span <= 1e-9, torch.full_like(span, two_pi),
                           span)
        in_arc = rel_a <= span[None]
        a_cl = (torch.minimum(torch.clamp_min(rel_a, 0.0), span[None])
                + prof.arc_a0[None])
        q = prof.arc_c[None] + prof.arc_r[None, :, None] * torch.stack(
            [torch.cos(a_cl), torch.sin(a_cl)], dim=-1)
        dq = p2[:, None, :] - q
        dist_q = torch.sqrt(torch.sum(dq * dq, dim=-1) + 1e-30)
        cvx = prof.arc_convex[None]
        # convex arc: circle outside, gap = |p−c|−R−r; concave pocket:
        # circle inside, gap = R−|p−c|−r, normal toward the center
        gap_in = torch.where(
            cvx > 0,
            dist_c - prof.arc_r[None] - circles.radius[:, None],
            prof.arc_r[None] - dist_c - circles.radius[:, None])
        n_in = torch.where(cvx[..., None] > 0, d / dist_c[..., None],
                           -d / dist_c[..., None])
        # outside the angular extent, fall back to the endpoint distance
        gap_end = dist_q - circles.radius[:, None]
        n_end = dq / dist_q[..., None]
        cands_pt.append(q)
        cands_gap.append(torch.where(in_arc, gap_in, gap_end))
        cands_n.append(torch.where(in_arc[..., None], n_in, n_end))

    gaps = torch.cat(cands_gap, dim=1)                  # (C, E)
    pts = torch.cat(cands_pt, dim=1)
    ns = torch.cat(cands_n, dim=1)
    best = torch.argmin(gaps, dim=1, keepdim=True)
    gap = torch.take_along_dim(gaps, best, dim=1)[:, 0]
    pt2 = torch.take_along_dim(pts, best[..., None], dim=1)[:, 0]
    n2 = torch.take_along_dim(ns, best[..., None], dim=1)[:, 0]

    # back to world
    zero = pt2.new_zeros((C, 1))
    pt_w = o_pf + Q.qrotate(q_pf.expand(C, 4), torch.cat([pt2, zero], dim=1))
    n_w = Q.qrotate(q_pf.expand(C, 4), torch.cat([n2, zero], dim=1))

    active = gap < 0.0
    mu_arr = circles.mu if mu is None else torch.full((C,), mu, dtype=dt,
                                                      device=dev)
    return Contacts(
        body_a=torch.full((C,), prof.body, dtype=torch.int32, device=dev),
        body_b=circles.body, point=pt_w,
        normal=n_w,          # A→B: pushes the circle away from the profile
        gap=torch.where(active, gap, torch.ones_like(gap)),
        mu=mu_arr, r_eff=circles.radius, active=active,
        count=active.sum().to(torch.int32))
