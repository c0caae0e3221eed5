"""Segmented track: individual shoe bodies, pin joints, convex NSC contact.

Counterpart of ``chrono_tpu/vehicle/track_shoes.py`` (the reference's
single- and double-pin track assemblies): shoes are BOX convex shapes and
the sprocket and idler are CYLINDERs in the batched MPR narrowphase
(``collision.pipeline.ConvexShapes``); the shoes engage the wheels by rim
friction, or through the analytic pin-in-pocket sprocket gear
(``sprocket_gear_contacts``, a ``Contacts`` block for ``nsc_step``'s
``extra_contacts_fn``).

Layout is an x–z plane oval: two straights + two wraps around the (rear,
front) wheels.  ``add_segmented_track`` returns everything needed to build
the ``CollisionModel`` through ``track_collision_shapes``.  The builders
are host code on the port's ``SystemBuilder``; the shapes go to the card
unless ``device`` names another.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from chrono_tpu_torch.collision import mpr
from chrono_tpu_torch.collision.pipeline import ConvexShapes, Contacts
from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.builder import SystemBuilder
from chrono_tpu_torch.utils.device import resolve_device


class SegmentedTrack(NamedTuple):
    shoes: list          # body ids, ordered around the loop
    sprocket: int        # driven wheel body id
    idler: int
    pitch: float
    wheel_r: float
    shoe_half: tuple     # (hx, hy, hz) collision half extents


def _oval_at(c_rear, c_front, rp, s):
    """(pos, tangent-angle-about-y) at arclength ``s`` on the oval of
    'radius' rp around the two x–z centers (counter-clockwise seen from +y:
    bottom strand runs rear→front)."""
    c_rear = np.asarray(c_rear, float)
    c_front = np.asarray(c_front, float)
    d = float(np.linalg.norm(c_front - c_rear))
    L = 2.0 * d + 2.0 * np.pi * rp
    ex = (c_front - c_rear) / d                  # unit along the straights
    s = s % L
    if s < d:                                     # bottom strand (z = -rp)
        p = c_rear + s * ex + np.array([0.0, 0.0, -rp])
        a = 0.0
    elif s < d + np.pi * rp:                      # front wrap (CCW from -z)
        t = (s - d) / rp
        p = c_front + rp * np.array([np.sin(t), 0.0, -np.cos(t)])
        a = t
    elif s < 2 * d + np.pi * rp:                  # top strand (z = +rp)
        p = c_front - (s - d - np.pi * rp) * ex + np.array([0, 0, rp])
        a = np.pi
    else:                                         # rear wrap
        t = (s - 2 * d - np.pi * rp) / rp
        p = c_rear + rp * np.array([-np.sin(t), 0.0, np.cos(t)])
        a = np.pi + t
    return p, a


def _oval(c_rear, c_front, rp, n: int):
    """n equally spaced samples on the oval (see :func:`_oval_at`)."""
    c_rear = np.asarray(c_rear, float)
    c_front = np.asarray(c_front, float)
    d = float(np.linalg.norm(c_front - c_rear))
    L = 2.0 * d + 2.0 * np.pi * rp
    ds = L / n
    pts, angs = [], []
    for i in range(n):
        p, a = _oval_at(c_rear, c_front, rp, i * ds)
        pts.append(p)
        angs.append(a)
    return np.asarray(pts), np.asarray(angs), ds


def add_segmented_track(bld: SystemBuilder, chassis: int,
                        c_rear, c_front, wheel_r: float,
                        n_shoes: int, shoe_h: float, shoe_w: float,
                        shoe_mass: float = 1.0, wheel_mass: float = 5.0,
                        clearance: float = 2e-3) -> SegmentedTrack:
    """Build one track: sprocket (at c_front) + idler (at c_rear) revolute on
    the chassis, ``n_shoes`` shoes pinned in a loop around both wheels."""
    rp = wheel_r + 0.5 * shoe_h + clearance      # path of shoe centers
    pts, angs, pitch = _oval(c_rear, c_front, rp, n_shoes)
    hx = 0.5 * pitch - 0.15 * shoe_h             # gap so neighbors never touch
    half = (hx, 0.5 * shoe_w, 0.5 * shoe_h)

    iner_w = (0.5 * wheel_mass * wheel_r**2,) * 3
    sprocket = bld.add_body(mass=wheel_mass, inertia=iner_w, pos=c_front)
    idler = bld.add_body(mass=wheel_mass, inertia=iner_w, pos=c_rear)
    bld.add_joint("revolute", chassis, sprocket, world_pos=c_front,
                  world_axis=(0, 1, 0))
    bld.add_joint("revolute", chassis, idler, world_pos=c_rear,
                  world_axis=(0, 1, 0))

    ish = shoe_mass * (half[0]**2 + half[2]**2) / 3.0
    shoes = []
    for p, a in zip(pts, angs):
        q = (np.cos(a / 2), 0.0, np.sin(a / 2), 0.0)
        shoes.append(bld.add_body(
            mass=shoe_mass, inertia=(ish, ish, ish), pos=tuple(p), rot=q))
    # pin joints at the midpoints between consecutive shoe centers
    for i in range(n_shoes):
        j = (i + 1) % n_shoes
        mid = 0.5 * (pts[i] + pts[j])
        bld.add_joint("revolute", shoes[i], shoes[j], world_pos=tuple(mid),
                      world_axis=(0, 1, 0))
    return SegmentedTrack(shoes=shoes, sprocket=sprocket, idler=idler,
                          pitch=pitch, wheel_r=wheel_r, shoe_half=half)


class DoublePinTrack(NamedTuple):
    """Double-pin track: shoe bodies linked through CONNECTOR bodies.

    Counterpart of the reference's ChTrackShoeDoublePin (its
    tracked_vehicle/track_shoe/ChTrackShoeDoublePin.h, one-connector
    topology): shoe[i] —rev— connector[i] —rev— shoe[i+1], so each pitch
    articulates at TWO pins and the connector is the element the sprocket
    engages (ChSprocketDoublePin seats the connector between teeth).
    Attribute names match SegmentedTrack so :func:`track_collision_shapes`
    works unchanged (connectors carry no collision shape — they ride in
    the shoe gaps and engage only through the analytic gear pockets)."""

    shoes: list
    connectors: list
    sprocket: int
    idler: int
    pitch: float
    wheel_r: float
    shoe_half: tuple


def add_segmented_track_double_pin(
        bld: SystemBuilder, chassis: int, c_rear, c_front, wheel_r: float,
        n_shoes: int, shoe_h: float, shoe_w: float, shoe_mass: float = 1.0,
        connector_frac: float = 0.35, connector_mass: float = None,
        wheel_mass: float = 5.0, clearance: float = 2e-3,
        pin_rsda=(1.0, 0.05), tensioner=(2e4, 2e2, 200.0)) -> DoublePinTrack:
    """Build one double-pin track: each pitch = a shoe of length
    (1−connector_frac)·pitch plus a connector of length
    connector_frac·pitch, joined by revolute pins at both connector ends
    (both pins lie on the shoe-center oval).

    ``pin_rsda`` = (k, c) torsional bushing at each connector pin, rest at
    the taut build configuration — the reference's double-pin shoes are
    rubber-bushed (ChTrackShoeDoublePin bushing mode).  Physically this is
    the pin-bushing stiffness; numerically it suppresses the chain's
    concertina mode (the light connector folding about its two pins makes
    the chain axially compliant — measured: the sprocket unfolds connectors
    instead of circulating the loop).

    ``tensioner`` = (k, c, preload): the idler rides an x-prismatic on the
    chassis with a TSDA pre-pushing it AWAY from the sprocket (the
    reference's ChIdler tensioner, tracked_vehicle/idler/ChIdler.h) —
    without loop tension the compression-side strand buckles into the
    concertina mode and circulation stalls (measured ~35% slip).  ``None``
    pins the idler on a plain revolute (the single-pin builder's rig)."""
    rp = wheel_r + 0.5 * shoe_h + clearance
    c_rear = np.asarray(c_rear, float)
    c_front = np.asarray(c_front, float)
    d = float(np.linalg.norm(c_front - c_rear))
    L = 2.0 * d + 2.0 * np.pi * rp
    pitch = L / n_shoes
    Ls = (1.0 - connector_frac) * pitch
    Lc = connector_frac * pitch
    if connector_mass is None:
        connector_mass = 0.25 * shoe_mass
    hx = 0.5 * Ls - 0.15 * shoe_h
    half = (hx, 0.5 * shoe_w, 0.5 * shoe_h)

    iner_w = (0.5 * wheel_mass * wheel_r**2,) * 3
    sprocket = bld.add_body(mass=wheel_mass, inertia=iner_w, pos=c_front)
    bld.add_joint("revolute", chassis, sprocket, world_pos=c_front,
                  world_axis=(0, 1, 0))
    if tensioner is None:
        idler = bld.add_body(mass=wheel_mass, inertia=iner_w, pos=c_rear)
        bld.add_joint("revolute", chassis, idler, world_pos=c_rear,
                      world_axis=(0, 1, 0))
    else:
        # idler carrier on an x-rail + preloaded TSDA (ChIdler tensioner
        # role): the spring pushes the idler away from the sprocket so the
        # loop stays taut as pin bushings articulate
        k_t, c_t, f0 = tensioner
        ex = (c_front - c_rear) / d
        carrier = bld.add_body(mass=0.2 * wheel_mass,
                               inertia=(1e-3, 1e-3, 1e-3), pos=tuple(c_rear))
        bld.add_joint("prismatic", chassis, carrier, world_pos=tuple(c_rear),
                      world_axis=tuple(ex))
        bld.add_tsda(chassis, carrier, pa_world=tuple(c_rear + 0.3 * ex),
                     pb_world=tuple(c_rear), k=k_t, c=c_t, f_actuation=-f0)
        idler = bld.add_body(mass=wheel_mass, inertia=iner_w,
                             pos=tuple(c_rear))
        bld.add_joint("revolute", carrier, idler, world_pos=tuple(c_rear),
                      world_axis=(0, 1, 0))

    ish = shoe_mass * (half[0]**2 + half[2]**2) / 3.0
    icn = max(connector_mass * Lc**2 / 12.0, 1e-4)
    shoes, conns = [], []
    for i in range(n_shoes):
        s = i * pitch
        p, a = _oval_at(c_rear, c_front, rp, s)
        # alpha = -a aligns body x with the travel tangent (see the
        # single-pin builder note)
        q = (np.cos(a / 2), 0.0, -np.sin(a / 2), 0.0)
        shoes.append(bld.add_body(
            mass=shoe_mass, inertia=(ish, ish, ish), pos=tuple(p), rot=q))
        pc, ac = _oval_at(c_rear, c_front, rp, s + 0.5 * pitch)
        qc = (np.cos(ac / 2), 0.0, -np.sin(ac / 2), 0.0)
        conns.append(bld.add_body(
            mass=connector_mass, inertia=(icn, icn, icn), pos=tuple(pc),
            rot=qc))
    for i in range(n_shoes):
        s = i * pitch
        pA, _ = _oval_at(c_rear, c_front, rp, s + 0.5 * Ls)
        pB, _ = _oval_at(c_rear, c_front, rp, s + pitch - 0.5 * Ls)
        bld.add_joint("revolute", shoes[i], conns[i], world_pos=tuple(pA),
                      world_axis=(0, 1, 0))
        bld.add_joint("revolute", conns[i], shoes[(i + 1) % n_shoes],
                      world_pos=tuple(pB), world_axis=(0, 1, 0))
        if pin_rsda is not None and (pin_rsda[0] or pin_rsda[1]):
            bld.add_rsda(shoes[i], conns[i], world_axis=(0, 1, 0),
                         k=pin_rsda[0], c=pin_rsda[1])
            bld.add_rsda(conns[i], shoes[(i + 1) % n_shoes],
                         world_axis=(0, 1, 0),
                         k=pin_rsda[0], c=pin_rsda[1])
    return DoublePinTrack(shoes=shoes, connectors=conns, sprocket=sprocket,
                          idler=idler, pitch=pitch, wheel_r=wheel_r,
                          shoe_half=half)


def track_collision_shapes(track: SegmentedTrack, mu_shoe: float = 0.9,
                           mu_rim: float = 1.5, extra=None, device=None
                           ) -> ConvexShapes:
    """ConvexShapes for the track (+ optional ``extra`` ConvexShapes rows,
    e.g. the ground box) for ``collision.pipeline.CollisionModel``, on the
    card unless ``device`` (or ``extra``'s device) names another."""
    device = (extra.body.device if extra is not None and device is None
              else resolve_device(device, "track_collision_shapes"))
    n = len(track.shoes)
    V = 8
    qx = (np.sqrt(0.5), np.sqrt(0.5), 0.0, 0.0)  # local z → world y (cyl axis)
    body = list(track.shoes) + [track.sprocket, track.idler]
    kind = [mpr.BOX] * n + [mpr.CYLINDER] * 2
    data = [list(track.shoe_half)] * n + \
        [[track.wheel_r, 0.5 * track.shoe_half[1], 0.0]] * 2
    rot = [[1.0, 0, 0, 0]] * n + [list(qx)] * 2
    mu = [mu_shoe] * n + [mu_rim] * 2
    # shoes share collision family 1: pinned neighbours on the wrap arcs
    # graze at their corners and must not generate shoe–shoe contacts
    fam = [1] * n + [0] * 2

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    out = ConvexShapes(
        body=t(body, torch.int32), kind=t(kind, torch.int32),
        pos=torch.zeros((n + 2, 3), device=device),
        rot=t(np.asarray(rot, np.float32)),
        data=t(np.asarray(data, np.float32)),
        verts=torch.zeros((n + 2, V, 3), device=device),
        mu=t(np.asarray(mu, np.float32)), family=t(fam, torch.int32))
    if extra is not None:
        ef = (extra.family if extra.family is not None
              else torch.zeros((extra.n,), dtype=torch.int32, device=device))
        out = ConvexShapes(
            body=torch.cat([out.body, extra.body]),
            kind=torch.cat([out.kind, extra.kind]),
            pos=torch.cat([out.pos, extra.pos]),
            rot=torch.cat([out.rot, extra.rot]),
            data=torch.cat([out.data, extra.data]),
            verts=torch.cat([out.verts, extra.verts]),
            mu=torch.cat([out.mu, extra.mu]),
            family=torch.cat([out.family, ef]))
    return out


def ground_shape(body_id: int, half=(50.0, 50.0, 0.5), z_top: float = 0.0,
                 mu: float = 0.9, device=None) -> ConvexShapes:
    """A ground box whose top face is at ``z_top``, on the card unless
    ``device`` names another."""
    device = resolve_device(device, "ground_shape")
    V = 8

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ConvexShapes(
        body=t([body_id], torch.int32), kind=t([mpr.BOX], torch.int32),
        pos=t(np.asarray([[0.0, 0.0, z_top - half[2]]], np.float32)),
        rot=t(np.asarray([[1.0, 0, 0, 0]], np.float32)),
        data=t(np.asarray([list(half)], np.float32)),
        verts=torch.zeros((1, V, 3), device=device),
        mu=t(np.asarray([mu], np.float32)))


class SprocketGear(NamedTuple):
    """Tooth-profile engagement parameters (pin-in-pocket model).

    The reference resolves 2-D contact between the sprocket gear profile
    and the shoe pin circles in the sprocket plane
    (its tracked_vehicle/sprocket/ChSprocketSinglePin.cpp GetCollision —
    arcs + flank lines per tooth).  Batched equivalent: each tooth SEAT is a concave circular pocket of
    radius ``rho`` centered on the pitch circle ``R_seat``; the pin
    (radius ``r_pin``) contacts the pocket wall when its in-plane distance
    from the nearest seat center exceeds ``rho − r_pin``.  One closed-form
    branch-free contact per pin covers both flanks and the root, and the
    pocket wall is what transmits torque — no rim friction needed.
    """

    sprocket: int        # body id
    shoes: tuple         # engaged body ids (loop order); for double-pin
    #                      tracks these are the CONNECTOR bodies
    n_teeth: int
    R_seat: float        # seat-center (pitch) radius
    rho: float           # pocket radius
    r_pin: float
    phase: float = 0.0   # tooth angular offset at q_sprocket = identity
    direct_pins: bool = False
    #   False: the pin is the chord midpoint between consecutive engaged
    #          bodies (single-pin — the articulation point between shoes);
    #   True:  the engaged bodies are double-pin CONNECTORS — the tooth
    #          flanks seat BOTH pin bushings of each connector
    #          (ChSprocketDoublePin role), at body-local ±pin_half_span
    #          along the connector x axis
    pin_half_span: float = 0.0   # 0.5·connector pin spacing (direct_pins)
    peel_release: float = 0.0
    #   >0: release a pin whose seat→pin offset has a radial-outward
    #   component beyond peel_release·rho (the wrap-exit grab cut; see
    #   sprocket_gear_contacts).  0 disables — the single-pin geometry
    #   rides its pins radially outward UNDER LOAD (R_seat < rp), so the
    #   cut would drop loaded drive contacts there (measured +4% slip)


def make_sprocket_gear(track: SegmentedTrack, state0,
                       r_pin: float = None,
                       clearance: float = 1.5) -> SprocketGear:
    """Gear parameters consistent with the track pitch.

    The PIN of link i is the chord midpoint between consecutive shoe
    centers — the actual articulation point of the pin joint
    (add_segmented_track places joints there).  On the wrap, midpoints
    subtend exactly the shoe-center arc spacing θ = pitch/rp at radius
    rp·cos(θ/2), so seats spaced θ on that circle match ALL wrapped pins
    simultaneously; the tooth count is round(2π/θ) (build the scene with
    2π/θ integer — e.g. pick the wheel span — or the residual pitch
    mismatch accumulates around the wrap and the pockets fight each
    other, exactly as a mispitched chain jams a real sprocket).  Tooth
    phase is measured from the t = 0 configuration so the wrapped pins
    start seated."""
    pitch = track.pitch
    rp = track.wheel_r + track.shoe_half[2] + 2e-3  # matches _oval's path
    theta = pitch / rp                              # pin spacing on the wrap
    n_teeth = max(4, int(round(2.0 * np.pi / theta)))
    R_seat = rp * np.cos(0.5 * theta)
    if r_pin is None:
        r_pin = 0.35 * track.shoe_half[2]
    rho = (1.0 + clearance) * r_pin

    # phase from the wrapped pin (midpoint) closest to the pitch circle at
    # t = 0 (sprocket starts at identity rotation)
    x = state0.x.detach().cpu().numpy()
    c = x[track.sprocket]
    per = 2.0 * np.pi / n_teeth
    best, phase = 1e30, 0.0
    ns = len(track.shoes)
    for i, s in enumerate(track.shoes):
        pin = 0.5 * (x[s] + x[track.shoes[(i + 1) % ns]])
        d = pin - c
        r = float(np.hypot(d[0], d[2]))
        if abs(r - R_seat) < best:
            best = abs(r - R_seat)
            phase = float(np.arctan2(-d[2], d[0]))
    return SprocketGear(sprocket=track.sprocket, shoes=tuple(track.shoes),
                        n_teeth=n_teeth, R_seat=R_seat, rho=rho,
                        r_pin=r_pin, phase=phase % per)


def make_sprocket_gear_double_pin(track: DoublePinTrack, state0,
                                  r_pin: float = None,
                                  clearance: float = 1.5) -> SprocketGear:
    """Gear parameters for a double-pin track: the sprocket seats BOTH pin
    bushings of each CONNECTOR body (ChSprocketDoublePin role — the
    reference's gear profile contacts both pin circles of the connector,
    its tracked_vehicle/sprocket/ChSprocketDoublePin.cpp GetCollision).  Engaging only the connector
    CENTER leaves its yaw free — the connector folds about its own pins
    instead of driving the chain (measured: ~20% slip) — so each tooth
    carries TWO seats, at the connector-center angle ± half the
    connector's angular span, and the contact rows act at the two pin
    points (body-local ±pin_half_span·x̂) with real lever arms.

    The connector's pins ride the pin circle: connector pins sit on the
    shoe-center oval (radius rp on the wrap), so R_seat = rp and the
    tooth spacing is the pitch angle θ = pitch/rp."""
    pitch = track.pitch
    rp = track.wheel_r + track.shoe_half[2] + 2e-3
    theta = pitch / rp
    n_teeth = max(4, int(round(2.0 * np.pi / theta)))
    R_seat = rp
    if r_pin is None:
        r_pin = 0.35 * track.shoe_half[2]
    rho = (1.0 + clearance) * r_pin

    x = state0.x.detach().cpu().numpy()
    c = x[track.sprocket]
    per = 2.0 * np.pi / n_teeth
    best, phase = 1e30, 0.0
    for b in track.connectors:
        d = x[b] - c
        r = float(np.hypot(d[0], d[2]))
        if abs(r - R_seat) < best:
            best = abs(r - R_seat)
            phase = float(np.arctan2(-d[2], d[0]))
    # pin spacing from the first two connectors' pin joints: the builder
    # pins the connector at ±0.5·Lc along its local x
    Lc = track.pitch - 2.0 * (track.shoe_half[0] + 0.15 *
                              2.0 * track.shoe_half[2])
    # (shoe_half[0] = 0.5·Ls − 0.15·shoe_h ⇒ Ls = 2·(hx + 0.15·shoe_h);
    #  Lc = pitch − Ls)
    return SprocketGear(sprocket=track.sprocket,
                        shoes=tuple(track.connectors), n_teeth=n_teeth,
                        R_seat=R_seat, rho=rho, r_pin=r_pin,
                        phase=phase % per, direct_pins=True,
                        pin_half_span=0.5 * Lc, peel_release=0.5)


def matched_track_span(wheel_r: float, shoe_h: float, n_shoes: int,
                       n_teeth: int, clearance: float = 2e-3) -> float:
    """Wheel center distance d such that the track pitch divides the wrap
    circle into exactly ``n_teeth`` — the chain/sprocket pitch-matching a
    track designer does (cf. the reference's sprocket JSON whose tooth
    count is chosen against the shoe pitch).  pitch = L/n_shoes,
    θ = pitch/rp, want n_teeth·θ = 2π  →  L = n_shoes·2π·rp/n_teeth."""
    rp = wheel_r + 0.5 * shoe_h + clearance
    L = n_shoes * 2.0 * np.pi * rp / n_teeth
    return (L - 2.0 * np.pi * rp) / 2.0


def sprocket_gear_contacts(gear: SprocketGear, state, mu: float = 0.2):
    """Analytic Contacts buffer (capacity = n_shoes, or twice that for a
    double-pin gear) for the pin-in-pocket tooth engagement — pass as
    ``extra_contacts_fn`` to ``collision.pipeline.nsc_step``.

    All in the sprocket's x–z plane (track axis y): each pin's world
    position folds into the tooth period around the current sprocket angle,
    the nearest seat center is rebuilt in world coordinates, and the
    contact normal is the in-plane pocket-wall normal (seat → pin, flipped
    to the pipeline's A→B convention).  The row is written against the
    pin's leading shoe; the pin joint carries the reaction to its
    neighbour."""
    dev, dt = state.x.device, state.x.dtype
    shoes = torch.as_tensor(gear.shoes, dtype=torch.int64, device=dev)
    sp = gear.sprocket
    ex1 = torch.eye(3, dtype=dt, device=dev)[0]
    if gear.direct_pins:
        # double-pin: the tooth seats both pin bushings of the connector
        # (body-local ±pin_half_span·x̂) on two seat lattices offset by ±δ
        # around the tooth center; the local −x pin binds to the +δ one
        hs = gear.pin_half_span
        exc = Q.qrotate(state.q[shoes], ex1)
        xc = state.x[shoes]
        pins = torch.cat([xc - hs * exc, xc + hs * exc], dim=0)
        delta = float(np.arcsin(min(1.0, hs / gear.R_seat)))
        n1 = len(gear.shoes)
        seat_off = torch.cat([torch.full((n1,), delta, dtype=dt, device=dev),
                              torch.full((n1,), -delta, dtype=dt,
                                         device=dev)])
        bodies = torch.cat([shoes, shoes])
    else:                                # single-pin: articulation midpoint
        nxt = torch.as_tensor(tuple(gear.shoes[1:]) + (gear.shoes[0],),
                              dtype=torch.int64, device=dev)
        pins = 0.5 * (state.x[shoes] + state.x[nxt])
        seat_off = torch.zeros((len(gear.shoes),), dtype=dt, device=dev)
        bodies = shoes
    c = state.x[sp]
    qs = state.q[sp]
    # sprocket angle about its y axis: the body x-axis in the world x–z
    # plane
    ex = Q.qrotate(qs, ex1)
    th_s = torch.atan2(-ex[2], ex[0])                # rotation about +y
    d = pins - c[None]
    phi = torch.atan2(-d[:, 2], d[:, 0])             # pin angle about +y
    per = 2.0 * np.pi / gear.n_teeth
    # nearest seat around the current sprocket rotation (seats are
    # body-fixed at phase + seat_off + k·per, carried to world by +th_s)
    k = torch.round((phi - th_s - gear.phase - seat_off) / per)
    th_k = th_s + gear.phase + seat_off + k * per    # seat angle (world)
    seat = c[None] + gear.R_seat * torch.stack(
        [torch.cos(th_k), torch.zeros_like(th_k), -torch.sin(th_k)], dim=1)
    e = pins - seat
    e = torch.stack([e[:, 0], torch.zeros_like(e[:, 1]), e[:, 2]], dim=1)
    dist = torch.sqrt(torch.sum(e * e, dim=1) + 1e-12)
    # a perfectly seated pin has e ≈ 0: fall back to the in-plane radial
    # unit (always defined, and the row is inactive then)
    r_c = torch.sqrt(d[:, 0] ** 2 + d[:, 2] ** 2) + 1e-12
    radial = torch.stack([d[:, 0], torch.zeros_like(r_c), d[:, 2]],
                         dim=1) / r_c[:, None]
    ehat = torch.where((dist > 1e-4)[:, None], e / dist[:, None], radial)
    gap = (gear.rho - gear.r_pin) - dist             # <0: pin on the wall
    # engage only pins radially near the pitch circle and inside a pocket:
    # a pin between seats at the wrap ↔ straight transitions rides a tooth
    # tip and must not take a deep pocket impulse
    r_pin_c = torch.sqrt(d[:, 0] ** 2 + d[:, 2] ** 2)
    near = torch.abs(r_pin_c - gear.R_seat) < 2.0 * gear.rho
    # peel release (double-pin): release a pin whose seat→pin offset has a
    # radial-outward component beyond peel_release·rho (a real tooth has no
    # outer wall to grab a pin peeling off at the wrap exit)
    if gear.peel_release > 0.0:
        e_r = torch.sum(e * radial, dim=1)
        peel = e_r > gear.peel_release * gear.rho
    else:
        peel = torch.zeros(gap.shape, dtype=torch.bool, device=dev)
    active = near & (~peel) & (gap < 0.0) & (gap > -0.7 * gear.rho)
    n = int(pins.shape[0])
    return Contacts(
        body_a=torch.full((n,), sp, dtype=torch.int32, device=dev),
        body_b=bodies.to(torch.int32),
        point=pins,
        normal=-ehat,                # gap rate = n·(v_pin − v_seat)
        gap=torch.where(active, gap, torch.ones_like(gap)),
        mu=torch.full((n,), mu, dtype=dt, device=dev),
        r_eff=torch.full((n,), gear.r_pin, dtype=dt, device=dev),
        active=active,
        count=active.sum().to(torch.int32))


def add_road_wheel_suspension(bld: SystemBuilder, chassis: int, c_rear,
                              c_front, n_wheels: int, wheel_r: float,
                              arm_len: float, k_torsion: float,
                              c_torsion: float, wheel_mass: float = 3.0,
                              arm_mass: float = 1.0, preload: float = 0.0):
    """Torsion-arm road-wheel stations between the idler and sprocket.

    The reference's ChTranslationalDamperSuspension /
    ChRotationalDamperSuspension templates (tracked_vehicle/suspension/):
    a trailing arm pinned to the chassis with a rotational spring-damper
    (RSDA), carrying a road wheel on a revolute.  Returns (arm ids,
    wheel ids)."""
    c_rear = np.asarray(c_rear, float)
    c_front = np.asarray(c_front, float)
    arms, wheels = [], []
    for i in range(n_wheels):
        f = (i + 1) / (n_wheels + 1)
        pivot = c_rear + f * (c_front - c_rear)
        hub = pivot + np.array([-0.6 * arm_len, 0.0, -0.8 * arm_len])
        arm = bld.add_body(mass=arm_mass,
                           inertia=(arm_mass * arm_len ** 2 / 3,) * 3,
                           pos=tuple(0.5 * (pivot + hub)))
        wheel = bld.add_body(mass=wheel_mass,
                             inertia=(0.4 * wheel_mass * wheel_r ** 2,) * 3,
                             pos=tuple(hub))
        bld.add_joint("revolute", chassis, arm, world_pos=tuple(pivot),
                      world_axis=(0, 1, 0))
        bld.add_joint("revolute", arm, wheel, world_pos=tuple(hub),
                      world_axis=(0, 1, 0))
        bld.add_rsda(chassis, arm, world_axis=(0, 1, 0), k=k_torsion,
                     c=c_torsion, rest_angle=preload)
        arms.append(arm)
        wheels.append(wheel)
    return arms, wheels
