"""Geometric suspension templates (double wishbone, MacPherson, solid
axles and the rest of the reference's linkage families).

Counterpart of ``chrono_tpu/vehicle/suspension.py``: each corner or axle is
assembled from real control-arm bodies, joints, distance rods and
spring-dampers on the generic ``physics.builder.SystemBuilder`` (only
``add_body``, ``add_joint``, ``add_distance``, ``add_tsda`` and
``add_rsda``), so camber, caster and scrub emerge from the geometry.  The
builders are the JAX package's, line for line, so both builders produce the
same model from the same hardpoints; ``wheel_camber`` is the one function on
tensors.

Per double-wishbone corner (left side shown; right side is y-mirrored):
    chassis ─revolute─ UCA ─spherical─ upright ─revolute(y)─ wheel
    chassis ─revolute─ LCA ─spherical─ upright
    chassis/rack ─distance (tie rod)─ upright
    chassis ─TSDA (spring-damper)─ LCA
DOF per corner = 2 (travel + wheel spin) + steer via the tie-rod anchor.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.builder import SystemBuilder


@dataclass
class WishboneHardpoints:
    """Hardpoints in the corner frame: x forward, y left (outboard), z up;
    origin at the wheel center's ground projection.  Defaults are a generic
    SLA (short-long-arm) road-vehicle geometry (HMMWV-class scale)."""

    spindle: tuple = (0.0, 0.0, 0.35)            # wheel center
    uca_front: tuple = (0.15, -0.4, 0.55)        # UCA chassis pivots
    uca_rear: tuple = (-0.15, -0.4, 0.55)
    uca_ball: tuple = (0.0, -0.12, 0.60)         # UCA ball joint on upright
    lca_front: tuple = (0.2, -0.45, 0.18)
    lca_rear: tuple = (-0.2, -0.45, 0.18)
    lca_ball: tuple = (0.0, -0.08, 0.12)
    spring_chassis: tuple = (0.0, -0.35, 0.8)
    spring_lca: tuple = (0.0, -0.2, 0.16)
    tierod_chassis: tuple = (0.25, -0.4, 0.35)   # inner (rack) point
    tierod_upright: tuple = (0.22, -0.1, 0.35)   # outer point on upright

    masses: dict = field(default_factory=lambda: dict(
        uca=6.0, lca=8.0, upright=20.0, wheel=40.0))
    inertias: dict = field(default_factory=lambda: dict(
        uca=(0.03, 0.03, 0.05), lca=(0.05, 0.05, 0.08),
        upright=(0.3, 0.3, 0.3), wheel=(1.5, 2.5, 1.5)))
    spring_k: float = 120e3
    spring_c: float = 8e3
    spring_free_len: float = None   # None → preloaded at assembly length


@dataclass
class CornerBodies:
    uca: int
    lca: int
    upright: int
    wheel: int


def add_double_wishbone_corner(bld: SystemBuilder, chassis: int,
                               origin, hp: WishboneHardpoints,
                               side: int = +1,
                               steered_rack_body: int = None) -> CornerBodies:
    """Assemble one double-wishbone corner.

    ``origin``: world position of the corner frame origin on the chassis;
    ``side``: +1 left (+y outboard), −1 right (hardpoint y negated —
    hardpoints are authored with y toward the chassis, negative);
    ``steered_rack_body``: body carrying the tie-rod inner point (steering
    rack); defaults to the chassis (unsteered corner).
    """
    o = np.asarray(origin, float)

    def P(p):
        p = np.asarray(p, float)
        return o + np.array([p[0], side * p[1], p[2]])

    m, I = hp.masses, hp.inertias

    uca_mid = 0.5 * (np.asarray(hp.uca_front) + np.asarray(hp.uca_rear))
    uca = bld.add_body(mass=m["uca"], inertia=I["uca"],
                       pos=P(0.5 * (uca_mid + np.asarray(hp.uca_ball))))
    lca_mid = 0.5 * (np.asarray(hp.lca_front) + np.asarray(hp.lca_rear))
    lca = bld.add_body(mass=m["lca"], inertia=I["lca"],
                       pos=P(0.5 * (lca_mid + np.asarray(hp.lca_ball))))
    upright = bld.add_body(mass=m["upright"], inertia=I["upright"],
                           pos=P(hp.spindle))
    wheel = bld.add_body(mass=m["wheel"], inertia=I["wheel"],
                         pos=P(hp.spindle))

    # control-arm chassis revolutes: axis through the two chassis pivots
    for arm, pf, pr, ball in ((uca, hp.uca_front, hp.uca_rear, hp.uca_ball),
                              (lca, hp.lca_front, hp.lca_rear, hp.lca_ball)):
        axis = P(pf) - P(pr)
        axis = axis / np.linalg.norm(axis)
        bld.add_joint("revolute", arm, chassis,
                      world_pos=0.5 * (P(pf) + P(pr)), world_axis=axis)
        bld.add_joint("spherical", arm, upright, world_pos=P(ball))

    # tie rod: distance constraint rack/chassis → upright steer arm
    rack = chassis if steered_rack_body is None else steered_rack_body
    bld.add_distance(upright, rack, P(hp.tierod_upright),
                     P(hp.tierod_chassis))

    # spring-damper
    bld.add_tsda(chassis, lca, P(hp.spring_chassis), P(hp.spring_lca),
                 k=hp.spring_k, c=hp.spring_c,
                 rest_length=hp.spring_free_len)

    # wheel spin revolute about the corner lateral (y) axis
    bld.add_joint("revolute", wheel, upright, world_pos=P(hp.spindle),
                  world_axis=(0, 1, 0))
    return CornerBodies(uca=uca, lca=lca, upright=upright, wheel=wheel)


def add_macpherson_corner(bld: SystemBuilder, chassis: int, origin,
                          hp: WishboneHardpoints, side: int = +1,
                          steered_rack_body: int = None) -> CornerBodies:
    """MacPherson strut corner (ChMacPhersonStrut.h): the UCA is replaced by
    a strut — prismatic guide from the chassis top mount to the upright —
    with the spring-damper along it; the LCA and tie rod are as in the
    wishbone template."""
    o = np.asarray(origin, float)

    def P(p):
        p = np.asarray(p, float)
        return o + np.array([p[0], side * p[1], p[2]])

    m, I = hp.masses, hp.inertias
    lca_mid = 0.5 * (np.asarray(hp.lca_front) + np.asarray(hp.lca_rear))
    lca = bld.add_body(mass=m["lca"], inertia=I["lca"],
                       pos=P(0.5 * (lca_mid + np.asarray(hp.lca_ball))))
    upright = bld.add_body(mass=m["upright"], inertia=I["upright"],
                           pos=P(hp.spindle))
    wheel = bld.add_body(mass=m["wheel"], inertia=I["wheel"],
                         pos=P(hp.spindle))

    axis = P(hp.lca_front) - P(hp.lca_rear)
    axis = axis / np.linalg.norm(axis)
    bld.add_joint("revolute", lca, chassis,
                  world_pos=0.5 * (P(hp.lca_front) + P(hp.lca_rear)),
                  world_axis=axis)
    bld.add_joint("spherical", lca, upright, world_pos=P(hp.lca_ball))

    # strut rod: its own body (like the reference's m_strut), universal top
    # mount to the chassis, cylindrical slider to the upright — 2 corner DOF
    strut_axis = P(hp.spring_chassis) - P(hp.lca_ball)
    strut_len = np.linalg.norm(strut_axis)
    strut_axis = strut_axis / strut_len
    strut = bld.add_body(mass=3.0, inertia=(0.02, 0.02, 0.01),
                         pos=P(hp.spring_chassis) - 0.25 * strut_len
                         * strut_axis)
    bld.add_joint("universal", strut, chassis,
                  world_pos=P(hp.spring_chassis), world_axis=strut_axis)
    bld.add_joint("cylindrical", upright, strut,
                  world_pos=P(hp.lca_ball) + 0.3 * strut_len * strut_axis,
                  world_axis=strut_axis)
    bld.add_tsda(chassis, upright, P(hp.spring_chassis), P(hp.spindle),
                 k=hp.spring_k, c=hp.spring_c,
                 rest_length=hp.spring_free_len)

    rack = chassis if steered_rack_body is None else steered_rack_body
    bld.add_distance(upright, rack, P(hp.tierod_upright),
                     P(hp.tierod_chassis))
    bld.add_joint("revolute", wheel, upright, world_pos=P(hp.spindle),
                  world_axis=(0, 1, 0))
    return CornerBodies(lca=lca, uca=-1, upright=upright, wheel=wheel)


def wheel_camber(q_wheel, side: int = +1):
    """Camber angle from a wheel quaternion (…, 4): inclination of the spin
    (local y) axis from the horizontal, positive = top of wheel tilts
    outboard."""
    ey = Q.qrotate(q_wheel, torch.tensor([0.0, 1.0, 0.0],
                                         dtype=q_wheel.dtype,
                                         device=q_wheel.device))
    # angle of the axis out of the horizontal plane, signed by side
    return side * torch.atan2(-ey[..., 2] * side, torch.abs(ey[..., 1]))


@dataclass
class SolidAxleHardpoints:
    """Hardpoints for a solid (live) axle located by two trailing links and
    a Panhard rod (reference ChSolidAxle.h / ChLeafspringAxle.h role).
    Corner frame: origin between the wheels at axle height."""

    track: float = 1.6                            # wheel-to-wheel distance
    axle_z: float = 0.35
    link_chassis: tuple = (0.8, 0.55, 0.40)       # trailing-link front mounts
    link_axle: tuple = (0.05, 0.55, 0.33)         # trailing-link axle mounts
    panhard_chassis: tuple = (-0.05, -0.7, 0.45)
    panhard_axle: tuple = (-0.05, 0.6, 0.40)
    spring_offset_y: float = 0.55
    spring_top_z: float = 0.85
    axle_mass: float = 90.0
    axle_inertia: tuple = (2.0, 0.6, 2.0)
    wheel_mass: float = 40.0
    wheel_inertia: tuple = (1.5, 2.5, 1.5)
    spring_k: float = 150e3
    spring_c: float = 12e3


@dataclass
class AxleBodies:
    axle: int
    wheel_l: int
    wheel_r: int


def add_solid_axle(bld: SystemBuilder, chassis: int, origin,
                   hp: SolidAxleHardpoints) -> AxleBodies:
    """One rigid axle beam carrying both wheels, located by two trailing
    links (distance rods) + a Panhard rod, sprung by two TSDAs.  4 DOF:
    vertical travel, roll, (small) longitudinal compliance via link
    geometry, + 2 wheel spins."""
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    axle = bld.add_body(mass=hp.axle_mass, inertia=hp.axle_inertia,
                        pos=P((0, 0, hp.axle_z)))
    wl = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, hp.track / 2, hp.axle_z)))
    wr = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, -hp.track / 2, hp.axle_z)))
    for side in (+1, -1):
        S = lambda p: P((p[0], side * p[1], p[2]))
        bld.add_distance(axle, chassis, S(hp.link_axle), S(hp.link_chassis))
        bld.add_tsda(chassis, axle,
                     S((0.0, hp.spring_offset_y, hp.spring_top_z)),
                     S((0.0, hp.spring_offset_y, hp.axle_z)),
                     k=hp.spring_k, c=hp.spring_c)
    bld.add_distance(axle, chassis, P(hp.panhard_axle),
                     P(hp.panhard_chassis))
    bld.add_joint("revolute", wl, axle,
                  world_pos=P((0, hp.track / 2, hp.axle_z)),
                  world_axis=(0, 1, 0))
    bld.add_joint("revolute", wr, axle,
                  world_pos=P((0, -hp.track / 2, hp.axle_z)),
                  world_axis=(0, 1, 0))
    return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr)


def add_semi_trailing_arm_corner(bld: SystemBuilder, chassis: int, origin,
                                 sweep_deg: float = 20.0, side: int = +1,
                                 arm_len: float = 0.45, spindle_z: float = 0.35,
                                 spring_k: float = 110e3, spring_c: float = 7e3,
                                 wheel_mass: float = 40.0) -> CornerBodies:
    """Semi-trailing arm corner (reference ChSemiTrailingArm.h): one arm on
    a single chassis revolute whose axis is swept by ``sweep_deg`` from pure
    lateral — travel then induces camber/toe, the template's signature."""
    o = np.asarray(origin, float)
    P = lambda p: o + np.array([p[0], side * p[1], p[2]])
    s = np.radians(sweep_deg)
    axis = np.array([np.sin(s), side * np.cos(s), 0.0])
    pivot = P((arm_len * 0.9, -0.45, spindle_z - 0.05))
    arm = bld.add_body(mass=12.0, inertia=(0.2, 0.2, 0.3),
                       pos=0.5 * (pivot + P((0, 0, spindle_z))))
    wheel = bld.add_body(mass=wheel_mass, inertia=(1.5, 2.5, 1.5),
                         pos=P((0, 0, spindle_z)))
    bld.add_joint("revolute", arm, chassis, world_pos=pivot, world_axis=axis)
    bld.add_tsda(chassis, arm, P((0.0, -0.15, spindle_z + 0.45)),
                 P((0.0, -0.15, spindle_z)), k=spring_k, c=spring_c)
    bld.add_joint("revolute", wheel, arm, world_pos=P((0, 0, spindle_z)),
                  world_axis=(0, 1, 0))
    return CornerBodies(uca=-1, lca=arm, upright=arm, wheel=wheel)


def add_five_link_corner(bld: SystemBuilder, chassis: int, origin,
                         hp: WishboneHardpoints = None, side: int = +1
                         ) -> CornerBodies:
    """Multi-link (5 rod) corner (reference ChMultiLink.h role): the upright
    is located by five distance rods — 1 remaining DOF (travel) + wheel
    spin; link end points reuse the wishbone hardpoint scheme by splitting
    each A-arm into two rods."""
    hp = hp or WishboneHardpoints()
    o = np.asarray(origin, float)

    def P(p):
        p = np.asarray(p, float)
        return o + np.array([p[0], side * p[1], p[2]])

    upright = bld.add_body(mass=hp.masses["upright"],
                           inertia=hp.inertias["upright"],
                           pos=P(hp.spindle))
    wheel = bld.add_body(mass=hp.masses["wheel"],
                         inertia=hp.inertias["wheel"], pos=P(hp.spindle))
    rods = [(hp.uca_front, hp.uca_ball), (hp.uca_rear, hp.uca_ball),
            (hp.lca_front, hp.lca_ball), (hp.lca_rear, hp.lca_ball),
            (hp.tierod_chassis, hp.tierod_upright)]
    for pc, pu in rods:
        bld.add_distance(upright, chassis, P(pu), P(pc))
    bld.add_tsda(chassis, upright, P(hp.spring_chassis), P(hp.spindle),
                 k=hp.spring_k, c=hp.spring_c)
    bld.add_joint("revolute", wheel, upright, world_pos=P(hp.spindle),
                  world_axis=(0, 1, 0))
    return CornerBodies(uca=-1, lca=-1, upright=upright, wheel=wheel)


# --------------------------------------------------------------------------
# the remaining reference template families.  Topologies follow the
# reference headers cited on each builder; hardpoints are generic
# road/truck-scale defaults, overridable per argument.
# --------------------------------------------------------------------------


def add_single_wishbone_corner(bld: SystemBuilder, chassis: int, origin,
                               hp: WishboneHardpoints = None, side: int = +1,
                               steered_rack_body: int = None) -> CornerBodies:
    """Single lower wishbone + telescopic strut
    (ChSingleWishbone.h: one control arm, a strut prismatic to the chassis
    carrying the spring): like MacPherson but the strut is chassis-guided
    (prismatic at a fixed inclination) rather than upright-guided."""
    hp = hp or WishboneHardpoints()
    o = np.asarray(origin, float)

    def P(p):
        p = np.asarray(p, float)
        return o + np.array([p[0], side * p[1], p[2]])

    m, I = hp.masses, hp.inertias
    lca_mid = 0.5 * (np.asarray(hp.lca_front) + np.asarray(hp.lca_rear))
    lca = bld.add_body(mass=m["lca"], inertia=I["lca"],
                       pos=P(0.5 * (lca_mid + np.asarray(hp.lca_ball))))
    upright = bld.add_body(mass=m["upright"], inertia=I["upright"],
                           pos=P(hp.spindle))
    wheel = bld.add_body(mass=m["wheel"], inertia=I["wheel"],
                         pos=P(hp.spindle))
    axis = P(hp.lca_front) - P(hp.lca_rear)
    axis /= np.linalg.norm(axis)
    bld.add_joint("revolute", lca, chassis,
                  world_pos=0.5 * (P(hp.lca_front) + P(hp.lca_rear)),
                  world_axis=axis)
    bld.add_joint("spherical", lca, upright, world_pos=P(hp.lca_ball))
    # upper location: strut axis from chassis top mount to upright top —
    # modeled as a distance rod pair (upper lateral location) + TSDA spring
    bld.add_distance(upright, chassis, P(hp.uca_ball), P(hp.uca_front))
    bld.add_distance(upright, chassis, P(hp.uca_ball), P(hp.uca_rear))
    bld.add_tsda(chassis, lca, P(hp.spring_chassis), P(hp.spring_lca),
                 k=hp.spring_k, c=hp.spring_c,
                 rest_length=hp.spring_free_len)
    rack = chassis if steered_rack_body is None else steered_rack_body
    bld.add_distance(upright, rack, P(hp.tierod_upright),
                     P(hp.tierod_chassis))
    bld.add_joint("revolute", wheel, upright, world_pos=P(hp.spindle),
                  world_axis=(0, 1, 0))
    return CornerBodies(uca=-1, lca=lca, upright=upright, wheel=wheel)


def add_double_wishbone_reduced_corner(bld: SystemBuilder, chassis: int,
                                       origin,
                                       hp: WishboneHardpoints = None,
                                       side: int = +1,
                                       steered_rack_body: int = None
                                       ) -> CornerBodies:
    """Reduced double wishbone (ChDoubleWishboneReduced.h): the control arms
    carry no mass — each A-arm collapses to two massless distance rods on
    the upright (4 rods + tie rod = the reference's 5-constraint upright),
    spring directly chassis→upright."""
    hp = hp or WishboneHardpoints()
    o = np.asarray(origin, float)

    def P(p):
        p = np.asarray(p, float)
        return o + np.array([p[0], side * p[1], p[2]])

    upright = bld.add_body(mass=hp.masses["upright"],
                           inertia=hp.inertias["upright"], pos=P(hp.spindle))
    wheel = bld.add_body(mass=hp.masses["wheel"],
                         inertia=hp.inertias["wheel"], pos=P(hp.spindle))
    for pc, pu in ((hp.uca_front, hp.uca_ball), (hp.uca_rear, hp.uca_ball),
                   (hp.lca_front, hp.lca_ball), (hp.lca_rear, hp.lca_ball)):
        bld.add_distance(upright, chassis, P(pu), P(pc))
    rack = chassis if steered_rack_body is None else steered_rack_body
    bld.add_distance(upright, rack, P(hp.tierod_upright),
                     P(hp.tierod_chassis))
    bld.add_tsda(chassis, upright, P(hp.spring_chassis), P(hp.lca_ball),
                 k=hp.spring_k, c=hp.spring_c,
                 rest_length=hp.spring_free_len)
    bld.add_joint("revolute", wheel, upright, world_pos=P(hp.spindle),
                  world_axis=(0, 1, 0))
    return CornerBodies(uca=-1, lca=-1, upright=upright, wheel=wheel)


def _axle_beam(bld: SystemBuilder, P, hp: SolidAxleHardpoints):
    axle = bld.add_body(mass=hp.axle_mass, inertia=hp.axle_inertia,
                        pos=P((0, 0, hp.axle_z)))
    wl = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, hp.track / 2, hp.axle_z)))
    wr = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, -hp.track / 2, hp.axle_z)))
    return axle, wl, wr


def _axle_wheels(bld, P, axle, wl, wr, hp):
    bld.add_joint("revolute", wl, axle,
                  world_pos=P((0, hp.track / 2, hp.axle_z)),
                  world_axis=(0, 1, 0))
    bld.add_joint("revolute", wr, axle,
                  world_pos=P((0, -hp.track / 2, hp.axle_z)),
                  world_axis=(0, 1, 0))


def _axle_springs(bld, P, chassis, axle, hp):
    for side in (+1, -1):
        bld.add_tsda(chassis, axle,
                     P((0.0, side * hp.spring_offset_y, hp.spring_top_z)),
                     P((0.0, side * hp.spring_offset_y, hp.axle_z)),
                     k=hp.spring_k, c=hp.spring_c)


def _toebar_knuckles(bld: SystemBuilder, P, axle, hp: SolidAxleHardpoints,
                     draglink_body: int, kingpin_incl: float = 0.12):
    """Steerable-axle knuckle pair (the ToeBar* variants' shared mechanism,
    e.g. ChToeBarLeafspringAxle.h): each wheel sits on a knuckle that
    pivots about a kingpin on the axle beam; a tie rod couples the two
    knuckle arms; a drag link steers the left knuckle from
    ``draglink_body`` (pitman arm / steering box output)."""
    kz, yk = hp.axle_z, hp.track / 2 - 0.08
    knuckles, wheels = [], []
    for side in (+1, -1):
        S = lambda p: P((p[0], side * p[1], p[2]))
        kn = bld.add_body(mass=10.0, inertia=(0.1, 0.1, 0.12),
                          pos=S((0, yk, kz)))
        w = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                         pos=S((0, hp.track / 2, kz)))
        kp_axis = np.array([np.sin(kingpin_incl) * side * -1.0, 0.0,
                            np.cos(kingpin_incl)])
        bld.add_joint("revolute", kn, axle, world_pos=S((0, yk, kz)),
                      world_axis=kp_axis)
        bld.add_joint("revolute", w, kn,
                      world_pos=S((0, hp.track / 2, kz)),
                      world_axis=(0, 1, 0))
        knuckles.append(kn)
        wheels.append(w)
    # tie rod between the two knuckle steering arms (behind the kingpins)
    bld.add_distance(knuckles[0], knuckles[1],
                     P((-0.18, yk - 0.05, kz)), P((-0.18, -(yk - 0.05), kz)))
    # drag link: steering input body → left knuckle arm
    bld.add_distance(knuckles[0], draglink_body,
                     P((0.18, yk - 0.05, kz)), P((0.45, yk - 0.05, kz)))
    return knuckles, wheels


def add_leafspring_axle(bld: SystemBuilder, chassis: int, origin,
                        hp: SolidAxleHardpoints = None, toebar: bool = False,
                        draglink_body: int = None):
    """Leaf-spring solid axle (ChLeafspringAxle.h; steerable variant
    ChToeBarLeafspringAxle.h).  The leaf pack is modeled functionally: a
    vertical TSDA per side (vertical rate) plus four guide links
    reproducing the pack's longitudinal/lateral location (the reference's
    basic — non-SAE — template models the leaf exactly this way, as a
    vertical spring + kinematic constraints)."""
    hp = hp or SolidAxleHardpoints()
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    axle = bld.add_body(mass=hp.axle_mass, inertia=hp.axle_inertia,
                        pos=P((0, 0, hp.axle_z)))
    for side in (+1, -1):
        S = lambda p: P((p[0], side * p[1], p[2]))
        # leaf location: front half-leaf and rear half-leaf as two rods
        bld.add_distance(axle, chassis, S((0.0, hp.spring_offset_y,
                                           hp.axle_z)),
                         S((0.55, hp.spring_offset_y, hp.axle_z + 0.05)))
        bld.add_distance(axle, chassis, S((0.0, hp.spring_offset_y,
                                           hp.axle_z)),
                         S((-0.55, hp.spring_offset_y, hp.axle_z + 0.05)))
    _axle_springs(bld, P, chassis, axle, hp)
    # lateral location from the leaf pack stiffness: one transverse rod
    bld.add_distance(axle, chassis, P((0.0, 0.3, hp.axle_z)),
                     P((0.0, -0.45, hp.axle_z + 0.02)))
    if toebar:
        kn, (wl, wr) = _toebar_knuckles(
            bld, P, axle, hp, draglink_body if draglink_body is not None
            else chassis)
        return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr), kn
    wl = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, hp.track / 2, hp.axle_z)))
    wr = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, -hp.track / 2, hp.axle_z)))
    _axle_wheels(bld, P, axle, wl, wr, hp)
    return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr)


def add_sae_leafspring_axle(bld: SystemBuilder, chassis: int, origin,
                            hp: SolidAxleHardpoints = None):
    """SAE multi-body leaf spring (ChSAELeafspringAxle.h): each leaf is
    front-eye pinned to the chassis, rear-eye hung on a swinging SHACKLE
    link, with the axle clamped to the leaf mid-span — the SAE 3-link
    approximation, giving the characteristic wind-up compliance the
    functional model can't."""
    hp = hp or SolidAxleHardpoints()
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    axle, wl, wr = _axle_beam(bld, P, hp)
    half = 0.55
    for side in (+1, -1):
        S = lambda p: P((p[0], side * p[1], p[2]))
        y = hp.spring_offset_y
        # SAE 3-link leaf kinematics per side (5 bodies incl. the axle):
        #   chassis ─rev(eye)─ FRONT half-leaf ─rev(clamp)+RSDA─ REAR
        #   half-leaf ─rev(rear eye)─ SHACKLE ─rev─ chassis
        # with the axle WELDED to the front half-leaf at the seat.  Planar
        # Grübler: 3 moving links, 4 pins → 1 travel DOF; the clamp RSDA is
        # the pack's wrap (wind-up) rate.  (A single leaf body pinned at the
        # eye + shackle is a STRUCTURE — 2 links, 3 pins, 0 DOF — measured:
        # the axle never sags; hence the half-leaf split, exactly the
        # reference's ChSAELeafspringAxle body set.)
        front = bld.add_body(mass=4.0, inertia=(0.02, 0.1, 0.1),
                             pos=S((half / 2, y, hp.axle_z)))
        rear = bld.add_body(mass=4.0, inertia=(0.02, 0.1, 0.1),
                            pos=S((-half / 2, y, hp.axle_z)))
        shackle = bld.add_body(mass=1.0, inertia=(0.01, 0.01, 0.01),
                               pos=S((-half, y, hp.axle_z + 0.06)))
        bld.add_joint("revolute", front, chassis,
                      world_pos=S((half, y, hp.axle_z + 0.05)),
                      world_axis=(0, 1, 0))
        bld.add_joint("revolute", front, rear,
                      world_pos=S((0.0, y, hp.axle_z)), world_axis=(0, 1, 0))
        # the clamp RSDA IS the leaf's spring rate: vertical travel z of the
        # seat rotates front/rear oppositely by ~z/(half/2) each, so
        # k_z ≈ 4·k_rsda/(half/2)² — 2.8e3 N·m/rad ≈ 150 kN/m per side
        bld.add_rsda(front, rear, world_axis=(0, 1, 0), k=2.8e3, c=250.0)
        bld.add_joint("revolute", rear, shackle,
                      world_pos=S((-half, y, hp.axle_z + 0.02)),
                      world_axis=(0, 1, 0))
        bld.add_joint("revolute", shackle, chassis,
                      world_pos=S((-half, y, hp.axle_z + 0.12)),
                      world_axis=(0, 1, 0))
        bld.add_joint("weld", axle, front,
                      world_pos=S((0.0, y, hp.axle_z)))
    _axle_springs(bld, P, chassis, axle, hp)
    # lateral location (leaf packs locate laterally via eye bushings)
    bld.add_distance(axle, chassis, P((0.0, 0.3, hp.axle_z)),
                     P((0.0, -0.45, hp.axle_z + 0.02)))
    _axle_wheels(bld, P, axle, wl, wr, hp)
    return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr)


def add_dedion_axle(bld: SystemBuilder, chassis: int, origin,
                    hp: SolidAxleHardpoints = None, toebar: bool = False,
                    draglink_body: int = None):
    """DeDion axle (ChDeDionAxle.h / ChToeBarDeDionAxle.h): a lightweight
    dead tube ties the wheels (diff is chassis-mounted), located by two
    trailing links and a WATT linkage (center pivot on the tube, two
    horizontal rods to the chassis) for exact lateral guidance."""
    hp = hp or SolidAxleHardpoints()
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    tube_hp = SolidAxleHardpoints(**{**hp.__dict__,
                                     "axle_mass": 0.35 * hp.axle_mass})
    axle = bld.add_body(mass=tube_hp.axle_mass, inertia=tube_hp.axle_inertia,
                        pos=P((0, 0, hp.axle_z)))
    for side in (+1, -1):
        S = lambda p: P((p[0], side * p[1], p[2]))
        bld.add_distance(axle, chassis, S(hp.link_axle), S(hp.link_chassis))
    # Watt linkage: bell crank on the tube + two opposed lateral rods
    crank = bld.add_body(mass=1.5, inertia=(0.01, 0.01, 0.01),
                         pos=P((-0.06, 0.0, hp.axle_z)))
    bld.add_joint("revolute", crank, axle,
                  world_pos=P((-0.06, 0.0, hp.axle_z)), world_axis=(1, 0, 0))
    bld.add_distance(crank, chassis, P((-0.06, 0.0, hp.axle_z + 0.12)),
                     P((-0.06, 0.55, hp.axle_z + 0.12)))
    bld.add_distance(crank, chassis, P((-0.06, 0.0, hp.axle_z - 0.12)),
                     P((-0.06, -0.55, hp.axle_z - 0.12)))
    _axle_springs(bld, P, chassis, axle, hp)
    if toebar:
        kn, (wl, wr) = _toebar_knuckles(
            bld, P, axle, hp, draglink_body if draglink_body is not None
            else chassis)
        return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr), kn
    wl = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, hp.track / 2, hp.axle_z)))
    wr = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, -hp.track / 2, hp.axle_z)))
    _axle_wheels(bld, P, axle, wl, wr, hp)
    return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr)


def add_pushpipe_axle(bld: SystemBuilder, chassis: int, origin,
                      hp: SolidAxleHardpoints = None, toebar: bool = False,
                      draglink_body: int = None):
    """Push-pipe axle (ChPushPipeAxle.h / ChToeBarPushPipeAxle.h, the
    Unimog-style torque tube): the axle beam carries a long longitudinal
    PIPE ball-jointed to the chassis ahead of it — longitudinal and brake/
    drive torque location in one member — plus a Panhard rod laterally."""
    hp = hp or SolidAxleHardpoints()
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    axle, wl, wr = _axle_beam(bld, P, hp)
    # the pipe is rigid with the axle: model as the axle body extended — a
    # spherical joint from the pipe nose to the chassis
    nose = P((1.1, 0.0, hp.axle_z + 0.05))
    bld.add_joint("spherical", axle, chassis, world_pos=nose)
    bld.add_distance(axle, chassis, P(hp.panhard_axle), P(hp.panhard_chassis))
    _axle_springs(bld, P, chassis, axle, hp)
    if toebar:
        kn, (twl, twr) = _toebar_knuckles(
            bld, P, axle, hp, draglink_body if draglink_body is not None
            else chassis)
        return AxleBodies(axle=axle, wheel_l=twl, wheel_r=twr), kn
    _axle_wheels(bld, P, axle, wl, wr, hp)
    return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr)


def add_rigid_panhard_axle(bld: SystemBuilder, chassis: int, origin,
                           hp: SolidAxleHardpoints = None,
                           toebar: bool = False, draglink_body: int = None):
    """Rigid axle on longitudinal guides + Panhard rod
    (ChRigidPanhardAxle.h / ChToeBarRigidPanhardAxle.h)."""
    hp = hp or SolidAxleHardpoints()
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    axle, wl, wr = _axle_beam(bld, P, hp)
    for side in (+1, -1):
        S = lambda p: P((p[0], side * p[1], p[2]))
        bld.add_distance(axle, chassis, S(hp.link_axle), S(hp.link_chassis))
        # upper links resist axle wind-up (the "rigid" guide pair)
        bld.add_distance(axle, chassis,
                         S((hp.link_axle[0], hp.link_axle[1] - 0.12,
                            hp.link_axle[2] + 0.18)),
                         S((hp.link_chassis[0], hp.link_chassis[1] - 0.12,
                            hp.link_chassis[2] + 0.18)))
    bld.add_distance(axle, chassis, P(hp.panhard_axle), P(hp.panhard_chassis))
    _axle_springs(bld, P, chassis, axle, hp)
    if toebar:
        kn, (twl, twr) = _toebar_knuckles(
            bld, P, axle, hp, draglink_body if draglink_body is not None
            else chassis)
        return AxleBodies(axle=axle, wheel_l=twl, wheel_r=twr), kn
    _axle_wheels(bld, P, axle, wl, wr, hp)
    return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr)


def add_rigid_pinned_axle(bld: SystemBuilder, chassis: int, origin,
                          hp: SolidAxleHardpoints = None) -> AxleBodies:
    """Axle pinned to the chassis at its center (ChRigidPinnedAxle.h): one
    longitudinal revolute — the axle can only ROLL relative to the chassis
    (rail-bogie style); no springs."""
    hp = hp or SolidAxleHardpoints()
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    axle, wl, wr = _axle_beam(bld, P, hp)
    bld.add_joint("revolute", axle, chassis,
                  world_pos=P((0, 0, hp.axle_z)), world_axis=(1, 0, 0))
    _axle_wheels(bld, P, axle, wl, wr, hp)
    return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr)


def add_rigid_suspension(bld: SystemBuilder, chassis: int, origin,
                         hp: SolidAxleHardpoints = None) -> AxleBodies:
    """No suspension at all (ChRigidSuspension.h): spindles revolute
    directly on the chassis."""
    hp = hp or SolidAxleHardpoints()
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    wl = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, hp.track / 2, hp.axle_z)))
    wr = bld.add_body(mass=hp.wheel_mass, inertia=hp.wheel_inertia,
                      pos=P((0, -hp.track / 2, hp.axle_z)))
    bld.add_joint("revolute", wl, chassis,
                  world_pos=P((0, hp.track / 2, hp.axle_z)),
                  world_axis=(0, 1, 0))
    bld.add_joint("revolute", wr, chassis,
                  world_pos=P((0, -hp.track / 2, hp.axle_z)),
                  world_axis=(0, 1, 0))
    return AxleBodies(axle=-1, wheel_l=wl, wheel_r=wr)


def add_solid_three_link_axle(bld: SystemBuilder, chassis: int, origin,
                              hp: SolidAxleHardpoints = None,
                              bellcrank: bool = False,
                              draglink_body: int = None):
    """Solid axle on two lower trailing links + one upper triangle link
    (ChSolidThreeLinkAxle.h); the triangle is a wide A-link: spherical at
    the axle, two chassis rods.  ``bellcrank=True`` adds the steerable
    knuckle/bellcrank arrangement (ChSolidBellcrankThreeLinkAxle.h)."""
    hp = hp or SolidAxleHardpoints()
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    axle, wl, wr = _axle_beam(bld, P, hp)
    for side in (+1, -1):
        S = lambda p: P((p[0], side * p[1], p[2]))
        bld.add_distance(axle, chassis, S(hp.link_axle), S(hp.link_chassis))
    # triangle link: apex on the axle top center, two rods up-forward
    apex = P((0.0, 0.0, hp.axle_z + 0.22))
    bld.add_distance(axle, chassis, apex, P((0.7, 0.35, hp.axle_z + 0.35)))
    bld.add_distance(axle, chassis, apex, P((0.7, -0.35, hp.axle_z + 0.35)))
    _axle_springs(bld, P, chassis, axle, hp)
    if bellcrank:
        kn, (twl, twr) = _toebar_knuckles(
            bld, P, axle, hp, draglink_body if draglink_body is not None
            else chassis)
        return AxleBodies(axle=axle, wheel_l=twl, wheel_r=twr), kn
    _axle_wheels(bld, P, axle, wl, wr, hp)
    return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr)


def add_three_link_irs_corner(bld: SystemBuilder, chassis: int, origin,
                              side: int = +1, spindle_z: float = 0.35,
                              spring_k: float = 110e3, spring_c: float = 7e3
                              ) -> CornerBodies:
    """Independent rear 3-link (ChThreeLinkIRS.h): trailing ARM body on a
    chassis spherical, located by an upper camber link and a lower toe
    link — travel induces the template's camber/toe signature."""
    o = np.asarray(origin, float)
    P = lambda p: o + np.array([p[0], side * p[1], p[2]])
    arm = bld.add_body(mass=14.0, inertia=(0.25, 0.25, 0.35),
                       pos=P((0.2, -0.1, spindle_z)))
    wheel = bld.add_body(mass=40.0, inertia=(1.5, 2.5, 1.5),
                         pos=P((0, 0, spindle_z)))
    bld.add_joint("spherical", arm, chassis,
                  world_pos=P((0.45, -0.25, spindle_z)))
    # upper (camber) link and lower (toe) link
    bld.add_distance(arm, chassis, P((0.0, -0.08, spindle_z + 0.2)),
                     P((0.0, -0.5, spindle_z + 0.25)))
    bld.add_distance(arm, chassis, P((-0.15, -0.08, spindle_z - 0.1)),
                     P((-0.15, -0.5, spindle_z - 0.08)))
    bld.add_tsda(chassis, arm, P((0.0, -0.15, spindle_z + 0.5)),
                 P((0.0, -0.15, spindle_z)), k=spring_k, c=spring_c)
    bld.add_joint("revolute", wheel, arm, world_pos=P((0, 0, spindle_z)),
                  world_axis=(0, 1, 0))
    return CornerBodies(uca=-1, lca=arm, upright=arm, wheel=wheel)


def add_hendrickson_primaxx(bld: SystemBuilder, chassis: int, origin,
                            hp: SolidAxleHardpoints = None):
    """Hendrickson PRIMAXX EX walking-beam truck axle
    (ChHendricksonPRIMAXX.h): axle housing located by two LOWER torque rods
    and an upper TRANSVERSE beam (spherical at the housing, revolute at the
    chassis), air springs outboard."""
    hp = hp or SolidAxleHardpoints()
    o = np.asarray(origin, float)
    P = lambda p: o + np.asarray(p, float)
    axle, wl, wr = _axle_beam(bld, P, hp)
    for side in (+1, -1):
        S = lambda p: P((p[0], side * p[1], p[2]))
        bld.add_distance(axle, chassis, S(hp.link_axle), S(hp.link_chassis))
    # transverse beam: a body pinned to the chassis (x revolute) whose ends
    # locate the axle top laterally — Hendrickson's lateral control
    beam = bld.add_body(mass=8.0, inertia=(0.1, 0.05, 0.12),
                        pos=P((0.1, 0.0, hp.axle_z + 0.25)))
    bld.add_joint("revolute", beam, chassis,
                  world_pos=P((0.1, 0.0, hp.axle_z + 0.30)),
                  world_axis=(1, 0, 0))
    bld.add_joint("spherical", beam, axle,
                  world_pos=P((0.1, 0.0, hp.axle_z + 0.20)))
    _axle_springs(bld, P, chassis, axle, hp)
    _axle_wheels(bld, P, axle, wl, wr, hp)
    return AxleBodies(axle=axle, wheel_l=wl, wheel_r=wr)


def add_generic_corner(bld: SystemBuilder, chassis: int, origin, spec,
                       side: int = +1, steered_rack_body: int = None):
    """Data-driven suspension corner of arbitrary topology
    (the reference's ChGenericWheeledSuspension role, chrono_vehicle/
    wheeled_vehicle/suspension/ChGenericWheeledSuspension.h — everything
    except the spindle body + its revolute is specified as data).

    ``spec`` (a dict, e.g. parsed from JSON):
      bodies: {name: {mass, inertia (3,), pos (3,)}}
      joints: [{kind, body1, body2, pos (3,), axis (3,)}]        (optional)
      distances: [{body1, body2, point1 (3,), point2 (3,)}]      (optional)
      tsdas: [{body1, body2, point1, point2, k, c, free_length}] (optional)
      rsdas: [{body1, body2, axis, k, c}]                        (optional)
      spindle: {attachment: <body name>, pos (3,), mass, inertia,
                axis (3,), steered: bool, tierod: {arm (3,), rack (3,)}}
    Body names "chassis" and "rack" refer to the passed-in bodies.
    Hardpoints are authored for the LEFT side (+y outboard) and mirrored
    by ``side``.  Returns (name → body id dict incl. "wheel")."""
    o = np.asarray(origin, float)

    def P(p):
        p = np.asarray(p, float)
        return o + np.array([p[0], side * p[1], p[2]])

    def A(a):
        a = np.asarray(a, float)
        a = np.array([a[0], side * a[1], a[2]])
        return a / np.linalg.norm(a)

    rack = chassis if steered_rack_body is None else steered_rack_body
    ids = {"chassis": chassis, "rack": rack}
    for name, b in spec["bodies"].items():
        ids[name] = bld.add_body(mass=b["mass"],
                                 inertia=tuple(b["inertia"]),
                                 pos=tuple(P(b["pos"])))
    for j in spec.get("joints", ()):
        bld.add_joint(j["kind"], ids[j["body1"]], ids[j["body2"]],
                      world_pos=tuple(P(j["pos"])),
                      world_axis=tuple(A(j.get("axis", (0, 0, 1)))))
    for d in spec.get("distances", ()):
        bld.add_distance(ids[d["body1"]], ids[d["body2"]],
                         tuple(P(d["point1"])), tuple(P(d["point2"])))
    for t in spec.get("tsdas", ()):
        bld.add_tsda(ids[t["body1"]], ids[t["body2"]],
                     tuple(P(t["point1"])), tuple(P(t["point2"])),
                     k=t.get("k", 0.0), c=t.get("c", 0.0),
                     rest_length=t.get("free_length"))
    for r in spec.get("rsdas", ()):
        bld.add_rsda(ids[r["body1"]], ids[r["body2"]],
                     world_axis=tuple(A(r.get("axis", (0, 1, 0)))),
                     k=r.get("k", 0.0), c=r.get("c", 0.0))

    sp = spec["spindle"]
    wheel = bld.add_body(mass=sp["mass"], inertia=tuple(sp["inertia"]),
                         pos=tuple(P(sp["pos"])))
    bld.add_joint("revolute", wheel, ids[sp["attachment"]],
                  world_pos=tuple(P(sp["pos"])),
                  world_axis=tuple(A(sp.get("axis", (0, 1, 0)))))
    if sp.get("steered") and "tierod" in sp:
        bld.add_distance(ids[sp["attachment"]], rack,
                         tuple(P(sp["tierod"]["arm"])),
                         tuple(P(sp["tierod"]["rack"])))
    ids["wheel"] = wheel
    return ids


def load_generic_suspension_json(path):
    """Parse a generic-suspension spec file (JSON) for add_generic_corner."""
    with open(path) as f:
        return json.load(f)
