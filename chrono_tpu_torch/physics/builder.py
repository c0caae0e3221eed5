"""Scene construction API.

Counterpart of ``chrono_tpu/physics/builder.py``: the builder accumulates
plain Python lists, then ``finalize()`` freezes everything into a batched
``Model`` and ``BodyState`` on the builder's device.  Build once, step
forever: construction never touches the hot loop.

The device defaults to the card: ``SystemBuilder()`` builds on ``cuda`` and
raises without one; pass ``device="cpu"`` to build on the CPU.  It never
falls back to the CPU by itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.core.functions import FConst, MotionFunction
from chrono_tpu_torch.physics.body import BodyProps, BodyState
from chrono_tpu_torch.physics.force_elements import (
    BushingData, RSDAData, TSDAData,
)
from chrono_tpu_torch.physics.joints import JOINT_TYPES, JointData
from chrono_tpu_torch.physics.motors import MotorData
from chrono_tpu_torch.physics.shafts import (
    ShaftBodyData, ShaftGearData, ShaftPlanetaryData, ShaftTorqueElements,
)
from chrono_tpu_torch.physics.system import Model
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.tree import is_static


def _as3(v):
    return np.asarray(v, dtype=np.float64).reshape(3)


def _as4(v):
    if v is None:
        return np.array([1.0, 0.0, 0.0, 0.0])
    return np.asarray(v, dtype=np.float64).reshape(4)


def _stack_profiles(profiles, dtype, device):
    """One MotionFunction whose parameters stack those of ``profiles``
    (every one of the same class and static fields) along a new leading
    axis: the batched profile of one motor kind."""
    first = profiles[0]
    if any(type(p) is not type(first) for p in profiles):
        raise ValueError(
            "all motors of one kind must share the same profile type; "
            "split different profiles across motor kinds or pad")
    if isinstance(first, tuple):
        if len({len(p) for p in profiles}) > 1:
            raise ValueError("motor profiles differ in structure")
        return tuple(_stack_profiles(list(ps), dtype, device)
                     for ps in zip(*profiles))
    if dataclasses.is_dataclass(first):
        changes = {}
        for f in dataclasses.fields(first):
            vals = [getattr(p, f.name) for p in profiles]
            if is_static(f):
                if len(set(vals)) > 1:
                    raise ValueError("motor profiles differ in structure")
            else:
                changes[f.name] = _stack_profiles(vals, dtype, device)
        return dataclasses.replace(first, **changes)
    return torch.stack([torch.as_tensor(v, dtype=dtype) for v in profiles]
                       ).to(device)


class SystemBuilder:
    """Accumulates bodies/joints/motors/springs; ``finalize()`` → tensors.

    All frames follow the joint convention of ``physics.joints``: the
    functional axis is the joint frame's z axis.
    """

    def __init__(self, dtype=torch.float32, device=None):
        self.dtype = dtype
        self.device = resolve_device(device, "SystemBuilder")
        self._bodies = []       # dicts
        self._joints = {}       # kind -> list of dicts
        self._motors = {}       # kind -> list of dicts
        self._load_motors = {}
        self._tsda = []
        self._rsda = []
        self._shaft_cons = {}   # kind -> list of dicts
        self._shaft_elems = []  # clutch/spring/torque elements
        self._couplers = {}     # kind -> list of dicts (gear/pulley/rack/screw)
        self._bushings = []
        self.gravity = np.array([0.0, 0.0, -9.81])

    # ---------------- bodies ----------------

    def add_body(self, mass=1.0, inertia=(1.0, 1.0, 1.0), pos=(0, 0, 0),
                 rot=None, vel=(0, 0, 0), omega_local=(0, 0, 0),
                 fixed=False, name=None) -> int:
        """Add a rigid body; returns its index."""
        self._bodies.append(dict(
            mass=float(mass), inertia=_as3(inertia), pos=_as3(pos),
            rot=_as4(rot), vel=_as3(vel), omega=_as3(omega_local),
            fixed=bool(fixed), name=name,
        ))
        return len(self._bodies) - 1

    def add_ground(self, name="ground") -> int:
        return self.add_body(fixed=True, name=name)

    # ---------------- shafts (1-D drivetrain) ----------------

    def add_shaft(self, inertia=1.0, speed=0.0, name=None) -> int:
        """1-DOF rotational inertia (reference ChShaft): a body whose only
        live DOF is spin about its local z axis."""
        idx = self.add_body(mass=0.0, inertia=(1.0, 1.0, float(inertia)),
                            omega_local=(0.0, 0.0, float(speed)), name=name)
        self._bodies[idx]["shaft"] = True
        return idx

    def add_shaft_gear(self, shaft_a, shaft_b, ratio):
        """ω_a = ratio · ω_b (ChShaftsGear)."""
        self._shaft_cons.setdefault("gear", []).append(
            dict(a=shaft_a, b=shaft_b, ratio=float(ratio)))

    def add_shaft_planetary(self, carrier, sun, ring, ratio):
        """Willis equation with ring/sun ratio ψ = z_ring/z_sun:
        (1+ψ) ω_c − ω_s − ψ ω_r = 0 (ChShaftsPlanetary)."""
        psi = float(ratio)
        self._shaft_cons.setdefault("planetary", []).append(
            dict(c=carrier, s=sun, r=ring, cc=1.0 + psi, cs=-1.0, cr=-psi))

    def add_shaft_body(self, shaft, body, axis_local=(0, 0, 1)):
        """Lock a shaft's spin to a body's angular velocity about a
        body-local axis (ChShaftsBody)."""
        self._shaft_cons.setdefault("shaft_body", []).append(
            dict(a=shaft, b=body, axis=_as3(axis_local)))

    def add_shaft_clutch(self, shaft_a, shaft_b, torque_max, c_slip=50.0,
                         engagement=1.0):
        self._shaft_elems.append(dict(a=shaft_a, b=shaft_b, kind=0,
                                      k=float(c_slip), c=float(torque_max),
                                      rest=float(engagement)))

    def add_shaft_torsion_spring(self, shaft_a, shaft_b, k, c=0.0,
                                 rest_angle=0.0):
        self._shaft_elems.append(dict(a=shaft_a, b=shaft_b, kind=1,
                                      k=float(k), c=float(c),
                                      rest=float(rest_angle)))

    def add_shaft_torque(self, shaft_a, shaft_b, torque):
        """Constant applied torque pair (+τ on a, −τ on b)."""
        self._shaft_elems.append(dict(a=shaft_a, b=shaft_b, kind=2,
                                      k=float(torque), c=0.0, rest=0.0))

    def set_gravity(self, g):
        self.gravity = _as3(g)

    # ---------------- joints ----------------

    def _add_joint(self, kind, body_a, body_b, fa_pos, fa_rot, fb_pos, fb_rot,
                   aux=0.0):
        self._joints.setdefault(kind, []).append(dict(
            a=body_a, b=body_b, fa_pos=_as3(fa_pos), fa_rot=_as4(fa_rot),
            fb_pos=_as3(fb_pos), fb_rot=_as4(fb_rot), aux=float(aux),
        ))

    def add_joint(self, kind, body_a, body_b, world_pos=(0, 0, 0),
                  world_axis=(0, 0, 1), aux=0.0):
        """Add a joint at a WORLD anchor point with a WORLD z axis; the
        per-body local joint frames come from the current builder poses."""
        if kind not in JOINT_TYPES:
            raise ValueError(f"unknown joint kind {kind!r}; "
                             f"available: {sorted(JOINT_TYPES)}")
        rot = _quat_z_to(world_axis)
        fa_pos, fa_rot = self._world_to_local(body_a, _as3(world_pos), rot)
        fb_pos, fb_rot = self._world_to_local(body_b, _as3(world_pos), rot)
        self._add_joint(kind, body_a, body_b, fa_pos, fa_rot, fb_pos, fb_rot,
                        aux)

    def add_joint_frames(self, kind, body_a, body_b, fa_pos=(0, 0, 0),
                         fa_rot=None, fb_pos=(0, 0, 0), fb_rot=None, aux=0.0):
        """Add a joint with explicitly given body-local frames."""
        if kind not in JOINT_TYPES:
            raise ValueError(f"unknown joint kind {kind!r}")
        self._add_joint(kind, body_a, body_b, fa_pos, _as4(fa_rot),
                        fb_pos, _as4(fb_rot), aux)

    def add_rev_spherical(self, body_a, body_b, axis_point_world,
                          axis_world=(0, 0, 1), point_world=None,
                          distance=None):
        """Revolute–spherical composite (ChLinkRevoluteSpherical): a point of
        body b held at fixed distance from the revolute axis on body a, in
        the plane normal to the axis.  ``point_world`` defaults to body b's
        position."""
        if point_world is None:
            point_world = self._bodies[body_b]["pos"]
        ap = _as3(axis_point_world)
        z = _as3(axis_world)
        z = z / np.linalg.norm(z)
        d = _as3(point_world) - ap
        if distance is None:
            distance = float(np.linalg.norm(d - (d @ z) * z))
        rot = _quat_z_to(z)
        fa_pos, fa_rot = self._world_to_local(body_a, ap, rot)
        fb_pos, fb_rot = self._world_to_local(body_b, _as3(point_world), rot)
        self._add_joint("rev_spherical", body_a, body_b, fa_pos, fa_rot,
                        fb_pos, fb_rot, aux=distance)

    def add_distance(self, body_a, body_b, pa_world, pb_world, distance=None):
        pa_loc, _ = self._world_to_local(body_a, _as3(pa_world), None)
        pb_loc, _ = self._world_to_local(body_b, _as3(pb_world), None)
        if distance is None:
            distance = float(np.linalg.norm(_as3(pb_world) - _as3(pa_world)))
        self._add_joint("distance", body_a, body_b, pa_loc, None, pb_loc,
                        None, aux=distance)

    # ---------------- transmission couplers (velocity-level) ----------------

    def _add_coupler(self, kind, body_a, body_b, axis_a, axis_b, aux):
        """Velocity-level transmission row (see joints.COUPLER_TYPES)."""
        _, fa_rot = self._world_to_local(body_a, np.zeros(3),
                                         _quat_z_to(axis_a))
        _, fb_rot = self._world_to_local(body_b, np.zeros(3),
                                         _quat_z_to(axis_b))
        self._couplers.setdefault(kind, []).append(dict(
            a=body_a, b=body_b, fa_pos=np.zeros(3), fa_rot=fa_rot,
            fb_pos=np.zeros(3), fb_rot=fb_rot, aux=float(aux)))

    def add_gear(self, body_a, body_b, ratio, axis_a=(0, 0, 1),
                 axis_b=(0, 0, 1), internal=False):
        """Gear pair on 6-DOF bodies (ChLinkLockGear role): rolling pitch
        circles, ratio = r_a/r_b.  External gears counter-rotate."""
        sign = -1.0 if internal else 1.0
        self._add_coupler("gear", body_a, body_b, axis_a, axis_b,
                          sign * float(ratio))

    def add_pulley(self, body_a, body_b, ratio, axis_a=(0, 0, 1),
                   axis_b=(0, 0, 1)):
        """Belt pulley pair (ChLinkLockPulley role): co-rotating, ω_b =
        ratio·ω_a."""
        self._add_coupler("pulley", body_a, body_b, axis_a, axis_b,
                          -float(ratio))

    def add_rack_pinion(self, pinion, rack, radius, pinion_axis=(0, 0, 1),
                        rack_dir=(1, 0, 0)):
        """Pinion rotation drives rack translation (ChLinkRackpinion role)."""
        self._add_coupler("rack_pinion", pinion, rack, pinion_axis, rack_dir,
                          float(radius))

    def add_screw(self, body_a, body_b, pitch, world_pos=(0, 0, 0),
                  world_axis=(0, 0, 1), add_joint=True):
        """Screw joint (ChLinkLockScrew role): cylindrical joint + pitch
        coupling (translation per revolution = pitch)."""
        if add_joint:
            self.add_joint("cylindrical", body_a, body_b, world_pos,
                           world_axis)
        self._add_coupler("screw", body_a, body_b, world_axis, world_axis,
                          float(pitch))

    # ---------------- motors ----------------

    def _add_motor(self, registry, kind, body_a, body_b, world_pos,
                   world_axis, profile):
        rot = _quat_z_to(world_axis)
        fa_pos, fa_rot = self._world_to_local(body_a, _as3(world_pos), rot)
        fb_pos, fb_rot = self._world_to_local(body_b, _as3(world_pos), rot)
        if not isinstance(profile, MotionFunction):
            profile = FConst(c=torch.tensor(float(profile), dtype=self.dtype))
        registry.setdefault(kind, []).append(dict(
            a=body_a, b=body_b, fa_pos=fa_pos, fa_rot=fa_rot,
            fb_pos=fb_pos, fb_rot=fb_rot, profile=profile,
        ))

    def _add_motor_joint(self, add_joint, kind, body_a, body_b, world_pos,
                         world_axis):
        if add_joint:
            self.add_joint(kind, body_a, body_b, world_pos, world_axis)

    def add_motor_rotation_speed(self, body_a, body_b, world_pos, world_axis,
                                 profile, add_joint=True):
        """Speed-driven rotational motor (+ guiding revolute unless
        disabled)."""
        self._add_motor_joint(add_joint, "revolute", body_a, body_b,
                              world_pos, world_axis)
        self._add_motor(self._motors, "rot_speed", body_a, body_b, world_pos,
                        world_axis, profile)

    def add_motor_rotation_angle(self, body_a, body_b, world_pos, world_axis,
                                 profile, add_joint=True):
        self._add_motor_joint(add_joint, "revolute", body_a, body_b,
                              world_pos, world_axis)
        self._add_motor(self._motors, "rot_angle", body_a, body_b, world_pos,
                        world_axis, profile)

    def add_motor_rotation_torque(self, body_a, body_b, world_pos, world_axis,
                                  profile, add_joint=True):
        self._add_motor_joint(add_joint, "revolute", body_a, body_b,
                              world_pos, world_axis)
        self._add_motor(self._load_motors, "rot_torque", body_a, body_b,
                        world_pos, world_axis, profile)

    def add_motor_linear_speed(self, body_a, body_b, world_pos, world_axis,
                               profile, add_joint=True):
        self._add_motor_joint(add_joint, "prismatic", body_a, body_b,
                              world_pos, world_axis)
        self._add_motor(self._motors, "lin_speed", body_a, body_b, world_pos,
                        world_axis, profile)

    def add_motor_linear_position(self, body_a, body_b, world_pos,
                                  world_axis, profile, add_joint=True):
        self._add_motor_joint(add_joint, "prismatic", body_a, body_b,
                              world_pos, world_axis)
        self._add_motor(self._motors, "lin_pos", body_a, body_b, world_pos,
                        world_axis, profile)

    def add_motor_linear_force(self, body_a, body_b, world_pos, world_axis,
                               profile, add_joint=False):
        self._add_motor_joint(add_joint, "prismatic", body_a, body_b,
                              world_pos, world_axis)
        self._add_motor(self._load_motors, "lin_force", body_a, body_b,
                        world_pos, world_axis, profile)

    # ---------------- force elements ----------------

    def add_bushing(self, body_a, body_b, world_pos, world_axis=(0, 0, 1),
                    k_t=(1e5,) * 3, c_t=(1e3,) * 3, k_r=(1e3,) * 3,
                    c_r=(10.0,) * 3):
        """Compliant 6-DOF bushing (ChLinkBushing): per-axis stiffness /
        damping in the bushing frame placed at a WORLD anchor."""
        rot = _quat_z_to(world_axis)
        fa_pos, fa_rot = self._world_to_local(body_a, _as3(world_pos), rot)
        fb_pos, fb_rot = self._world_to_local(body_b, _as3(world_pos), rot)
        self._bushings.append(dict(
            a=body_a, b=body_b, fa_pos=fa_pos, fa_rot=fa_rot,
            fb_pos=fb_pos, fb_rot=fb_rot,
            k_t=_as3(k_t), c_t=_as3(c_t), k_r=_as3(k_r), c_r=_as3(c_r)))

    def add_tsda(self, body_a, body_b, pa_world, pb_world, k=0.0, c=0.0,
                 rest_length=None, f_actuation=0.0):
        pa_loc, _ = self._world_to_local(body_a, _as3(pa_world), None)
        pb_loc, _ = self._world_to_local(body_b, _as3(pb_world), None)
        if rest_length is None:
            rest_length = float(np.linalg.norm(_as3(pb_world)
                                               - _as3(pa_world)))
        self._tsda.append(dict(a=body_a, b=body_b, pa=pa_loc, pb=pb_loc,
                               k=float(k), c=float(c), l0=float(rest_length),
                               fa=float(f_actuation)))

    def add_rsda(self, body_a, body_b, world_axis=(0, 0, 1), k=0.0, c=0.0,
                 rest_angle=0.0, t_actuation=0.0):
        rot = _quat_z_to(world_axis)
        _, fa_rot = self._world_to_local(body_a, np.zeros(3), rot)
        _, fb_rot = self._world_to_local(body_b, np.zeros(3), rot)
        self._rsda.append(dict(a=body_a, b=body_b, fa_rot=fa_rot,
                               fb_rot=fb_rot, k=float(k), c=float(c),
                               a0=float(rest_angle), ta=float(t_actuation)))

    # ---------------- finalize ----------------

    def _world_to_local(self, body_idx, world_pos, world_rot):
        """World anchor/frame → the body's local one, computed in the
        builder's dtype on the CPU (the JAX package computes it in float32
        with 64-bit mode off)."""
        b = self._bodies[body_idx]
        qb_inv = torch.as_tensor(b["rot"] * np.array([1.0, -1.0, -1.0, -1.0]),
                                 dtype=self.dtype)
        loc = Q.qrotate(qb_inv, torch.as_tensor(world_pos - b["pos"],
                                                dtype=self.dtype)).numpy()
        if world_rot is None:
            return loc, None
        return loc, Q.qmul(qb_inv, torch.as_tensor(world_rot,
                                                   dtype=self.dtype)).numpy()

    def _tensor(self, values, dtype=None):
        return torch.as_tensor(np.asarray(values), dtype=dtype or self.dtype
                               ).to(self.device)

    def _index(self, items, key):
        return self._tensor([i[key] for i in items], torch.int32)

    def _stack(self, items, key, conv=np.asarray):
        return self._tensor(np.stack([conv(i[key]) for i in items]))

    def _joint_data(self, items):
        return JointData(
            body_a=self._index(items, "a"), body_b=self._index(items, "b"),
            fa_pos=self._stack(items, "fa_pos"),
            fa_rot=self._stack(items, "fa_rot", _as4),
            fb_pos=self._stack(items, "fb_pos"),
            fb_rot=self._stack(items, "fb_rot", _as4),
            aux=self._tensor([i["aux"] for i in items]),
        )

    def _motor_data(self, items):
        # one MotorData per kind; profiles are stacked parameter-wise for
        # batched evaluation, so they must share one structure within a kind
        return MotorData(
            body_a=self._index(items, "a"), body_b=self._index(items, "b"),
            fa_pos=self._stack(items, "fa_pos"),
            fa_rot=self._stack(items, "fa_rot", _as4),
            fb_pos=self._stack(items, "fb_pos"),
            fb_rot=self._stack(items, "fb_rot", _as4),
            profile=_stack_profiles([i["profile"] for i in items], self.dtype,
                                   self.device),
        )

    def finalize(self):
        """Freeze the scene → ``(Model, BodyState)`` on the builder's
        device."""
        nb = len(self._bodies)
        if nb == 0:
            raise ValueError("empty system")
        bodies = self._bodies
        inv_mass = self._tensor(
            [0.0 if b["fixed"] or b["mass"] <= 0 else 1.0 / b["mass"]
             for b in bodies])
        inertia = self._stack(bodies, "inertia")
        inv_inertia = torch.where(
            inv_mass[:, None] > 0, 1.0 / torch.clamp_min(inertia, 1e-30),
            torch.zeros_like(inertia))
        # shafts: translation fixed, the spin about local z live
        shaft_mask = np.asarray([b.get("shaft", False) for b in bodies])
        if shaft_mask.any():
            shaft_inv = np.zeros((nb, 3))
            shaft_inv[:, 2] = 1.0 / np.maximum(
                np.asarray([b["inertia"][2] for b in bodies]), 1e-30)
            inv_inertia = torch.where(
                self._tensor(shaft_mask, torch.bool)[:, None],
                self._tensor(shaft_inv), inv_inertia)
        props = BodyProps(inv_mass=inv_mass, inertia=inertia,
                          inv_inertia=inv_inertia)
        state = BodyState(x=self._stack(bodies, "pos"),
                          q=self._stack(bodies, "rot"),
                          v=self._stack(bodies, "vel"),
                          w=self._stack(bodies, "omega"))

        tsda = rsda = bushings = None
        if self._tsda:
            s = self._tsda
            tsda = TSDAData(
                body_a=self._index(s, "a"), body_b=self._index(s, "b"),
                pa_loc=self._stack(s, "pa"), pb_loc=self._stack(s, "pb"),
                k=self._stack(s, "k"), c=self._stack(s, "c"),
                rest_len=self._stack(s, "l0"), f_act=self._stack(s, "fa"))
        if self._rsda:
            s = self._rsda
            rsda = RSDAData(
                body_a=self._index(s, "a"), body_b=self._index(s, "b"),
                fa_rot=self._stack(s, "fa_rot"),
                fb_rot=self._stack(s, "fb_rot"),
                k=self._stack(s, "k"), c=self._stack(s, "c"),
                rest_angle=self._stack(s, "a0"), t_act=self._stack(s, "ta"))
        if self._bushings:
            e = self._bushings
            bushings = BushingData(
                body_a=self._index(e, "a"), body_b=self._index(e, "b"),
                fa_pos=self._stack(e, "fa_pos"),
                fa_rot=self._stack(e, "fa_rot", _as4),
                fb_pos=self._stack(e, "fb_pos"),
                fb_rot=self._stack(e, "fb_rot", _as4),
                k_t=self._stack(e, "k_t"), c_t=self._stack(e, "c_t"),
                k_r=self._stack(e, "k_r"), c_r=self._stack(e, "c_r"))

        shaft_cons = {}
        for kind, items in self._shaft_cons.items():
            if kind == "gear":
                shaft_cons[kind] = ShaftGearData(
                    shaft_a=self._index(items, "a"),
                    shaft_b=self._index(items, "b"),
                    ratio=self._stack(items, "ratio"))
            elif kind == "planetary":
                shaft_cons[kind] = ShaftPlanetaryData(
                    carrier=self._index(items, "c"),
                    sun=self._index(items, "s"),
                    ring=self._index(items, "r"),
                    c_carrier=self._stack(items, "cc"),
                    c_sun=self._stack(items, "cs"),
                    c_ring=self._stack(items, "cr"))
            else:
                shaft_cons[kind] = ShaftBodyData(
                    shaft=self._index(items, "a"),
                    body=self._index(items, "b"),
                    axis_local=self._stack(items, "axis"))
        shaft_elems = None
        if self._shaft_elems:
            e = self._shaft_elems
            shaft_elems = ShaftTorqueElements(
                shaft_a=self._index(e, "a"), shaft_b=self._index(e, "b"),
                kind=self._index(e, "kind"), k=self._stack(e, "k"),
                c=self._stack(e, "c"), rest=self._stack(e, "rest"))

        model = Model(
            props=props, gravity=self._tensor(self.gravity),
            joints={k: self._joint_data(v) for k, v in self._joints.items()},
            motors={k: self._motor_data(v) for k, v in self._motors.items()},
            load_motors={k: self._motor_data(v)
                         for k, v in self._load_motors.items()},
            tsda=tsda, rsda=rsda,
            shaft_constraints=shaft_cons, shaft_elements=shaft_elems,
            couplers={k: self._joint_data(v)
                      for k, v in self._couplers.items()},
            bushings=bushings,
        )
        return model, state


def _quat_z_to(axis):
    """Quaternion (numpy) rotating +z onto ``axis``."""
    z = np.array([0.0, 0.0, 1.0])
    a = _as3(axis)
    a = a / np.linalg.norm(a)
    c = float(np.dot(z, a))
    if c > 1.0 - 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    if c < -1.0 + 1e-12:
        return np.array([0.0, 1.0, 0.0, 0.0])  # 180° about x
    axis_r = np.cross(z, a)
    s = np.linalg.norm(axis_r)
    axis_r = axis_r / s
    half = 0.5 * np.arctan2(s, c)
    return np.concatenate([[np.cos(half)], axis_r * np.sin(half)])
