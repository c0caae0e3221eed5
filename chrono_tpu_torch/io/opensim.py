"""OpenSim (.osim) model parser.

Counterpart of ``chrono_tpu/io/opensim.py`` (the reference's
ChParserOpenSim): reads the OpenSim XML body tree (BodySet → Body → Joint
with parent and child frames given as a location and a body-fixed XYZ
Euler orientation) and assembles a ``SystemBuilder`` model, placing each
body by walking the kinematic tree at the default (zero) joint coordinates,
as the reference parser initialises it.

Joints: PinJoint (revolute about joint-frame Z), BallJoint (spherical),
SliderJoint (prismatic along joint-frame X), WeldJoint, UniversalJoint,
FreeJoint (unconstrained).  The frames are computed in float64 numpy, as
the JAX package computes them.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch


def _vec(text, n=3):
    return np.array([float(t) for t in text.split()][:n])


def _euler_xyz_to_quat(rx, ry, rz):
    """Body-fixed XYZ Euler → scalar-first quaternion."""
    def q_axis(a, axis):
        q = np.zeros(4)
        q[0] = np.cos(a / 2)
        q[1 + axis] = np.sin(a / 2)
        return q

    return _qmul(_qmul(q_axis(rx, 0), q_axis(ry, 1)), q_axis(rz, 2))


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _qrot(q, v):
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return R @ v


_JOINT_TAGS = {
    "PinJoint": "revolute",
    "BallJoint": "spherical",
    "SliderJoint": "prismatic",
    "WeldJoint": "weld",
    "UniversalJoint": "universal",
    "FreeJoint": None,            # unconstrained
    "CustomJoint": None,          # approximated as free
}

# the joints take the functional axis as frame z; OpenSim pin is about Z,
# slider is along X → pre-rotate the slider frame (z←x: +90° about y)
_SLIDER_FIX = _euler_xyz_to_quat(0.0, np.pi / 2, 0.0)


def parse_osim(path: str):
    """Parse → dict of bodies: {name: (mass, inertia, joint info)}."""
    root = ET.parse(path).getroot()
    model = root.find("Model")
    out = dict(name=model.get("name"), bodies={}, gravity=None,
               unsupported=[])
    g = model.find("gravity")
    if g is not None:
        out["gravity"] = _vec(g.text)
    for body in model.find("BodySet").find("objects"):
        name = body.get("name")
        mass = float(body.findtext("mass", "0"))
        inertia = tuple(float(body.findtext(f"inertia_{ax}", "1"))
                        for ax in ("xx", "yy", "zz"))
        mass_center = _vec(body.findtext("mass_center", "0 0 0"))
        joint_el = body.find("Joint")
        joint = None
        if joint_el is not None:
            for child in joint_el:
                tag = child.tag
                joint = dict(
                    tag=tag,
                    parent=child.findtext("parent_body"),
                    loc_parent=_vec(child.findtext("location_in_parent",
                                                   "0 0 0")),
                    ori_parent=_vec(child.findtext("orientation_in_parent",
                                                   "0 0 0")),
                    loc_child=_vec(child.findtext("location", "0 0 0")),
                    ori_child=_vec(child.findtext("orientation", "0 0 0")),
                )
                if tag not in _JOINT_TAGS:
                    out["unsupported"].append(tag)
        out["bodies"][name] = dict(mass=mass, inertia=inertia,
                                   mass_center=mass_center, joint=joint)
    return out


def build_system(parsed: dict, dtype=torch.float32, device=None):
    """Assemble (Model, BodyState, {name: body index}): a tree walk at zero
    joint coordinates, on the card unless ``device`` names another."""
    from chrono_tpu_torch.physics.builder import SystemBuilder

    bld = SystemBuilder(dtype=dtype, device=device)
    if parsed["gravity"] is not None:
        bld.set_gravity(parsed["gravity"])

    bodies = parsed["bodies"]
    pose = {}          # body frame world pose (pos, quat)
    idx = {}

    def place(name):
        if name in pose:
            return
        b = bodies[name]
        j = b["joint"]
        if j is None or j["parent"] is None:
            pose[name] = (np.zeros(3), np.array([1.0, 0, 0, 0]))
            return
        place(j["parent"])
        pp, pq = pose[j["parent"]]
        q_jp = _euler_xyz_to_quat(*j["ori_parent"])
        q_jc = _euler_xyz_to_quat(*j["ori_child"])
        # joint frame world pose from the parent side
        p_joint = pp + _qrot(pq, j["loc_parent"])
        q_joint = _qmul(pq, q_jp)
        # child frame: joint frame expressed in child coords at zero coords
        q_child = _qmul(q_joint, q_jc * np.array([1.0, -1, -1, -1]))
        p_child = p_joint - _qrot(q_child, j["loc_child"])
        pose[name] = (p_child, q_child)

    for name in bodies:
        place(name)

    for name, b in bodies.items():
        p, q = pose[name]
        com_world = p + _qrot(q, b["mass_center"])
        ground_like = (b["mass"] == 0 and (b["joint"] is None
                                           or b["joint"]["parent"] is None))
        idx[name] = bld.add_body(
            mass=b["mass"], inertia=b["inertia"], pos=com_world, rot=q,
            fixed=ground_like, name=name)

    for name, b in bodies.items():
        j = b["joint"]
        if j is None or j["parent"] is None:
            continue
        kind = _JOINT_TAGS.get(j["tag"])
        if kind is None:
            continue                      # free/custom: no constraint
        pp, pq = pose[j["parent"]]
        q_fix = _SLIDER_FIX if j["tag"] == "SliderJoint" else \
            np.array([1.0, 0, 0, 0])
        p_joint = pp + _qrot(pq, j["loc_parent"])
        q_joint = _qmul(_qmul(pq, _euler_xyz_to_quat(*j["ori_parent"])),
                        q_fix)
        def rel(frame_p, frame_q, body_name):
            bp, bq = pose[body_name]
            com = bp + _qrot(bq, bodies[body_name]["mass_center"])
            qinv = bq * np.array([1.0, -1, -1, -1])
            return (_qrot(qinv, frame_p - com), _qmul(qinv, frame_q))

        fa_pos, fa_rot = rel(p_joint, q_joint, name)
        fb_pos, fb_rot = rel(p_joint, q_joint, j["parent"])
        bld.add_joint_frames(kind, idx[name], idx[j["parent"]],
                             fa_pos=fa_pos, fa_rot=fa_rot,
                             fb_pos=fb_pos, fb_rot=fb_rot)
    model, state = bld.finalize()
    return model, state, idx


def load_osim(path: str, dtype=torch.float32, device=None):
    """Parse + build in one call → (Model, BodyState, {name: body index})."""
    return build_system(parse_osim(path), dtype=dtype, device=device)
