"""URDF robot-description importer.

Counterpart of ``chrono_tpu/io/urdf.py`` (the reference's URDF parser):
reads links (inertial properties) and joints (revolute / continuous /
prismatic / fixed / planar) from a URDF XML tree and assembles a multibody
model.  Collision geometry tags (sphere, box) are recorded on the parsed
links.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from chrono_tpu_torch.core import quaternion as Q


def _vec(s, default="0 0 0"):
    return np.asarray([float(x) for x in (s or default).split()])


def _f32(v) -> torch.Tensor:
    """A float32 CPU tensor: the link frames are computed on the host in
    float32, as the JAX package computes them."""
    return torch.as_tensor(np.asarray(v, np.float32))


def _rpy_to_quat(rpy) -> np.ndarray:
    return Q.q_from_euler_xyz(_f32(rpy)).numpy()


class URDFModel:
    """Parsed intermediate: kinematic tree of links and joints."""

    def __init__(self):
        self.links = {}    # name -> dict(mass, inertia, com, com_rpy, geom)
        self.joints = []   # dicts
        self.root = None


def parse_urdf(source: str) -> URDFModel:
    """Parse URDF from a file path or an XML string."""
    if source.strip().startswith("<"):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()
    m = URDFModel()
    children = set()
    for link in root.findall("link"):
        name = link.get("name")
        inertial = link.find("inertial")
        if inertial is not None:
            mass = float(inertial.find("mass").get("value"))
            io = inertial.find("origin")
            com = _vec(io.get("xyz") if io is not None else None)
            rpy = _vec(io.get("rpy") if io is not None else None)
            it = inertial.find("inertia")
            inertia = np.asarray([float(it.get("ixx")), float(it.get("iyy")),
                                  float(it.get("izz"))])
        else:
            mass, com, rpy, inertia = 0.0, np.zeros(3), np.zeros(3), np.ones(3)
        geom = []
        for coll in link.findall("collision"):
            g = coll.find("geometry")
            if g is not None:
                sph = g.find("sphere")
                box = g.find("box")
                og = coll.find("origin")
                off = _vec(og.get("xyz") if og is not None else None)
                if sph is not None:
                    geom.append(("sphere", float(sph.get("radius")), off))
                elif box is not None:
                    geom.append(("box", _vec(box.get("size")), off))
        m.links[name] = dict(mass=mass, com=com, com_rpy=rpy, inertia=inertia,
                             geom=geom)
    for joint in root.findall("joint"):
        origin = joint.find("origin")
        axis_el = joint.find("axis")
        m.joints.append(dict(
            name=joint.get("name"), type=joint.get("type"),
            parent=joint.find("parent").get("link"),
            child=joint.find("child").get("link"),
            xyz=_vec(origin.get("xyz") if origin is not None else None),
            rpy=_vec(origin.get("rpy") if origin is not None else None),
            axis=_vec(axis_el.get("xyz") if axis_el is not None
                      else "1 0 0")))
        children.add(m.joints[-1]["child"])
    roots = [n for n in m.links if n not in children]
    m.root = roots[0] if roots else None
    return m


_JOINT_MAP = {
    "revolute": "revolute",
    "continuous": "revolute",
    "prismatic": "prismatic",
    "fixed": "weld",
    "floating": None,
    "planar": "planar",
}


def build_from_urdf(source: str, fixed_base: bool = True,
                    base_pos=(0, 0, 0), dtype=torch.float32, device=None):
    """URDF → (Model, BodyState, name → index map), on the card unless
    ``device`` names another.

    Link frames are placed by forward kinematics of the joint origins at
    the zero configuration; body origins sit at the link COMs (bodies are
    COM-centric), with the joint anchors offset accordingly.
    """
    from chrono_tpu_torch.physics.builder import SystemBuilder

    urdf = parse_urdf(source)
    b = SystemBuilder(dtype=dtype, device=device)
    names = {}

    # forward kinematics at the zero configuration: link frames in world
    link_pose = {urdf.root: (np.asarray(base_pos, float),
                             np.array([1.0, 0, 0, 0]))}
    pending = list(urdf.joints)
    while pending:
        progressed = False
        for j in list(pending):
            if j["parent"] in link_pose:
                pp, pq = link_pose[j["parent"]]
                rq = _rpy_to_quat(j["rpy"])
                cq = Q.qmul(_f32(pq), _f32(rq)).numpy()
                cp = pp + Q.qrotate(_f32(pq), _f32(j["xyz"])).numpy()
                link_pose[j["child"]] = (cp, cq)
                pending.remove(j)
                progressed = True
        if not progressed:
            raise ValueError(f"disconnected URDF joints: "
                             f"{[j['name'] for j in pending]}")

    # bodies at link COMs
    for name, link in urdf.links.items():
        lp, lq = link_pose[name]
        com_w = lp + Q.qrotate(_f32(lq), _f32(link["com"])).numpy()
        fixed = (name == urdf.root and fixed_base) or link["mass"] <= 0
        names[name] = b.add_body(
            mass=max(link["mass"], 1e-6),
            inertia=np.maximum(link["inertia"], 1e-9),
            pos=com_w, rot=lq, fixed=fixed, name=name)

    # joints at their URDF origins
    for j in urdf.joints:
        kind = _JOINT_MAP.get(j["type"])
        if kind is None:
            continue
        cp, cq = link_pose[j["child"]]
        axis_w = Q.qrotate(_f32(cq), _f32(j["axis"])).numpy()
        b.add_joint(kind, names[j["parent"]], names[j["child"]],
                    world_pos=cp, world_axis=axis_w)

    model, state = b.finalize()
    return model, state, names
