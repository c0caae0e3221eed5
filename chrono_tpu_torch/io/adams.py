"""ADAMS (.adm) model parser.

Counterpart of ``chrono_tpu/io/adams.py`` (the reference's ChParserAdams):
reads the ADAMS/View solver-deck subset of the reference's joint validation
models — PART, MARKER (QP / REULER body-313 Euler), JOINT, SPRINGDAMPER,
ACCGRAV — and assembles a ``SystemBuilder`` model.  Marker frames relative
to their part's CM are computed in float32, as the JAX package computes
them.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
import torch

from chrono_tpu_torch.core import quaternion as Q


# ---------------------------------------------------------------------------
# tokenizing: statements start on a non-',' line; ',' lines continue them
# ---------------------------------------------------------------------------

def _statements(text: str):
    stmts = []
    for raw in text.splitlines():
        line = raw.split("!", 1)[0].rstrip()
        if not line.strip():
            continue
        if line.lstrip().startswith(","):
            if stmts:
                stmts[-1] += " " + line.strip()
        else:
            stmts.append(line.strip())
    return stmts


def _parse_angle(tok: str) -> float:
    tok = tok.strip()
    if tok.upper().endswith("D"):
        return float(tok[:-1]) * np.pi / 180.0
    return float(tok)


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _euler313_to_quat(psi, theta, phi):
    """Body-fixed 3-1-3 Euler angles → scalar-first quaternion."""
    def qz(a):
        return np.array([np.cos(a / 2), 0, 0, np.sin(a / 2)])

    def qx(a):
        return np.array([np.cos(a / 2), np.sin(a / 2), 0, 0])

    return _qmul(_qmul(qz(psi), qx(theta)), qz(phi))


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32))


@dataclass
class AdmMarker:
    part: int
    qp: np.ndarray
    quat: np.ndarray


@dataclass
class AdmPart:
    idx: int
    ground: bool = False
    mass: float = 0.0
    cm: int = None
    ip: tuple = (1.0, 1.0, 1.0)


@dataclass
class AdmModel:
    parts: dict = field(default_factory=dict)
    markers: dict = field(default_factory=dict)
    joints: list = field(default_factory=list)       # (type, I, J)
    springs: list = field(default_factory=list)      # dicts
    gravity: np.ndarray = None


_JOINT_MAP = {
    "REVOLUTE": "revolute",
    "SPHERICAL": "spherical",
    "TRANSLATIONAL": "prismatic",
    "CYLINDRICAL": "cylindrical",
    "UNIVERSAL": "universal",
    "HOOKE": "universal",
    "FIXED": "weld",
    "PLANAR": "planar",
}


def parse_adm(path: str) -> AdmModel:
    model = AdmModel()
    with open(path) as f:
        text = f.read()
    for stmt in _statements(text):
        head, _, rest = stmt.partition(",")
        head = head.strip().upper()
        m = re.match(r"([A-Z]+)/(\w+)?", head)
        if not m:
            continue
        kind, ident = m.group(1), m.group(2)

        # split "K = V" fields on commas at top level; values may span
        # multiple comma-separated numbers (QP = 0, -.4, 0)
        fields = {}
        key = None
        for tok in rest.split(","):
            if "=" in tok:
                key, _, val = tok.partition("=")
                key = key.strip().upper()
                fields[key] = [val.strip()]
            elif key is not None and tok.strip():
                fields[key].append(tok.strip())
            elif tok.strip():
                fields.setdefault("_FLAGS", []).append(tok.strip().upper())

        if kind == "PART":
            idx = int(ident)
            p = AdmPart(idx=idx)
            p.ground = "GROUND" in fields.get("_FLAGS", [])
            if "MASS" in fields:
                p.mass = float(fields["MASS"][0])
            if "CM" in fields:
                p.cm = int(fields["CM"][0])
            if "IP" in fields:
                p.ip = tuple(float(v) for v in fields["IP"][:3])
            model.parts[idx] = p
        elif kind == "MARKER":
            mid = int(ident)
            part = int(fields["PART"][0]) if "PART" in fields else None
            qp = np.array([float(v) for v in fields.get("QP", ["0", "0", "0"])[:3]])
            if "REULER" in fields:
                ang = [_parse_angle(v) for v in fields["REULER"][:3]]
                quat = _euler313_to_quat(*ang)
            else:
                quat = np.array([1.0, 0, 0, 0])
            model.markers[mid] = AdmMarker(part=part, qp=qp, quat=quat)
        elif kind == "JOINT":
            jtype = fields.get("_FLAGS", ["?"])[0]
            model.joints.append((jtype, int(fields["I"][0]),
                                 int(fields["J"][0])))
        elif kind == "SPRINGDAMPER":
            sd = dict(kind=fields.get("_FLAGS", ["TRANSLATIONAL"])[0],
                      i=int(fields["I"][0]), j=int(fields["J"][0]))
            for k_src, k_dst in (("K", "k"), ("C", "c"), ("LENGTH", "l0"),
                                 ("KT", "kt"), ("CT", "ct"),
                                 ("ANGLE", "a0"), ("FORCE", "f"),
                                 ("TORQUE", "t")):
                if k_src in fields:
                    sd[k_dst] = _parse_angle(fields[k_src][0])
            model.springs.append(sd)
        elif kind == "ACCGRAV":
            g = np.zeros(3)
            for axk, i in (("IGRAV", 0), ("JGRAV", 1), ("KGRAV", 2)):
                if axk in fields:
                    g[i] = float(fields[axk][0])
            model.gravity = g
    return model


def build_system(model: AdmModel, dtype=torch.float32, device=None):
    """AdmModel → (Model, BodyState) on the card unless ``device`` names
    another."""
    from chrono_tpu_torch.physics.builder import SystemBuilder

    bld = SystemBuilder(dtype=dtype, device=device)
    if model.gravity is not None:
        bld.set_gravity(model.gravity)

    body_of_part = {}
    cm_pose = {}
    for idx, p in sorted(model.parts.items()):
        if p.ground:
            body_of_part[idx] = bld.add_ground()
            cm_pose[idx] = (np.zeros(3), np.array([1.0, 0, 0, 0]))
        else:
            cm = model.markers[p.cm]
            body_of_part[idx] = bld.add_body(
                mass=p.mass, inertia=p.ip, pos=cm.qp, rot=cm.quat)
            cm_pose[idx] = (cm.qp, cm.quat)

    def local_frame(marker: AdmMarker):
        """Marker pose relative to its part's CM frame."""
        cm_p, cm_q = cm_pose[marker.part]
        qinv = _f32(cm_q * np.array([1.0, -1, -1, -1]))
        dp = Q.qrotate(qinv, _f32(marker.qp - cm_p)).numpy()
        dq = Q.qmul(qinv, _f32(marker.quat)).numpy()
        return dp, dq

    for jtype, i_id, j_id in model.joints:
        kind = _JOINT_MAP.get(jtype)
        if kind is None:
            raise ValueError(f"unsupported ADAMS joint type {jtype!r}")
        mi, mj = model.markers[i_id], model.markers[j_id]
        pa, qa = local_frame(mi)
        pb, qb = local_frame(mj)
        bld.add_joint_frames(kind, body_of_part[mi.part],
                             body_of_part[mj.part],
                             fa_pos=pa, fa_rot=qa, fb_pos=pb, fb_rot=qb)

    for sd in model.springs:
        mi, mj = model.markers[sd["i"]], model.markers[sd["j"]]
        bi, bj = body_of_part[mi.part], body_of_part[mj.part]
        if sd["kind"].startswith("TRANS"):
            bld.add_tsda(bi, bj, mi.qp, mj.qp, k=sd.get("k", 0.0),
                         c=sd.get("c", 0.0), rest_length=sd.get("l0"),
                         f_actuation=sd.get("f", 0.0))
        else:
            # rotational spring about the marker z axis
            axis = Q.qrotate(_f32(mi.quat), _f32([0.0, 0.0, 1.0])).numpy()
            bld.add_rsda(bi, bj, world_axis=axis, k=sd.get("kt", 0.0),
                         c=sd.get("ct", 0.0), rest_angle=sd.get("a0", 0.0),
                         t_actuation=sd.get("t", 0.0))
    return bld.finalize()


def load_adm(path: str, dtype=torch.float32, device=None):
    """Parse + build in one call → (Model, BodyState)."""
    return build_system(parse_adm(path), dtype=dtype, device=device)
