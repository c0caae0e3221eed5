"""Visual asset layer: shapes, materials, per-body visual models.

Counterpart of ``chrono_tpu/assets.py`` (the reference's ``assets/``
component: ChVisualModel, ChVisualShape*, ChVisualMaterial, ChColor).  There
is no run-time renderer, so this layer is what the reference's is to its
export backends: a data model — typed shape descriptors attached to body
indices, posed by the simulation state, and consumed by the exporters of
``io.export`` or an external renderer (via OBJ / VTK / PLY).

Host Python and numpy (a scene description, not device state); the body
poses may be tensors on any device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from chrono_tpu_torch.io.writers import _host


@dataclass
class VisualMaterial:
    """ChVisualMaterial role: Phong-ish parameters exporters understand."""

    color: tuple = (0.8, 0.8, 0.8)     # RGB diffuse, 0..1
    opacity: float = 1.0
    metallic: float = 0.0
    roughness: float = 0.5
    texture: Optional[str] = None      # file path, passed through to export


@dataclass
class VisualShape:
    """One primitive of a body's visual model, in body-local frame."""

    kind: str                          # sphere | box | cylinder | mesh
    # geometric parameters by kind:
    #   sphere: radius;  box: (hx, hy, hz) half-sizes
    #   cylinder: (radius, height) along local z;  mesh: vertices/faces
    params: tuple = ()
    pos: tuple = (0.0, 0.0, 0.0)       # body-local offset
    rot: tuple = (1.0, 0.0, 0.0, 0.0)  # body-local quaternion (w, x, y, z)
    material: VisualMaterial = field(default_factory=VisualMaterial)
    vertices: Optional[np.ndarray] = None   # (V, 3) for kind == "mesh"
    faces: Optional[np.ndarray] = None      # (F, 3) int


@dataclass
class VisualModel:
    """ChVisualModel role: the list of shapes attached to one body."""

    shapes: list = field(default_factory=list)

    def add_sphere(self, radius, pos=(0, 0, 0), material=None):
        self.shapes.append(VisualShape("sphere", (float(radius),), pos,
                                       material=material or VisualMaterial()))
        return self

    def add_box(self, half_sizes, pos=(0, 0, 0), rot=(1, 0, 0, 0),
                material=None):
        self.shapes.append(VisualShape("box", tuple(map(float, half_sizes)),
                                       pos, rot,
                                       material or VisualMaterial()))
        return self

    def add_cylinder(self, radius, height, pos=(0, 0, 0), rot=(1, 0, 0, 0),
                     material=None):
        self.shapes.append(VisualShape(
            "cylinder", (float(radius), float(height)), pos, rot,
            material or VisualMaterial()))
        return self

    def add_mesh(self, vertices, faces, pos=(0, 0, 0), rot=(1, 0, 0, 0),
                 material=None):
        self.shapes.append(VisualShape(
            "mesh", (), pos, rot, material or VisualMaterial(),
            vertices=np.asarray(vertices, float),
            faces=np.asarray(faces, np.int64)))
        return self


class VisualScene:
    """Body-index → VisualModel registry + frame tessellation.

    ``tessellate(x, q)`` poses every shape with the body states and returns
    one concatenated (vertices, faces, colors) triangle soup — the input the
    io.export writers take.
    """

    def __init__(self):
        self.models = {}           # body index -> VisualModel

    def attach(self, body: int, model: VisualModel):
        self.models[int(body)] = model
        return model

    def model(self, body: int) -> VisualModel:
        return self.models.setdefault(int(body), VisualModel())

    # ---- tessellation ----

    @staticmethod
    def _quat_mat(q):
        w, x, y, z = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    @staticmethod
    def _unit_sphere(nu=12, nv=8):
        us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
        vs = np.linspace(0, np.pi, nv)
        verts = []
        for v in vs:
            for u in us:
                verts.append([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u),
                              np.cos(v)])
        verts = np.asarray(verts)
        faces = []
        for i in range(nv - 1):
            for j in range(nu):
                a = i * nu + j
                b = i * nu + (j + 1) % nu
                faces.append([a, b, a + nu])
                faces.append([b, b + nu, a + nu])
        return verts, np.asarray(faces)

    @staticmethod
    def _unit_box():
        v = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], float)
        f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
        return v, f

    @staticmethod
    def _unit_cylinder(nu=16):
        us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
        ring = np.stack([np.cos(us), np.sin(us)], axis=1)
        verts = np.concatenate([
            np.concatenate([ring, -np.ones((nu, 1))], axis=1),
            np.concatenate([ring, np.ones((nu, 1))], axis=1),
            [[0, 0, -1], [0, 0, 1]]])
        faces = []
        for j in range(nu):
            a, b = j, (j + 1) % nu
            faces.append([a, b, a + nu])
            faces.append([b, b + nu, a + nu])
            faces.append([2 * nu, b, a])          # bottom cap
            faces.append([2 * nu + 1, a + nu, b + nu])
        return verts, np.asarray(faces)

    def tessellate(self, x, q):
        """Pose all shapes: x (N,3), q (N,4) body states (numpy arrays or
        tensors on any device).

        Returns (verts (V,3), faces (F,3), colors (F,3))."""
        x = _host(x)
        q = _host(q)
        all_v, all_f, all_c = [], [], []
        base = 0
        for body, model in sorted(self.models.items()):
            Rb = self._quat_mat(q[body])
            for sh in model.shapes:
                if sh.kind == "sphere":
                    v, f = self._unit_sphere()
                    v = v * sh.params[0]
                elif sh.kind == "box":
                    v, f = self._unit_box()
                    v = v * np.asarray(sh.params)
                elif sh.kind == "cylinder":
                    v, f = self._unit_cylinder()
                    v = v * np.array([sh.params[0], sh.params[0],
                                      0.5 * sh.params[1]])
                elif sh.kind == "mesh":
                    v, f = sh.vertices, sh.faces
                else:
                    raise ValueError(f"unknown shape kind {sh.kind!r}")
                Rs = self._quat_mat(np.asarray(sh.rot, float))
                v_world = (v @ Rs.T + np.asarray(sh.pos)) @ Rb.T + x[body]
                all_v.append(v_world)
                all_f.append(np.asarray(f) + base)
                all_c.append(np.tile(sh.material.color, (len(f), 1)))
                base += len(v)
        if not all_v:
            return (np.zeros((0, 3)), np.zeros((0, 3), np.int64),
                    np.zeros((0, 3)))
        return (np.concatenate(all_v), np.concatenate(all_f),
                np.concatenate(all_c))
