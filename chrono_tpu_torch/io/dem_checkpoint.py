"""Loader for the ASCII checkpoint format of the reference DEM code.

Counterpart of ``chrono_tpu/io/dem_checkpoint.py``
(``parse_dem_checkpoint``, ``dem_system_from_checkpoint``): the header's
``key: value`` parameters and the ``CsvParticles`` block are parsed, and a
``dem.system.DEMSystem`` is built with matching physics:

* the raw user stiffness and damping (K_n, G_n, K_t, G_t) map onto
  ``force_model="user"``;
* the friction and rolling modes and the integrator map by enum order;
* positions, velocities, angular velocities and fixity come from the
  particle block.

The friction-history block (``HstHistory``) is skipped, as in the JAX
package: its partner indices name the earlier run's contact slots, and the
first neighbour rebuild starts the springs anew.
"""

from __future__ import annotations

import numpy as np
import torch

_FRICTION = {0: "frictionless", 1: "single_step", 2: "multi_step"}
_ROLLING = {0: "none", 1: "schwartz", 2: "elastic_plastic"}
_INTEGRATOR = {0: "forward_euler", 1: "chung", 2: "centered_difference",
               3: "extended_taylor"}


def parse_dem_checkpoint(path: str) -> dict:
    """The checkpoint as ``{"params": {key: str}, "particles": {column:
    float64 array}}``."""
    params: dict = {}
    rows = []
    header = None
    section = "head"
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line == "CsvParticles":
                section = "csv"
                continue
            if line == "HstHistory":
                section = "hst"
                continue
            if section == "head":
                if line in ("ChSystemGpu", "ChSystemDem", "ParamsEnd"):
                    continue
                if ":" in line:
                    k, v = line.split(":", 1)
                    params[k.strip()] = v.strip()
            elif section == "csv":
                if header is None:
                    header = [c.strip() for c in line.split(",")]
                    continue
                rows.append([float(c) for c in line.split(",")])
    data = np.asarray(rows, np.float64)
    cols = {name: data[:, i] for i, name in enumerate(header)}
    return dict(params=params, particles=cols)


def dem_system_from_checkpoint(path: str, box=None, *, device=None,
                               **system_kw):
    """A ``DEMSystem`` with its particles from a checkpoint, on ``device``
    (the card unless told otherwise).  Returns ``(sys, fixed)``: ``fixed``
    is the (N,) bool fixity the checkpoint records (the system moves every
    particle; a caller emulates fixity itself)."""
    from chrono_tpu_torch.dem.system import DEMSystem

    ck = parse_dem_checkpoint(path)
    p = ck["params"]
    g = [float(x) for x in p["G"].split()]
    if box is None:
        bs = [float(x) for x in p["boxSize"].split()]
        box = (tuple(-0.5 * b for b in bs), tuple(0.5 * b for b in bs))
    sys = DEMSystem(
        radius=float(p["radius"]), density=float(p["density"]), box=box,
        dt=float(p["fixedStepSize"]), gravity=tuple(g),
        integrator=_INTEGRATOR[int(p.get("timeIntegrator", 2))],
        friction_mode=_FRICTION[int(p.get("frictionMode", 2))],
        rolling_mode=_ROLLING[int(p.get("rollingMode", 0))],
        force_model="user", device=device, **system_kw)
    for setter, tag in ((sys.set_material, "s2s"),
                        (sys.set_wall_material, "s2w")):
        setter(kn=float(p[f"K_n_{tag}"]), gn=float(p[f"G_n_{tag}"]),
               kt=float(p[f"K_t_{tag}"]), gt=float(p[f"G_t_{tag}"]),
               mu_s=float(p.get(f"StaticFrictionCoeff_{tag}", 0.5)),
               mu_r=float(p.get(f"RollingCoeff_{tag}", 0.0)),
               mu_sp=float(p.get(f"SpinningCoeff_{tag}", 0.0)))
    c = ck["particles"]
    pts = np.stack([c["x"], c["y"], c["z"]], axis=1)
    vel = np.stack([c["vx"], c["vy"], c["vz"]], axis=1)
    sys.create_particles(pts, vel=vel)
    if "wx" in c:
        omega = np.stack([c["wx"], c["wy"], c["wz"]], axis=1)
        sys.state = sys.state.replace(omega=torch.as_tensor(
            omega, dtype=sys.dtype, device=sys.device))
    fixed = c.get("fixed", np.zeros(len(pts))).astype(bool)
    return sys, fixed
