"""Drawbar-pull (DBP) rig: a single tire at an imposed slip on SCM soil.

Counterpart of ``chrono_tpu/vehicle/dbp.py`` (the reference's
ChVehicleCosimDBPRig with imposed slip): the carrier translates at an
imposed speed v while the wheel spins at ω, which fixes the slip
s = (ωR − v)/ωR; the terrain's reaction on the carrier is the drawbar pull,
and the vertical degree of freedom stays dynamic so the tire finds its
sinkage under the load.  The JAX package scans the rig's steps in one
program; here they run as a loop of tensor ops on the grid's device, with
every series kept on the device until the end.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.vehicle.terrain import (
    SCMParams, SCMState, scm_wheel_forces,
)


class DBPOut(NamedTuple):
    pull: Tensor       # (T,) drawbar pull [N] (+ = tractive)
    sinkage: Tensor    # (T,) wheel-bottom depth below the virgin surface [m]
    torque: Tensor     # (T,) spin torque reaction [N·m]
    z: Tensor          # () final wheel-centre height
    scm: SCMState


def run_dbp_rig(scm_params: SCMParams, scm_state: SCMState, *,
                wheel_radius: float, wheel_width: float, mass: float,
                load: float, v: float, slip: float, start_xy=(0.5, 0.5),
                h: float = 1e-3, n_steps: int = 800,
                settle_steps: int = 300) -> DBPOut:
    """Settle vertically, then translate at v with the wheel spun at
    ω = v / (R (1 − slip)).

    ``load``: the total vertical force pressing the tire down (the rig's
    weight).  Returns the per-step pull, sinkage and torque of the measured
    phase.
    """
    dev, dt = scm_state.z0.device, scm_state.z0.dtype
    omega = v / (wheel_radius * (1.0 - slip))
    x0, y0 = start_xy
    q_id = Q.qidentity((1,), dt, dev)
    eye = torch.eye(3, dtype=dt, device=dev)

    def scalar(x):
        return torch.full((), x, dtype=dt, device=dev)

    def step(z, vz, x, scm, moving):
        pos = torch.stack([x, scalar(y0), z])
        vel = eye[0] * v * moving
        w_loc = eye[1] * omega * moving
        out = scm_wheel_forces(
            scm_params, scm, pos[None], q_id, vel[None], w_loc[None],
            wheel_radius=wheel_radius, wheel_width=wheel_width)
        fz = out.force[0, 2]
        vz2 = vz + h * (fz - load) / mass
        z2 = z + h * vz2
        x2 = x + h * v * moving
        return z2, vz2, x2, out.new_state, out

    # the wheel bottom starts on the highest point of the soil
    z_init = wheel_radius + float(torch.max(scm_state.height))
    z, vz, x, scm = scalar(z_init), scalar(0.0), scalar(x0), scm_state
    # phase 1: vertical settling (no translation, no spin)
    for _ in range(settle_steps):
        z, vz, x, scm, _ = step(z, vz, x, scm, 0.0)
    # phase 2: traction at the imposed slip
    fx, zs, tq = [], [], []
    for _ in range(n_steps):
        z, vz, x, scm, out = step(z, vz, x, scm, 1.0)
        fx.append(out.force[0, 0])
        zs.append(z)
        tq.append(out.torque_spin[0])
    zs = torch.stack(zs)
    # sinkage: the wheel-bottom depth below the VIRGIN surface (z_init puts
    # the bottom exactly on it)
    return DBPOut(pull=torch.stack(fx), sinkage=z_init - zs,
                  torque=torch.stack(tq), z=z, scm=scm)


def dbp_curve(scm_params: SCMParams, scm_maker, slips, **kw):
    """Drawbar pull against slip (fresh terrain per point), the rig's
    standard output: the mean pull over the last quarter of each run."""
    pulls = []
    for s in slips:
        out = run_dbp_rig(scm_params, scm_maker(), slip=float(s), **kw)
        n_avg = max(1, out.pull.shape[0] // 4)
        pulls.append(float(torch.mean(out.pull[-n_avg:])))
    return pulls
