"""A vehicle driven along a path by a speed controller and a path follower.

Counterpart of the closed loop of ``demos/demo_vehicle_dlc.py`` (the
reference's btest_VEH_hmmwvDLC), which the JAX package compiles as one
``lax.scan``: each step reads the chassis speed and heading, runs both
controllers, ``vehicle_step``, and records the chassis position at the
step's start.  ``run_closed_loop`` captures one such step into a CUDA graph
on the card and replays it; the body state, both controllers' PID state,
``t`` and the record are static tensors that the step updates in place.
On the CPU the same step runs as a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics.system import SolverSettings
from chrono_tpu_torch.utils.graph import capture
from chrono_tpu_torch.vehicle.driver import DriverInputs, PIDState
from chrono_tpu_torch.vehicle.wheeled import WheeledVehicle, vehicle_step

DIRECT = SolverSettings(solver="direct")


class ClosedLoopOut(NamedTuple):
    state: BodyState
    speed_ctrl: object
    steer_ctrl: object
    chassis_x: Tensor     # (n, 3) chassis position at the start of each step


def heading(q: Tensor) -> Tensor:
    """Yaw of a body: the angle of its local +x in the world xy plane."""
    fwd = Q.qrotate(q, torch.eye(3, dtype=q.dtype, device=q.device)[0])
    return torch.atan2(fwd[1], fwd[0])


def closed_loop_step(vehicle: WheeledVehicle, state, speed_ctrl, steer_ctrl,
                     terrain_height_fn, target_speed, t, h,
                     settings: SolverSettings = DIRECT):
    """One step of the loop → ``(state, speed_ctrl, steer_ctrl)``."""
    ch = vehicle.chassis
    speed = torch.linalg.norm(state.v[ch, :2])
    throttle, braking, speed_ctrl = speed_ctrl(target_speed, speed, h)
    steer, steer_ctrl = steer_ctrl(state.x[ch, :2], heading(state.q[ch]), h)
    out = vehicle_step(vehicle, state, DriverInputs(steer, throttle, braking),
                       terrain_height_fn, t, h, settings)
    return out.state, speed_ctrl, steer_ctrl


_FIELDS = ("x", "q", "v", "w")


def run_closed_loop(vehicle: WheeledVehicle, state, speed_ctrl, steer_ctrl,
                    terrain_height_fn, target_speed, h, n,
                    settings: SolverSettings = DIRECT, t0=0.0
                    ) -> ClosedLoopOut:
    """``n`` steps of ``closed_loop_step`` from ``t0``: one captured CUDA
    graph replayed ``n`` times on the card with the direct solver (whose
    step reads nothing on the host), a Python loop otherwise."""
    dev, dt = state.x.device, state.x.dtype
    t = torch.full((), t0, dtype=dt, device=dev)
    ch = vehicle.chassis
    if not (state.x.is_cuda and settings.solver == "direct"):
        xs = []
        for _ in range(n):
            xs.append(state.x[ch])
            state, speed_ctrl, steer_ctrl = closed_loop_step(
                vehicle, state, speed_ctrl, steer_ctrl, terrain_height_fn,
                target_speed, t, h, settings)
            t = t + h
        return ClosedLoopOut(state, speed_ctrl, steer_ctrl,
                             torch.stack(xs) if xs else state.x.new_zeros(
                                 (0, 3)))

    def pid_buffers(ctrl):
        return PIDState(*(torch.as_tensor(v, dtype=dt, device=dev).clone()
                          for v in (ctrl.state.integral,
                                    ctrl.state.prev_err)))

    cur = BodyState(**{f: getattr(state, f).clone() for f in _FIELDS})
    sc = speed_ctrl.replace(state=pid_buffers(speed_ctrl))
    pc = steer_ctrl.replace(state=pid_buffers(steer_ctrl))
    xs = cur.x.new_zeros((max(n, 1), 3))    # a row to capture into at n = 0
    k = torch.zeros((1,), dtype=torch.long, device=dev)

    def compute():
        return closed_loop_step(vehicle, cur, sc, pc, terrain_height_fn,
                                target_speed, t, h, settings)

    def one_step():
        xs.index_copy_(0, k, cur.x[ch][None])
        new, new_sc, new_pc = compute()
        for f in _FIELDS:
            getattr(cur, f).copy_(getattr(new, f))
        for buf, new_c in ((sc.state, new_sc.state), (pc.state, new_pc.state)):
            buf.integral.copy_(new_c.integral)
            buf.prev_err.copy_(new_c.prev_err)
        t.add_(h)
        k.add_(1)

    graph = capture(one_step, compute, dev)
    for _ in range(n):
        graph.replay()
    return ClosedLoopOut(
        BodyState(**{f: getattr(cur, f).clone() for f in _FIELDS}),
        speed_ctrl.replace(state=PIDState(sc.state.integral.clone(),
                                          sc.state.prev_err.clone())),
        steer_ctrl.replace(state=PIDState(pc.state.integral.clone(),
                                          pc.state.prev_err.clone())),
        xs[:n].clone())
