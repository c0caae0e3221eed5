"""Drivers: closed-loop path follower and speed controller, data replay and
a preview-point human driver.

Counterpart of ``chrono_tpu/vehicle/driver.py``: pure functions with
explicit controller state, so that a closed-loop vehicle step reads and
writes nothing on the host and a CUDA graph can capture it.  Indexing by a
device scalar (the closest path point) goes through ``utils.segment.take``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.core.functions import interp
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.segment import take
from chrono_tpu_torch.utils.tree import tensor_dataclass


class DriverInputs(NamedTuple):
    steering: Tensor   # [-1, 1]
    throttle: Tensor   # [0, 1]
    braking: Tensor    # [0, 1]


@tensor_dataclass
class PIDState:
    integral: Tensor = 0.0
    prev_err: Tensor = 0.0


def _max(a, b):
    return torch.clamp_min(a, b) if isinstance(a, Tensor) else max(a, b)


def pid_step(state: PIDState, err, kp, ki, kd, h, out_lim=1.0):
    integral = state.integral + err * h
    deriv = (err - state.prev_err) / h
    out = kp * err + ki * integral + kd * deriv
    # anti-windup: freeze the integral when saturated
    saturated = torch.abs(out) > out_lim
    integral = torch.where(saturated, state.integral, integral)
    out = torch.clamp(out, -out_lim, out_lim)
    return out, PIDState(integral=integral, prev_err=err)


@tensor_dataclass
class SpeedController:
    kp: Tensor = 0.4
    ki: Tensor = 0.1
    kd: Tensor = 0.0
    state: PIDState = PIDState()

    def __call__(self, target_speed, speed, h):
        out, new_state = pid_step(self.state, target_speed - speed,
                                  self.kp, self.ki, self.kd, h)
        throttle = torch.clamp(out, 0.0, 1.0)
        braking = torch.clamp(-out, 0.0, 1.0)
        return throttle, braking, self.replace(state=new_state)


@tensor_dataclass
class PathFollower:
    """Pure-pursuit-style lateral controller on a polyline path: the
    look-ahead point on the path, steering from the lateral error in the
    vehicle frame."""

    path_xy: Tensor          # (P, 2) waypoints
    look_ahead: Tensor = 5.0
    kp: Tensor = 0.3
    ki: Tensor = 0.0
    kd: Tensor = 0.1
    state: PIDState = PIDState()

    def __call__(self, pos_xy, heading, h):
        # closest path point (dense argmin: paths are a few hundred points)
        d2 = torch.sum((self.path_xy - pos_xy[None, :]) ** 2, dim=-1)
        i0 = torch.argmin(d2)
        # walk forward by look_ahead on the cumulative segment lengths
        seg = torch.linalg.norm(torch.diff(self.path_xy, dim=0), dim=-1)
        s = torch.cat([seg.new_zeros(1), torch.cumsum(seg, dim=0)])
        s_target = take(s, i0) + self.look_ahead
        # jnp.searchsorted's default side "left" is right=False
        j = torch.clamp(torch.searchsorted(s, s_target.reshape(1)),
                        1, s.shape[0] - 1)[0]
        s0, s1 = take(s, j - 1), take(s, j)
        f = torch.clamp((s_target - s0) / torch.clamp_min(s1 - s0, 1e-9),
                        0.0, 1.0)
        p0, p1 = take(self.path_xy, j - 1), take(self.path_xy, j)
        target = p0 + f * (p1 - p0)
        # lateral error in the heading frame
        dxy = target - pos_xy
        c, sn = torch.cos(heading), torch.sin(heading)
        err_lat = -sn * dxy[0] + c * dxy[1]
        steer, new_state = pid_step(self.state, err_lat, self.kp, self.ki,
                                    self.kd, h)
        return steer, self.replace(state=new_state)


@tensor_dataclass
class DataDriver:
    """Replay recorded driver inputs, linearly interpolated in time and held
    at the end values outside the record."""

    ts: Tensor         # (K,)
    steering: Tensor   # (K,)
    throttle: Tensor   # (K,)
    braking: Tensor    # (K,)

    def __call__(self, t) -> DriverInputs:
        return DriverInputs(
            steering=interp(t, self.ts, self.steering),
            throttle=interp(t, self.ts, self.throttle),
            braking=interp(t, self.ts, self.braking),
        )


def straight_path(x0=0.0, y0=0.0, length=500.0, n=50, dtype=torch.float32,
                  device=None):
    device = resolve_device(device, "straight_path")
    xs = torch.linspace(x0, x0 + length, n, dtype=dtype, device=device)
    return torch.stack([xs, torch.full_like(xs, y0)], dim=-1)


def double_lane_change_path(dtype=torch.float32, device=None):
    """ISO 3888-1 style double-lane-change centreline (the reference's DLC
    manoeuvre, btest_VEH_hmmwvDLC), made in numpy as the JAX package makes
    it."""
    device = resolve_device(device, "double_lane_change_path")
    x = np.array([0, 15, 45, 70, 95, 125, 140, 200.0])
    y = np.array([0, 0, 3.5, 3.5, 0, 0, 0, 0.0])
    xs = np.linspace(0, 200, 200)
    ys = np.interp(xs, x, y)
    # smooth the corners a little
    k = np.ones(7) / 7
    ys = np.convolve(np.pad(ys, 3, mode="edge"), k, mode="valid")
    return torch.as_tensor(np.stack([xs, ys], axis=-1), dtype=dtype,
                           device=device)


@tensor_dataclass
class HumanDriver:
    """Preview-point human driver model (reference ChHumanDriver): a
    sentinel point ``u·Tp`` ahead of the chassis is compared with the path;
    steering integrates the lateral error (driver lag), speed follows a
    curvature-limited safe speed with asymmetric throttle/brake gains."""

    path: Tensor                 # (N, 2) waypoints
    Tp: Tensor = 0.5             # preview time [s]
    Klat: Tensor = 0.1
    Kug: Tensor = 0.0            # understeer gradient [deg/g]
    Klong: Tensor = 0.1
    Kplus: Tensor = 0.1
    Kminus: Tensor = 0.1
    u0: Tensor = 10.0            # low-speed reference [m/s]
    umax: Tensor = 30.0          # top speed [m/s]
    ay_max: Tensor = 4.0         # comfort lateral acceleration [m/s²]
    delta_max: Tensor = 0.5      # steering saturation [rad]

    def __call__(self, delta, pos_xy, heading, speed, h):
        """(delta', DriverInputs): carries ``delta`` (integrated
        steering)."""
        fwd = torch.stack([torch.cos(heading), torch.sin(heading)])
        dist = torch.clamp_min(speed, 0.3 * self.u0) * self.Tp
        sentinel = pos_xy + dist * fwd
        d2 = torch.sum((self.path - sentinel[None, :]) ** 2, dim=1)
        i = torch.argmin(d2)
        target = take(self.path, i)
        err_vec = target - sentinel
        err = -err_vec[0] * fwd[1] + err_vec[1] * fwd[0]   # signed lateral
        gain = self.Klat * (1.0 + self.Kug * speed * speed
                            / (self.ay_max * 81.0 + 1e-9))
        delta = torch.clamp(delta + gain * err, -self.delta_max,
                            self.delta_max)

        # curvature-limited safe speed from three path points around target
        n = self.path.shape[0]
        a = take(self.path, torch.clamp(i - 2, 0, n - 1))
        c = take(self.path, torch.clamp(i + 2, 0, n - 1))
        b = target
        ab, bc, ca = b - a, c - b, a - c
        cross = ab[0] * bc[1] - ab[1] * bc[0]
        denom = (torch.linalg.norm(ab) * torch.linalg.norm(bc)
                 * torch.linalg.norm(ca) + 1e-9)
        kappa = torch.abs(2.0 * cross / denom)
        u_safe = torch.clamp(
            torch.sqrt(self.ay_max / torch.clamp_min(kappa, 1e-6)),
            max=self.umax)
        tau = self.Klong * (u_safe - speed)
        throttle = torch.clamp(tau / _max(self.Kplus, 1e-6), 0.0, 1.0)
        braking = torch.clamp(-tau / _max(self.Kminus, 1e-6), 0.0, 1.0)
        inputs = DriverInputs(steering=delta / self.delta_max,
                              throttle=throttle, braking=braking)
        return delta, inputs


def acc_speed_command(set_speed, gap, gap_rate, *, time_gap=1.5,
                      standstill=5.0, k_gap=0.4, k_rate=0.8):
    """Adaptive-cruise speed command (reference ChPathFollowerACCDriver
    role): track ``set_speed`` but keep at least ``standstill + v·time_gap``
    to the lead vehicle; returns the commanded speed for a
    SpeedController."""
    v_follow = (gap - standstill) / _max(time_gap, 1e-3) \
        + k_rate * gap_rate / _max(k_gap + time_gap, 1e-3)
    return torch.clamp_min(torch.clamp(v_follow, max=set_speed), 0.0)
