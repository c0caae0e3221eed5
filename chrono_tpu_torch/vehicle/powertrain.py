"""Engine, transmission and driveline as pure per-step functions.

Counterpart of ``chrono_tpu/vehicle/powertrain.py`` (the reference's
map-based powertrain, ChEngineSimpleMap / ChAutomaticTransmissionSimpleMap,
and an open differential): an engine torque map sampled at the engine
speed, a gear chosen by speed thresholds (``torch.searchsorted``, which
keeps the gear a device tensor, so no host read), and an open differential
that splits the torque among the driven wheels.
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.core.functions import interp
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.segment import take
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class PowertrainParams:
    """Engine map + gearbox + driveline parameters."""

    # engine full-throttle torque map (N m) against speed (rad/s), and the
    # closed-throttle losses map
    map_speed: Tensor         # (K,)
    map_torque: Tensor        # (K,) full throttle
    map_losses: Tensor        # (K,) closed throttle (negative = braking)
    max_speed: Tensor         # rev limiter [rad/s]
    gear_ratios: Tensor       # (G,) transmission ratios (engine/driveshaft)
    shift_speeds: Tensor      # (G-1,) upshift vehicle speeds [m/s]
    final_drive: Tensor       # differential ratio
    driven_wheels: Tensor     # (W,) 1.0 if driven, else 0.0
    efficiency: Tensor = 0.9


def engine_torque(p: PowertrainParams, engine_speed, throttle):
    """Torque from a SIGNED engine speed: the drive part always pushes the
    engine forward; the losses part OPPOSES the current rotation (so a
    backward-spinning driveline is braked, not accelerated)."""
    w_abs = torch.abs(engine_speed)
    wt = interp(w_abs, p.map_speed, p.map_torque)
    wl = interp(w_abs, p.map_speed, p.map_losses)     # negative values
    # soft limiter: fade the drive torque to zero in the last 5 % of range
    fade = torch.clamp((p.max_speed - w_abs) / (0.05 * p.max_speed),
                       0.0, 1.0)
    drive = throttle * (wt - wl) * fade
    losses = wl * torch.tanh(engine_speed / 10.0)     # sign-aware braking
    return drive + losses


def select_gear(p: PowertrainParams, vehicle_speed):
    """Speed-threshold automatic gearbox: the number of shift speeds below
    |v| (``jnp.searchsorted``'s side "left": a speed exactly at a shift
    speed stays in the lower gear)."""
    v = torch.abs(vehicle_speed).reshape(1).to(p.shift_speeds.dtype)
    return torch.searchsorted(p.shift_speeds, v, right=False)[0]


def driveline_torques(p: PowertrainParams, wheel_omegas, vehicle_speed,
                      throttle):
    """Throttle + wheel speeds → per-wheel drive torque (open differential).

    The engine speed is tied to the mean driven-wheel speed through the
    total ratio.  Returns ``(wheel_torques (W,), engine_speed, gear)``.
    """
    gear = select_gear(p, vehicle_speed)
    ratio = take(p.gear_ratios, gear) * p.final_drive
    n_driven = torch.clamp_min(torch.sum(p.driven_wheels), 1.0)
    mean_w = torch.sum(wheel_omegas * p.driven_wheels) / n_driven
    engine_speed = mean_w * ratio                     # signed
    te = engine_torque(p, engine_speed, throttle)
    t_axle = te * ratio * p.efficiency
    per_wheel = t_axle / n_driven * p.driven_wheels
    return per_wheel, engine_speed, gear


def brake_torques(brake_input, max_torque, wheel_omegas, front_bias=0.6,
                  n_front=2):
    """Viscous-regularised brake torque opposing wheel spin
    (reference ChBrakeSimple)."""
    w = wheel_omegas
    n = w.shape[0]
    bias = torch.cat([
        w.new_full((n_front,), front_bias / n_front),
        w.new_full((n - n_front,), (1.0 - front_bias) / (n - n_front)),
    ])
    return -brake_input * max_torque * bias * n * torch.tanh(2.0 * w)


def default_engine_map(max_torque=400.0, max_power_speed=450.0,
                       max_speed=650.0, dtype=torch.float32, device=None):
    """A generic truck-like torque curve: (speeds, torques, losses), on the
    card unless ``device`` names another."""
    device = resolve_device(device, "default_engine_map")
    speeds = torch.tensor([0.0, 100.0, 200.0, 300.0, max_power_speed,
                           max_speed * 0.95, max_speed], dtype=dtype,
                          device=device)
    torques = torch.tensor([0.6, 0.85, 1.0, 1.0, 0.95, 0.7, 0.0],
                           dtype=dtype, device=device) * max_torque
    losses = torch.tensor([-20.0, -25.0, -30.0, -35.0, -40.0, -50.0, -60.0],
                          dtype=dtype, device=device)
    return speeds, torques, losses
