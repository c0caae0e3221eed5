"""Sedan-class passenger-car model (parameter set).

Counterpart of ``chrono_tpu/models/sedan.py``: a ~1.5 t front-engine RWD
passenger car on the port's vehicle templates.
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.models.common import powertrain_deck, tensors
from chrono_tpu_torch.vehicle.tire import TMeasyParams
from chrono_tpu_torch.vehicle.wheeled import build_wheeled_vehicle


def create_sedan(driven="RWD", suspension="reduced", dtype=torch.float32,
                 device=None):
    """Returns ``(WheeledVehicle, BodyState)`` for a mid-size sedan, on the
    card unless ``device`` names another."""
    wheel_radius = 0.33
    mass = 1500.0
    tire = TMeasyParams(**tensors(dtype, device,
        radius=wheel_radius, width=0.225, Fz0=mass * 9.81 / 4, cz=260000.0,
        dz=1800.0,
        dfx0_1=90000.0, fxm_1=4300.0, fxs_1=3800.0, sxm_1=0.10, sxs_1=0.8,
        dfx0_2=180000.0, fxm_2=8400.0, fxs_2=7300.0, sxm_2=0.12,
        sxs_2=0.85,
        dfy0_1=70000.0, fym_1=4100.0, fys_1=3700.0, sym_1=0.24, sys_1=1.0,
        dfy0_2=135000.0, fym_2=8000.0, fys_2=7200.0, sym_2=0.28, sys_2=1.0,
        rolling_resistance=0.012))
    powertrain = powertrain_deck(
        240.0, 520.0, 680.0,       # 2.0 l turbo petrol, ~5000 rpm peak
        gears=[4.71, 3.14, 2.11, 1.67, 1.29, 1.0],
        shifts=[5.0, 10.0, 15.0, 21.0, 28.0], final=3.27, driven=driven,
        efficiency=0.9, dtype=dtype, device=device)
    return build_wheeled_vehicle(
        chassis_mass=mass,
        chassis_inertia=(487.0, 1447.0, 1650.0),
        wheelbase=2.78,
        track=1.58,
        cg_height=0.52,
        wheel_mass=22.0,
        wheel_radius=wheel_radius,
        wheel_width=0.225,
        wheel_inertia_spin=1.2,
        suspension_k=55000.0,
        suspension_c=4500.0,
        tire=tire,
        powertrain=powertrain,
        max_steer_angle=0.60,
        max_brake_torque=2200.0,
        driven=driven,
        suspension=suspension,
        dtype=dtype,
        device=device,
    )
