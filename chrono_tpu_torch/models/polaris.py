"""Polaris-class light UTV model (parameter set).

Counterpart of ``chrono_tpu/models/polaris.py``: a ~0.8 t off-road
side-by-side, AWD, with soft long-travel suspension (the reference's
vehicle for deformable-terrain studies).
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.models.common import powertrain_deck, tensors
from chrono_tpu_torch.vehicle.tire import TMeasyParams
from chrono_tpu_torch.vehicle.wheeled import build_wheeled_vehicle

# The JAX package's deck values (derived there from the reference's Polaris
# JSON files: suspension rates are central-segment secants of the spring
# and damping curves, reflected to the wheel through the front
# double-wishbone motion ratio 0.6349206).
POLARIS_SPEC = dict(
    chassis_mass=1105.5,
    chassis_inertia=(275.6945599, 853.4464526, 1200.0),
    chassis_com=(-1.6399537, 0.0, 0.7667115704),
    wheelbase=2.71526,          # rear spindle x offset
    track=1.232,                # 2 x spindle y 0.616
    wheel_mass=33.9,            # rim 18.8 + TMeasy tire 15.1
    wheel_inertia_spin=1.453,   # rim 0.113 + tire 1.34
    wheel_radius=0.330229,
    wheel_width=0.2121,
    suspension_k=21061.94,      # 52246.78 N/m secant x 0.6349206^2
    suspension_c=5620.48,       # 13942.31 N s/m (|v|<0.13) x 0.6349206^2
    engine_torque=397.0445784,  # EngineSimpleMap full-throttle peak
    engine_speed_rpm=2700.0,
    gear_ratios=(3.7453, 2.0, 1.3441, 1.0, 0.7728, 0.6341),
    # CG above ground = chassis COM z - front axle z (0.397) + tire radius
    cg_height=0.700,
)


def create_polaris(driven="AWD", suspension="reduced", dtype=torch.float32,
                   device=None):
    """Returns ``(WheeledVehicle, BodyState)`` for a Polaris-class UTV, on
    the card unless ``device`` names another."""
    wheel_radius = POLARIS_SPEC["wheel_radius"]
    mass = POLARIS_SPEC["chassis_mass"]
    tire = TMeasyParams(**tensors(dtype, device,
        radius=wheel_radius, width=0.24, Fz0=mass * 9.81 / 4, cz=110000.0,
        dz=1200.0,
        dfx0_1=40000.0, fxm_1=2300.0, fxs_1=2000.0, sxm_1=0.14, sxs_1=0.9,
        dfx0_2=80000.0, fxm_2=4500.0, fxs_2=3900.0, sxm_2=0.17,
        sxs_2=0.95,
        dfy0_1=32000.0, fym_1=2100.0, fys_1=1900.0, sym_1=0.30, sys_1=1.0,
        dfy0_2=62000.0, fym_2=4100.0, fys_2=3700.0, sym_2=0.35, sys_2=1.0,
        rolling_resistance=0.02))
    w_max = POLARIS_SPEC["engine_speed_rpm"] * 2.0 * 3.14159265 / 60.0
    powertrain = powertrain_deck(
        POLARIS_SPEC["engine_torque"],
        0.963 * w_max,              # the map peaks at 2600 of 2700 rpm
        w_max, gears=POLARIS_SPEC["gear_ratios"][:3], shifts=[7.0, 15.0],
        final=3.2, driven=driven, efficiency=0.82, dtype=dtype,
        device=device)
    return build_wheeled_vehicle(
        chassis_mass=mass,
        chassis_inertia=POLARIS_SPEC["chassis_inertia"],
        wheelbase=POLARIS_SPEC["wheelbase"],
        track=POLARIS_SPEC["track"],
        cg_height=POLARIS_SPEC["cg_height"],
        wheel_mass=POLARIS_SPEC["wheel_mass"],
        wheel_radius=wheel_radius,
        wheel_width=POLARIS_SPEC["wheel_width"],
        wheel_inertia_spin=POLARIS_SPEC["wheel_inertia_spin"],
        suspension_k=POLARIS_SPEC["suspension_k"],
        suspension_c=POLARIS_SPEC["suspension_c"],
        tire=tire,
        powertrain=powertrain,
        max_steer_angle=0.61,
        max_brake_torque=900.0,
        driven=driven,
        suspension=suspension,
        dtype=dtype,
        device=device,
    )
