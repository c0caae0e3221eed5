"""HMMWV-class vehicle model (parameter set).

Counterpart of ``chrono_tpu/models/hmmwv.py`` (the reference's HMMWV
family): a ~2.4 t 4×4 utility truck on the port's vehicle templates, with
the JAX package's own copy of its constants.
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.models.common import powertrain_deck, tensors
from chrono_tpu_torch.vehicle.tire import TMeasyParams
from chrono_tpu_torch.vehicle.wheeled import build_wheeled_vehicle

# The JAX package's deck values (its docstring derives them from the
# reference's hmmwv JSON files: suspension rates are the spring-curve
# tangent at the static corner load and the linear shock coefficient,
# reflected to the wheel through the wishbone motion ratio 0.3913765).
HMMWV_SPEC = dict(
    chassis_mass=2086.52,
    chassis_inertia=(1078.52, 2955.66, 3570.2),
    chassis_com=(0.056, 0.0, 0.213),
    wheelbase=3.37793,
    track=1.82,
    wheel_mass=56.4,            # rim 18.8 + TMeasy tire 37.6
    wheel_inertia_spin=7.3143,  # rim 0.6243 + tire 6.69 (spin axis)
    wheel_radius=0.4699,
    wheel_width=0.3175,
    suspension_k=67598.04,      # 441311 N/m tangent x 0.3913765^2
    suspension_c=2912.72,       # 19015.5692 N s/m x 0.3913765^2
    engine_torque=330.0,        # EngineSimple
    engine_power=110000.0,
    engine_speed=10000.0,
    gear_ratios=(5.0, 2.5, 1.25),   # 1 / (0.2, 0.4, 0.8)
    final_drive=5.0,                # 1 / conical 0.2
    # CG above ground = chassis COM z - axle z (0) + tire radius
    cg_height=0.6829,
)


def create_hmmwv(driven="AWD", dtype=torch.float32, device=None):
    """Returns ``(WheeledVehicle, BodyState)`` for an HMMWV-class truck, on
    the card unless ``device`` names another."""
    wheel_radius = HMMWV_SPEC["wheel_radius"]
    mass = HMMWV_SPEC["chassis_mass"]
    tire = TMeasyParams(**tensors(dtype, device,
        radius=wheel_radius, width=HMMWV_SPEC["wheel_width"],
        Fz0=mass * 9.81 / 4, cz=326000.0, dz=3500.0,
        # longitudinal/lateral characteristics scaled to the 37x12.5R16.5
        dfx0_1=120000.0, fxm_1=6200.0, fxs_1=5400.0, sxm_1=0.12,
        sxs_1=0.9,
        dfx0_2=240000.0, fxm_2=12000.0, fxs_2=10400.0, sxm_2=0.15,
        sxs_2=0.95,
        dfy0_1=90000.0, fym_1=5800.0, fys_1=5200.0, sym_1=0.28, sys_1=1.0,
        dfy0_2=170000.0, fym_2=11000.0, fys_2=9800.0, sym_2=0.32,
        sys_2=1.0, rolling_resistance=0.015))
    # EngineSimple (T 330 N m, P 110 kW, w_max 1e4 rad/s): a torque plateau
    # to the peak-power speed P/T, then power-limited
    w_peak = HMMWV_SPEC["engine_power"] / HMMWV_SPEC["engine_torque"]
    powertrain = powertrain_deck(
        HMMWV_SPEC["engine_torque"], w_peak, HMMWV_SPEC["engine_speed"],
        gears=HMMWV_SPEC["gear_ratios"], shifts=[6.0, 12.0, 19.0],
        final=HMMWV_SPEC["final_drive"], driven=driven, efficiency=0.85,
        dtype=dtype, device=device)
    return build_wheeled_vehicle(
        chassis_mass=mass,
        chassis_inertia=HMMWV_SPEC["chassis_inertia"],
        wheelbase=HMMWV_SPEC["wheelbase"],
        track=HMMWV_SPEC["track"],
        cg_height=HMMWV_SPEC["cg_height"],
        wheel_mass=HMMWV_SPEC["wheel_mass"],
        wheel_radius=wheel_radius,
        wheel_width=HMMWV_SPEC["wheel_width"],
        wheel_inertia_spin=HMMWV_SPEC["wheel_inertia_spin"],
        suspension_k=HMMWV_SPEC["suspension_k"],
        suspension_c=HMMWV_SPEC["suspension_c"],
        tire=tire,
        powertrain=powertrain,
        max_steer_angle=0.52,
        max_brake_torque=4000.0,
        driven=driven,
        dtype=dtype,
        device=device,
    )
