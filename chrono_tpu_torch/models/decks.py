"""Parameter decks for the remaining reference vehicle families.

Counterpart of ``chrono_tpu/models/decks.py``: a model is a parameter deck
for the generic wheeled builder (public-spec masses, geometry, engine and
tire scaling applied to ``build_wheeled_vehicle``), callable as
``create_vehicle(name, **kw)`` or through the per-family ``create_*``
functions.  The tracked deck, ``build_marder``, builds on the band-track
formulation of ``vehicle.tracked``.
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.models.common import powertrain_deck, tensors
from chrono_tpu_torch.vehicle.tire import TMeasyParams
from chrono_tpu_torch.vehicle.tracked import (
    TrackParams, build_tracked_vehicle,
)
from chrono_tpu_torch.vehicle.wheeled import build_wheeled_vehicle


def tmeasy_for_load(wheel_radius, width, fz0, stiff=1.0, damp=1.0,
                    dtype=torch.float32, device=None):
    """TMeasy parameters scaled to a nominal corner load (the reference's
    TMeasy decks follow the same load-normalised pattern)."""
    f = fz0 / 4000.0          # relative to a ~400 kg corner
    return TMeasyParams(**tensors(dtype, device,
        radius=wheel_radius, width=width, Fz0=fz0,
        cz=260000.0 * f * stiff, dz=2800.0 * f * damp,
        dfx0_1=90000.0 * f, fxm_1=4800.0 * f, fxs_1=4200.0 * f, sxm_1=0.12,
        sxs_1=0.9,
        dfx0_2=180000.0 * f, fxm_2=9500.0 * f, fxs_2=8300.0 * f,
        sxm_2=0.15, sxs_2=0.95,
        dfy0_1=70000.0 * f, fym_1=4400.0 * f, fys_1=4000.0 * f, sym_1=0.28,
        sys_1=1.0,
        dfy0_2=135000.0 * f, fym_2=8700.0 * f, fys_2=7900.0 * f,
        sym_2=0.32, sys_2=1.0, rolling_resistance=0.015))


# family → deck (public specifications; masses in kg, lengths in m)
DECKS = {
    # John Deere Gator-class electric utility vehicle — every field derived
    # from the reference's own JSON deck (cross-checked field-by-field by
    # the JAX package's tests against the reference's Gator JSON decks):
    #   mass/inertia/cg: Gator_Chassis.json (800 kg, [107.7,350.8,457.7],
    #     COM z 0.359); wheelbase: 2·0.97 axle offset (Gator_Vehicle.json);
    #   track: mean of front 2·0.56 (SingleWishbone spindle COM) and rear
    #     2·0.62 (RigidSuspensionRear);
    #   wheel: Wheel.json 11 kg + TMeasyTireFront.json 9.3 kg; radius
    #     0.28575, width 0.254; spin inertia 0.42 + 0.416;
    #   k/c: 300000, 20000 shock (SingleWishboneFront) x motion ratio^2
    #     ((0.39-0.06)/(0.56-0.06))^2 = 0.436 -> wheel rate;
    #   engine: EngineSimple 200 Nm, 14 kW (peak-power speed 70 rad/s),
    #     360 rad/s max; single forward gear 0.07 with conical 1.0 ->
    #     one 14.286:1 reduction; brake: BrakeShafts.json 800 Nm.
    "gator": dict(
        mass=800.0, inertia=(107.7, 350.8, 457.7), wheelbase=1.94,
        track=1.18, cg_height=0.359, wheel_mass=20.3, wheel_radius=0.28575,
        wheel_width=0.254, wheel_inertia=0.836,
        k=130700.0, c=8712.0, engine=(200.0, 70.0, 360.0, 0.1),
        gears=[14.286], shifts=[], final=1.0, driven="RWD",
        steer=0.44, brake=800.0,
    ),
    # FED-Alpha demonstrator (src/chrono_models/vehicle/feda)
    "feda": dict(
        mass=4600.0, inertia=(2200.0, 6800.0, 7200.0), wheelbase=3.30,
        track=1.90, cg_height=0.95, wheel_mass=55.0, wheel_radius=0.49,
        wheel_width=0.37, wheel_inertia=3.2,
        k=190000.0, c=16000.0, engine=(750.0, 280.0, 420.0),
        gears=[10.0, 6.1, 3.8, 2.4, 1.5], shifts=[4.0, 8.0, 13.0, 19.0],
        final=4.5, driven="AWD", steer=0.5, brake=7000.0,
    ),
    # UAZ-469 light 4x4 (src/chrono_models/vehicle/uaz)
    "uaz": dict(
        mass=1700.0, inertia=(700.0, 2000.0, 2200.0), wheelbase=2.38,
        track=1.45, cg_height=0.68, wheel_mass=26.0, wheel_radius=0.37,
        wheel_width=0.22, wheel_inertia=1.3,
        k=65000.0, c=6000.0, engine=(170.0, 420.0, 600.0),
        gears=[8.0, 4.7, 2.9, 1.9], shifts=[5.0, 10.0, 16.0],
        final=4.6, driven="AWD", steer=0.55, brake=2200.0,
    ),
    # Jeep Cherokee-class SUV (src/chrono_models/vehicle/jeep)
    "jeep": dict(
        mass=1950.0, inertia=(750.0, 2400.0, 2600.0), wheelbase=2.70,
        track=1.60, cg_height=0.66, wheel_mass=28.0, wheel_radius=0.36,
        wheel_width=0.24, wheel_inertia=1.4,
        k=80000.0, c=7000.0, engine=(350.0, 420.0, 650.0),
        gears=[9.2, 5.4, 3.3, 2.2, 1.5], shifts=[5.0, 10.0, 17.0, 25.0],
        final=3.7, driven="AWD", steer=0.55, brake=3000.0,
    ),
    # BMW 330i-class sport sedan (src/chrono_models/vehicle/bmw)
    "bmw": dict(
        mass=1600.0, inertia=(550.0, 2100.0, 2300.0), wheelbase=2.85,
        track=1.57, cg_height=0.5, wheel_mass=22.0, wheel_radius=0.33,
        wheel_width=0.23, wheel_inertia=1.1,
        k=95000.0, c=8500.0, engine=(400.0, 520.0, 700.0),
        gears=[10.5, 6.2, 4.1, 2.9, 2.1, 1.7],
        shifts=[6.0, 12.0, 19.0, 27.0, 36.0],
        final=3.2, driven="RWD", steer=0.6, brake=3200.0,
    ),
    # CityBus-class 12 m transit bus (src/chrono_models/vehicle/citybus)
    "citybus": dict(
        mass=13500.0, inertia=(9000.0, 55000.0, 58000.0), wheelbase=6.10,
        track=2.18, cg_height=1.1, wheel_mass=110.0, wheel_radius=0.48,
        wheel_width=0.30, wheel_inertia=8.0,
        k=450000.0, c=40000.0, engine=(1300.0, 200.0, 280.0),
        gears=[7.5, 4.6, 2.9, 1.9, 1.3], shifts=[4.0, 8.0, 13.0, 18.0],
        final=5.1, driven="RWD", steer=0.45, brake=18000.0,
    ),
    # MAN Kat 1 10t-class military truck (src/chrono_models/vehicle/man;
    # modeled on two axles — the reference's 6x6/8x8 variants extend the
    # same deck with more axles)
    "man": dict(
        mass=9000.0, inertia=(5500.0, 32000.0, 34000.0), wheelbase=4.5,
        track=2.0, cg_height=1.2, wheel_mass=90.0, wheel_radius=0.55,
        wheel_width=0.36, wheel_inertia=6.5,
        k=320000.0, c=28000.0, engine=(1100.0, 230.0, 320.0),
        gears=[9.0, 5.4, 3.4, 2.2, 1.5], shifts=[4.0, 8.0, 13.0, 19.0],
        final=5.3, driven="AWD", steer=0.45, brake=14000.0,
    ),
    # KrAZ 64431-class 6x4 tractor (src/chrono_models/vehicle/kraz),
    # tractor unit only
    "kraz": dict(
        mass=10800.0, inertia=(6800.0, 38000.0, 41000.0), wheelbase=4.28,
        track=2.05, cg_height=1.15, wheel_mass=105.0, wheel_radius=0.57,
        wheel_width=0.37, wheel_inertia=7.5,
        k=380000.0, c=32000.0, engine=(1500.0, 200.0, 270.0),
        gears=[8.2, 5.0, 3.1, 2.0, 1.4], shifts=[4.0, 8.0, 12.0, 17.0],
        final=5.7, driven="RWD", steer=0.42, brake=16000.0,
    ),
    # NOTE: the reference's ARTcar (1/6-scale, 5 kg) is intentionally NOT
    # decked: at that scale the low-speed tire-slip regularization of the
    # shared TMeasy/corner formulation (sized for road vehicles) chatters
    # and pumps the wheel-hop mode — a measured limitation, not an omission.
    # Bucher Duro 4x4 light tactical truck (src/chrono_models/vehicle/duro;
    # chassis 4900 kg)
    "duro": dict(
        mass=4900.0, inertia=(2400.0, 7200.0, 7600.0), wheelbase=3.23,
        track=1.80, cg_height=0.95, wheel_mass=50.0, wheel_radius=0.45,
        wheel_width=0.30, wheel_inertia=3.0,
        k=200000.0, c=17000.0, engine=(180.0, 320.0, 480.0),
        gears=[9.6, 5.8, 3.6, 2.3, 1.5], shifts=[4.0, 8.0, 13.0, 19.0],
        final=4.9, driven="AWD", steer=0.5, brake=7500.0,
    ),
    # Mercedes G500 wagon (src/chrono_models/vehicle/gclass; chassis 2354 kg)
    "gclass": dict(
        mass=2354.0, inertia=(900.0, 2900.0, 3100.0), wheelbase=2.85,
        track=1.55, cg_height=0.70, wheel_mass=28.0, wheel_radius=0.37,
        wheel_width=0.26, wheel_inertia=1.5,
        k=95000.0, c=8500.0, engine=(310.0, 450.0, 650.0),
        gears=[10.0, 6.0, 3.8, 2.5, 1.7], shifts=[5.0, 10.0, 17.0, 25.0],
        final=3.9, driven="AWD", steer=0.55, brake=3600.0,
    ),
    # mrole multi-role 8x8 demonstrator (src/chrono_models/vehicle/mrole;
    # chassis 31.2 t — modeled on two effective axles like the man deck)
    "mrole": dict(
        mass=31200.0, inertia=(22000.0, 120000.0, 128000.0), wheelbase=4.5,
        track=2.3, cg_height=1.3, wheel_mass=115.0, wheel_radius=0.57,
        wheel_width=0.40, wheel_inertia=9.0,
        k=1100000.0, c=95000.0, engine=(2400.0, 200.0, 260.0),
        gears=[8.5, 5.2, 3.2, 2.1, 1.4], shifts=[4.0, 8.0, 12.0, 17.0],
        final=5.9, driven="AWD", steer=0.4, brake=42000.0,
    ),
    # FMTV 4x4 tactical truck (src/chrono_models/vehicle/mtv; front chassis
    # 3946 kg + rear 1938 kg)
    "mtv": dict(
        mass=5900.0, inertia=(3100.0, 16000.0, 17000.0), wheelbase=3.90,
        track=1.95, cg_height=1.05, wheel_mass=65.0, wheel_radius=0.51,
        wheel_width=0.34, wheel_inertia=4.5,
        k=240000.0, c=21000.0, engine=(205.0, 310.0, 460.0),
        gears=[9.2, 5.6, 3.5, 2.3, 1.5], shifts=[4.0, 8.0, 13.0, 19.0],
        final=5.0, driven="AWD", steer=0.48, brake=9000.0,
    ),
    # Unimog U401 agricultural 4x4 (src/chrono_models/vehicle/unimog;
    # chassis 2621 kg, famously short 1.72 m wheelbase)
    "unimog": dict(
        mass=2621.0, inertia=(1100.0, 2600.0, 2900.0), wheelbase=1.72,
        track=1.27, cg_height=0.85, wheel_mass=40.0, wheel_radius=0.40,
        wheel_width=0.24, wheel_inertia=2.2,
        k=110000.0, c=9500.0, engine=(95.0, 180.0, 320.0),
        gears=[9.0, 5.5, 3.4, 2.2], shifts=[2.5, 5.0, 8.5],
        final=5.5, driven="AWD", steer=0.5, brake=3800.0,
    ),
}


def create_vehicle(name: str, driven=None, suspension="reduced",
                   dtype=torch.float32, device=None):
    """Instantiate any wheeled deck: returns ``(WheeledVehicle,
    BodyState)``, on the card unless ``device`` names another."""
    d = DECKS[name]
    fz0 = d["mass"] * 9.81 / 4
    tire = tmeasy_for_load(d["wheel_radius"], d["wheel_width"], fz0,
                           stiff=d.get("tire_stiff", 1.0),
                           damp=d.get("tire_damp", 1.0), dtype=dtype,
                           device=device)
    eng = d["engine"]
    mt, mps, ms = eng[:3]
    drv = driven or d["driven"]
    powertrain = powertrain_deck(
        mt, mps, ms, gears=d["gears"], shifts=d["shifts"], final=d["final"],
        driven=drv, efficiency=0.85,
        # optional 4th entry: the loss scale (sub-scale vehicles need
        # sub-scale engine-braking losses)
        loss_scale=eng[3] if len(eng) > 3 else 1.0, dtype=dtype,
        device=device)
    return build_wheeled_vehicle(
        chassis_mass=d["mass"],
        chassis_inertia=d["inertia"],
        wheelbase=d["wheelbase"],
        track=d["track"],
        cg_height=d["cg_height"],
        wheel_mass=d["wheel_mass"],
        wheel_radius=d["wheel_radius"],
        wheel_width=d["wheel_width"],
        wheel_inertia_spin=d["wheel_inertia"],
        suspension_k=d["k"],
        suspension_c=d["c"],
        tire=tire,
        powertrain=powertrain,
        max_steer_angle=d["steer"],
        max_brake_torque=d["brake"],
        driven=drv,
        suspension=suspension,
        dtype=dtype,
        device=device,
    )


def _deck(name):
    def create(**kw):
        return create_vehicle(name, **kw)
    create.__name__ = create.__qualname__ = f"create_{name}"
    create.__doc__ = f"``create_vehicle({name!r}, **kw)``."
    return create


create_gator = _deck("gator")
create_feda = _deck("feda")
create_uaz = _deck("uaz")
create_jeep = _deck("jeep")
create_bmw = _deck("bmw")
create_citybus = _deck("citybus")
create_man = _deck("man")
create_kraz = _deck("kraz")
create_duro = _deck("duro")
create_gclass = _deck("gclass")
create_mrole = _deck("mrole")
create_mtv = _deck("mtv")
create_unimog = _deck("unimog")

def build_marder(pos=(0.0, 0.0, None), dtype=torch.float32, device=None):
    """Marder-class IFV on the tracked-vehicle formulation (~28.5 t, a
    wider and longer track footprint than the M113); ``(TrackedVehicle,
    BodyState)`` on the card unless ``device`` names another."""
    track = TrackParams(n_patches=8, **tensors(
        dtype, device, sprocket_radius=0.264, track_length=3.9,
        track_width=0.45, kz=1.4e6, cz=1.2e5, mu_lon=0.85, mu_lat=0.65,
        slip_v0=0.15, rolling_resistance=0.028))
    return build_tracked_vehicle(
        chassis_mass=28500.0, chassis_inertia=(38000.0, 110000.0, 120000.0),
        sprocket_inertia=45.0, half_track=1.25, ride_height=0.55,
        track=track, pos=pos, dtype=dtype, device=device)
