"""M113-class tracked vehicle model.

Counterpart of ``chrono_tpu/models/m113.py`` (the reference's ready-made
M113, exercised by btest_VEH_m113Acc): public-spec mass and geometry on the
band-track formulation of ``vehicle.tracked``, with the JAX package's own
copy of its deck values.
"""

from __future__ import annotations

import numpy as np
import torch

from chrono_tpu_torch.models.common import tensors
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.utils.graph import capture
from chrono_tpu_torch.vehicle.terrain import flat_terrain
from chrono_tpu_torch.vehicle.tracked import (
    TrackParams, build_tracked_vehicle, tracked_step,
)

# The JAX package's deck values (its tests hold them to the reference's
# M113 JSON files).  The lumped-track formulation folds the 2 x 63
# single-pin shoes into the hull mass; the sprocket pitch radius is the
# single-pin assembly radius.
M113_SPEC = dict(
    hull_mass=7819.24,
    chassis_inertia=(13983.08, 27287.61, 28805.57),
    chassis_com=(-2.006, 0.0, 0.406),
    half_track=1.0795,
    sprocket_radius=0.245,      # single-pin Assembly Radius
    sprocket_teeth=10,
    sprocket_gear_mass=27.68,
    shoe_pitch=0.154,
    shoe_mass=18.02,
    shoe_height=0.06,
    shoe_inertia=(0.22, 0.04, 0.25),
    n_shoes=63,                 # per track assembly
    n_road_wheels=5,
    road_wheel_span=2.667,      # first to last suspension x
    total_mass=7819.24 + 2 * 63 * 18.02,
)


def build_m113(pos=(0.0, 0.0, None), dtype=torch.float32, device=None):
    """M113 APC on the lumped band-track formulation with the deck's
    single-pin parameters; ``(TrackedVehicle, BodyState)`` on the card
    unless ``device`` names another."""
    track = TrackParams(
        n_patches=M113_SPEC["n_road_wheels"],
        **tensors(dtype, device,
                  sprocket_radius=M113_SPEC["sprocket_radius"],
                  track_length=M113_SPEC["road_wheel_span"],
                  track_width=0.38, kz=6.0e5, cz=5.0e4, mu_lon=0.85,
                  mu_lat=0.65, slip_v0=0.15, rolling_resistance=0.025))
    # the track-loop rotary inertia about the sprocket axle: gear + the
    # shoes in the loop at the pitch radius (m r^2)
    r = M113_SPEC["sprocket_radius"]
    i_loop = (0.4 + M113_SPEC["n_shoes"] * M113_SPEC["shoe_mass"] * r * r)
    return build_tracked_vehicle(
        chassis_mass=M113_SPEC["total_mass"],
        chassis_inertia=M113_SPEC["chassis_inertia"],
        sprocket_inertia=i_loop, half_track=M113_SPEC["half_track"],
        ride_height=0.5, track=track, pos=pos, dtype=dtype, device=device)


_FIELDS = ("x", "q", "v", "w")


def m113_acceleration_run(n_steps=3000, h=2e-3, torque=6000.0,
                          dtype=torch.float32, device=None):
    """The btest_VEH_m113Acc manoeuvre: full drive torque on both sprockets
    from rest on flat rigid ground.  Returns (times, speeds) as numpy
    arrays, sampled after every 50th step from the first.

    On the card one ``tracked_step`` is captured into a CUDA graph that
    advances the state in place and is replayed ``n_steps`` times; each
    sample is a device copy into a preallocated buffer, so the run reads
    the host only once, at its end.  On the CPU the steps run eagerly.
    """
    veh, state = build_m113(dtype=dtype, device=device)
    flat = flat_terrain(0.0)
    tq = torch.full((2,), torque, dtype=dtype, device=state.x.device)
    n_samples = len(range(0, n_steps, 50))
    speeds = state.x.new_zeros((n_samples,))
    ch = veh.chassis
    if state.x.is_cuda:
        cur = BodyState(**{f: getattr(state, f).clone() for f in _FIELDS})

        def one_step():
            new = tracked_step(veh, cur, tq, flat, h).state
            for f in _FIELDS:
                getattr(cur, f).copy_(getattr(new, f))

        graph = capture(one_step, lambda: tracked_step(veh, cur, tq, flat, h),
                        cur.x.device)
        for k in range(n_steps):
            graph.replay()
            if k % 50 == 0:
                speeds[k // 50].copy_(cur.v[ch, 0])
    else:
        for k in range(n_steps):
            state = tracked_step(veh, state, tq, flat, h).state
            if k % 50 == 0:
                speeds[k // 50] = state.v[ch, 0]
    times = np.asarray([k * h for k in range(0, n_steps, 50)])
    return times, speeds.cpu().numpy()
