"""The HMMWV double lane change's outcome on the CPU: the JAX demo and the
PyTorch port.

    JAX_PLATFORMS=cpu python tools/dlc_reference.py [--steps N] [--port]
    python tools/dlc_reference.py --drive

Runs the closed loop of ``demos/demo_vehicle_dlc.py`` as that demo's jitted
scan writes it (the HMMWV, AWD, reduced corners, flat ground, the DLC path,
a 12 m/s target, h = 1e-3) and prints what the demo prints, unrounded: the
distance travelled (the chassis x at the start of the last step), the
largest lateral offset, the chassis speed after the last step, and the
joint violation of every step (final, median, largest, the share above
1e-3).  With ``--port``, the port's ``run_closed_loop`` on the CPU in
float32 and in float64 prints the same (about 6 minutes each at 15,000
steps).  With ``--drive``, only the float32 floor of phase 14(d)'s drives.
``chip_smoke.py``'s phase 14 holds the card to these numbers.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

H, TARGET = 1e-3, 12.0


def jax_run(n):
    from chrono_tpu.core import quaternion as Q
    from chrono_tpu.models import create_hmmwv
    from chrono_tpu.physics.joints import joint_violation
    from chrono_tpu.vehicle import (
        DriverInputs, PathFollower, SpeedController,
        double_lane_change_path, flat_terrain, vehicle_step,
    )

    vehicle, state = create_hmmwv()
    path = double_lane_change_path()

    def violation(st):
        return jnp.max(jnp.stack([
            jnp.abs(joint_violation(k, d, st.x, st.q)).max()
            for k, d in vehicle.model.joints.items()]))

    @functools.partial(jax.jit, static_argnums=3)
    def run(state, sc, pc, n):
        def body(carry, k):
            st, sc, pc, t = carry
            speed = jnp.linalg.norm(st.v[vehicle.chassis, :2])
            throttle, braking, sc = sc(TARGET, speed, H)
            fwd = Q.qrotate(st.q[vehicle.chassis], jnp.asarray([1.0, 0, 0]))
            heading = jnp.arctan2(fwd[1], fwd[0])
            steer, pc = pc(st.x[vehicle.chassis, :2], heading, H)
            out = vehicle_step(vehicle, st,
                               DriverInputs(steer, throttle, braking),
                               flat_terrain(0.0), t, H)
            return (out.state, sc, pc, t + H), (st.x[vehicle.chassis],
                                                violation(out.state))
        (st, _, _, _), rec = jax.lax.scan(
            body, (state, sc, pc, jnp.asarray(0.0)), jnp.arange(n))
        return st, rec

    final, (xs, viol) = run(
        state, SpeedController(kp=jnp.asarray(0.6), ki=jnp.asarray(0.2)),
        PathFollower(path_xy=path, look_ahead=jnp.asarray(8.0),
                     kp=jnp.asarray(0.25), kd=jnp.asarray(0.15)), n)
    return (np.asarray(xs), float(jnp.linalg.norm(final.v[0, :2])),
            np.asarray(viol))


def port_run(n, dtype):
    import torch

    from chrono_tpu_torch.models import create_hmmwv
    from chrono_tpu_torch.physics.joints import joint_violation
    from chrono_tpu_torch.vehicle import (
        PathFollower, SpeedController, double_lane_change_path,
        flat_terrain,
    )
    from chrono_tpu_torch.vehicle.closed_loop import closed_loop_step

    vehicle, state = create_hmmwv(dtype=dtype, device="cpu")
    sc = SpeedController(kp=0.6, ki=0.2)
    pc = PathFollower(path_xy=double_lane_change_path(dtype, "cpu"),
                      look_ahead=8.0, kp=0.25, kd=0.15)
    t = torch.zeros((), dtype=dtype)
    xs, viol = [], []
    for _ in range(n):
        xs.append(state.x[vehicle.chassis])
        state, sc, pc = closed_loop_step(vehicle, state, sc, pc,
                                         flat_terrain(0.0), TARGET, t, H)
        t = t + H
        viol.append(max(float(joint_violation(k, d, state.x, state.q)
                              .abs().max())
                        for k, d in vehicle.model.joints.items()))
    return (torch.stack(xs).numpy(),
            float(torch.linalg.norm(state.v[vehicle.chassis, :2])),
            np.asarray(viol))


def report(what, xs, speed, viol):
    print(f"{what}: travelled {float(xs[-1, 0])!r} m, max lateral "
          f"{float(xs[:, 1].max())!r} m, final speed {speed!r} m/s; joint "
          f"violation final {viol[-1]:.4e}, median {np.median(viol):.4e}, "
          f"max {viol.max():.4e}, share of steps above 1e-3 "
          f"{(viol > 1e-3).mean():.4f}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=15000)
    parser.add_argument("--port", action="store_true",
                        help="also run the port on the CPU (float32, "
                        "float64)")
    parser.add_argument("--drive", action="store_true",
                        help="only the float32 floor of chip_smoke.py's "
                        "phase 14(d) drives (the port, float32 against "
                        "float64)")
    args = parser.parse_args()
    if args.drive:
        import torch

        import chip_smoke

        torch.set_num_threads(1)
        for what, build in chip_smoke.DRIVE_BUILDS.items():
            a, b = (chip_smoke.drive(build, "cpu", dt).chassis_x.numpy()
                    for dt in (torch.float32, torch.float64))
            print(f"{what}, {chip_smoke.DRIVE_STEPS} steps, float32 against "
                  f"float64: chassis track {np.abs(a - b).max():.4e} m")
        return
    print(f"jax {jax.__version__}, {args.steps} steps")
    report("JAX demo (scan)", *jax_run(args.steps))
    if args.port:
        import torch

        torch.set_num_threads(1)
        for dtype in (torch.float32, torch.float64):
            report(f"port on the CPU, {dtype}", *port_run(args.steps, dtype))


if __name__ == "__main__":
    main()
