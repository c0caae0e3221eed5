"""The industrial-arm demo on the CPU: the JAX package and the PyTorch port.

    JAX_PLATFORMS=cpu python tools/arm_reference.py [--port]

Runs ``demos/demo_industrial_arm.py``'s scene whole with the JAX package:
``Arm6R.make(H=0.4, L1=0.6, L2=0.5, L3=0.15)``, its three waypoints, the
``poly345`` trajectory over 1.5 s sampled by IK at 49 points, 200 settling
steps at t = 0 and 750 steps of 2 ms on the direct solver; the TCP is read
every 10 steps, as the demo's CSV reads it.  Prints, unrounded, the final
TCP, the commanded end point and the tracking error as Python constants,
in float32 (the demo's precision) and in float64 (the same model cast),
and the gaps between the two: over the 75 TCP samples and at the end.
With ``--port``, the port's run on the CPU (float32 and float64) and its
gaps to the JAX runs.  The final TCP's gaps are the floor that
``chip_smoke.py``'s phase 18 (a) tolerance rests on: a sample taken at a
knot of the joint programs (t = 0.5 s, 1.0 s) moves by up to 3e-4 m
between two runs whose clocks round differently, since the programs'
slope jumps there.  ``chip_smoke.py`` embeds these numbers: the card's
machine has no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

T, H, SETTLE = chip_smoke.ARM_T, chip_smoke.ARM_H, chip_smoke.ARM_SETTLE
SAMPLES, EVERY = chip_smoke.ARM_SAMPLES, chip_smoke.ARM_EVERY
WAYPOINTS = chip_smoke.ARM_WAYPOINTS


def jax_arm_run(x64):
    """The demo's run: (TCP samples (75, 3), final TCP, commanded end)."""
    from chrono_tpu.core import quaternion as Q
    from chrono_tpu.models.industrial import (
        Arm6R, create_arm_6dof, fk_6r, joint_programs_from_trajectory,
        make_trajectory, traj_eval,
    )
    from chrono_tpu.physics.system import (
        SolverSettings, step_euler_implicit_linearized,
    )

    arm = Arm6R.make(H=0.4, L1=0.6, L2=0.5, L3=0.15)
    poses = [fk_6r(arm, jnp.asarray(q, jnp.float32)) for q in WAYPOINTS]
    traj = make_trajectory(jnp.stack([p for p, _ in poses]),
                           jnp.stack([r for _, r in poses]), total_time=T,
                           law="poly345")
    progs = joint_programs_from_trajectory(arm, traj, n_samples=SAMPLES)
    model, state, tool, tool_off = create_arm_6dof(arm, progs)
    pc = np.asarray(traj_eval(traj, jnp.asarray(T))[0], np.float64)
    with jax.enable_x64(x64):
        if x64:
            cast = lambda a: (jnp.asarray(np.asarray(a), jnp.float64)
                              if np.asarray(a).dtype.kind == "f" else a)
            model = jax.tree_util.tree_map(cast, model)
            state = jax.tree_util.tree_map(cast, state)
            tool_off = cast(tool_off)
        dt = jnp.float64 if x64 else jnp.float32
        settings = SolverSettings(solver="direct")
        step = jax.jit(lambda s, t: step_euler_implicit_linearized(
            model, s, t, H, settings)[0])
        for _ in range(SETTLE):
            state = step(state, jnp.asarray(0.0, dt))
        t, tcp = 0.0, []
        for i in range(int(T / H)):
            state = step(state, jnp.asarray(t, dt))
            t += H
            if i % EVERY == 0:
                tcp.append(np.asarray(state.x[tool] + Q.qrotate(
                    state.q[tool], tool_off), np.float64))
        p = np.asarray(state.x[tool] + Q.qrotate(state.q[tool], tool_off),
                       np.float64)
    return np.asarray(tcp), p, pc


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU in float32 and "
                         "float64")
    args = ap.parse_args()
    runs = {}
    for x64 in (False, True):
        tcp, p, pc = jax_arm_run(x64)
        runs[x64] = tcp, p
        name = "64" if x64 else "32"
        print(f"JAX_ARM_TCP{name} = {tuple(float(v) for v in p)!r}")
        print(f"JAX_ARM_ERR{name} = {float(np.linalg.norm(p - pc))!r}")
    print(f"JAX_ARM_CMD = {tuple(float(v) for v in pc)!r}")
    floor = float(np.abs(runs[False][0] - runs[True][0]).max())
    print(f"# float32 against float64, the {len(runs[False][0])} TCP "
          f"samples: largest gap {floor!r} m; final TCP "
          f"{float(np.abs(runs[False][1] - runs[True][1]).max())!r} m")
    if args.port:
        import torch

        torch.set_num_threads(1)
        for dtype in (torch.float32, torch.float64):
            tcp, p, err = chip_smoke.arm_demo_eager("cpu", dtype)
            for x64 in (False, True):
                gap = float(np.abs(tcp - runs[x64][0]).max())
                print(f"port {dtype} against JAX float{64 if x64 else 32}: "
                      f"largest TCP gap {gap!r} m, final TCP "
                      f"{float(np.abs(p - runs[x64][1]).max())!r} m "
                      f"(tracking error {err!r} m)")


if __name__ == "__main__":
    main()
