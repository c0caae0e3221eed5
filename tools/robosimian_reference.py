"""The RoboSimian drive on the CPU: the JAX package and the PyTorch port.

    JAX_PLATFORMS=cpu python tools/robosimian_reference.py [--steps N ...]
        [--seeds K] [--port]

Runs ``demos/demo_robosimian_drive.py``'s drive with the JAX package: the
robot of ``create_robosimian`` from the driving actuation table that
``chip_smoke.robosimian_tables`` writes (a table made up in the
reference's 33-column format, not the reference's gait: its stance and
wheel speeds are stated there), wheel speeds 4× the table's joint-8
column, APGD with ``max_iter=60``, ``stab_factor=0.2``, h = 2e-3, from
rest.  Prints, unrounded, the chassis advance along x after each step
count asked for (the demo's 500 steps and the test's 300 by default), its
lateral and vertical moves, and the JAX run's own response: the largest
change of the advance over ``--seeds`` runs whose start state is moved by
~1e-6 relative (each float of x, q, v, ω times 1 + 1e-6·N(0, 1)).  APGD
stops at its 60 iterations unconverged, so its path turns on rounding,
and this response is the spread that ``chip_smoke.py``'s phase 18 (b)
tolerance rests on.  With ``--port``, the port's drive on the CPU and its
gap to the JAX advance.  ``chip_smoke.py`` embeds these numbers: the
card's machine has no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

H = 2e-3


def jax_scene(directory):
    from chrono_tpu.models.robosimian import create_robosimian, gait_programs

    cycle, _ = chip_smoke.robosimian_tables(directory)
    _, posture, _ = gait_programs(cycle)
    post = posture.reshape(4, 8).copy()
    speeds = 4.0 * post[:, 7]
    post[:, 7] = 0.0
    return create_robosimian(post.reshape(-1), speeds)


def jax_drive(step, state, chassis, counts):
    """The chassis displacement after each step count in ``counts``."""
    x0 = np.asarray(state.x[chassis], np.float64)
    out, t = {}, 0.0
    for k in range(1, max(counts) + 1):
        state, _, _ = step(state, jnp.float32(t))
        t += H
        if k in counts:
            out[k] = np.asarray(state.x[chassis], np.float64) - x0
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, nargs="+", default=[300, 500])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--port", action="store_true",
                    help="also run the port's drive on the CPU")
    args = ap.parse_args()
    from chrono_tpu.collision.pipeline import nsc_step
    from chrono_tpu.physics.system import SolverSettings

    with tempfile.TemporaryDirectory() as d:
        model, state, coll, chassis, _ = jax_scene(d)
    settings = SolverSettings(solver="apgd", max_iter=60, stab_factor=0.2)
    step = jax.jit(lambda s, t: nsc_step(model, coll, s, t, H, settings))
    counts = set(args.steps)
    base = jax_drive(step, state, chassis, counts)
    rng = np.random.default_rng(0)
    resp = {n: 0.0 for n in counts}
    for _ in range(args.seeds):
        moved = state.replace(**{
            f: jnp.asarray(np.asarray(getattr(state, f)) * (
                1.0 + 1e-6 * rng.normal(size=getattr(state, f).shape)),
                jnp.float32) for f in "xqvw"})
        run = jax_drive(step, moved, chassis, counts)
        for n in counts:
            resp[n] = max(resp[n], abs(float(run[n][0] - base[n][0])))
    for n in sorted(counts):
        print(f"# {n} steps: chassis moved {base[n].tolist()!r} m")
        print(f"JAX_RS_ADVANCE_{n} = {float(base[n][0])!r}")
        print(f"JAX_RS_RESPONSE_{n} = {resp[n]!r}  # over {args.seeds} "
              f"starts moved by ~1e-6")
    if args.port:
        import torch

        from chrono_tpu_torch.collision.pipeline import (
            nsc_step as port_step,
        )
        from chrono_tpu_torch.physics.system import (
            SolverSettings as PortSettings,
        )

        torch.set_num_threads(1)
        with tempfile.TemporaryDirectory() as d:
            pm, ps, pc, pch, _, _ = chip_smoke.robosimian_scene("cpu", d)
        psettings = PortSettings(solver="apgd", max_iter=60,
                                 stab_factor=0.2)
        x0 = ps.x[pch].double().clone()
        t = torch.zeros(())
        for k in range(1, max(counts) + 1):
            ps, _, _ = port_step(pm, pc, ps, t, H, psettings)
            t = t + H
            if k in counts:
                dx = (ps.x[pch].double() - x0).numpy()
                print(f"port on the CPU, {k} steps: moved {dx.tolist()!r} "
                      f"m, advance gap to JAX "
                      f"{abs(float(dx[0] - base[k][0]))!r} m")


if __name__ == "__main__":
    main()
