"""The M113 acceleration run and the Marder's spin-up on the CPU: the JAX
package and the PyTorch port.

    JAX_PLATFORMS=cpu python tools/m113_reference.py [--port]

Runs ``chrono_tpu.models.m113.m113_acceleration_run`` (the btest_VEH_m113Acc
manoeuvre: 3,000 steps of 2 ms at 6,000 N·m a sprocket from rest on flat
ground, the chassis speed sampled after every 50th step) and the Marder
check of tests/test_model_decks.py (600 steps of 2 ms at 16,000 N·m a
sprocket) and prints, unrounded, the 60 sample times and speeds and the
Marder's final chassis speed as Python constants.  With ``--port``, the
port's ``m113_acceleration_run`` and Marder check on the CPU in float32
and in float64 and the largest gap of each to the JAX speeds (the float32
floors that ``chip_smoke.py``'s phase 17 (b) tolerances rest on).  ``chip_smoke.py``
embeds these numbers: the card's machine has no JAX.
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

MARDER_STEPS, MARDER_TORQUE, H = 600, 16000.0, 2e-3


def jax_marder():
    from chrono_tpu.models.decks import build_marder
    from chrono_tpu.vehicle.tracked import tracked_step

    veh, state = build_marder()
    flat = lambda xy: jnp.zeros(xy.shape[:-1])
    step = jax.jit(lambda s, tq: tracked_step(veh, s, tq, flat, H))
    tq = jnp.asarray([MARDER_TORQUE, MARDER_TORQUE], jnp.float32)
    for _ in range(MARDER_STEPS):
        state = step(state, tq).state
    return float(state.v[veh.chassis, 0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU in float32 and "
                         "float64")
    args = ap.parse_args()
    from chrono_tpu.models.m113 import m113_acceleration_run

    times, speeds = m113_acceleration_run()
    print(f"M113_TIMES_H = {H!r}  # the samples are at 50·k·h, k = 0..."
          f"{len(times) - 1}")
    print("JAX_M113_SPEEDS = (")
    for i in range(0, len(speeds), 4):
        print("    " + ", ".join(repr(float(v)) for v in speeds[i:i + 4])
              + ",")
    print(")")
    print(f"JAX_MARDER_SPEED = {jax_marder()!r}")
    if args.port:
        import torch
        from chrono_tpu_torch.models import build_marder as port_marder
        from chrono_tpu_torch.models.m113 import (
            m113_acceleration_run as port_run,
        )
        from chrono_tpu_torch.vehicle.terrain import flat_terrain
        from chrono_tpu_torch.vehicle.tracked import tracked_step as port_step

        jax_marder_v = jax_marder()
        for dtype in (torch.float32, torch.float64):
            t, v = port_run(dtype=dtype, device="cpu")
            assert np.array_equal(t, times)
            gap = np.abs(v - speeds)
            print(f"port {dtype}: final speed {float(v[-1])!r} m/s, largest "
                  f"|Δv| to the JAX run {float(gap.max())!r} m/s at sample "
                  f"{int(gap.argmax())}")
            veh, st = port_marder(dtype=dtype, device="cpu")
            tq = torch.full((2,), MARDER_TORQUE, dtype=dtype)
            for _ in range(MARDER_STEPS):
                st = port_step(veh, st, tq, flat_terrain(0.0), H).state
            vx = float(st.v[veh.chassis, 0])
            print(f"port {dtype}: Marder speed {vx!r} m/s, |Δv| to the JAX "
                  f"run {abs(vx - jax_marder_v)!r}")


if __name__ == "__main__":
    main()
