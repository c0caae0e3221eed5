"""The granular dam break's outcome on the CPU: the JAX demo and the
PyTorch port.

    JAX_PLATFORMS=cpu python tools/dem_dam_break_reference.py [--port]
                                                              [--frames N]

Runs ``demos/demo_dem_dam_break.py``'s loop as that demo writes it (a
``DEMSystem`` of r = 1 cm spheres, ρ = 2500, E = 1e7, e 0.4, μ 0.5 walls
alike, in a 1.2 × 0.2 × 0.4 m box, an HCP block of 0.3 × 0.195 × 0.3 m at
1.01 r, 8 substeps a cycle, 16 neighbours, dt from ``suggest_step_size``;
12 frames of 0.05 s) and prints, unrounded, the particle count, dt, and
at each frame the time, the front (the largest x) and the kinetic energy,
with the run's time.  With ``--port``, the port's ``DEMSystem`` on the CPU
in float32 and in float64 prints the same, then the largest front and
relative kinetic-energy differences of each against the JAX run.  A
granular collapse is chaotic, so the float32 port-against-JAX spread is
the tolerance ``chip_smoke.py``'s phase 16 (d) holds the card to.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

RADIUS = 0.01
BOX = ((0, 0, 0), (1.2, 0.2, 0.4))
MATERIAL = dict(youngs=1e7, restitution=0.4, mu_s=0.5)
FRAME = 0.05


def block(samplers):
    return samplers.hcp_sample_box((0.005, 0.005, 0.005), (0.3, 0.195, 0.3),
                                   RADIUS * 1.01)


def run(sys_, n_frames):
    """The demo's loop: (time, front x, kinetic energy) a frame."""
    out = []
    for _ in range(n_frames):
        sys_.advance(FRAME)
        pos = sys_.positions
        out.append((float(sys_.state.time), float(pos[:, 0].max()),
                    sys_.kinetic_energy()))
    return out


def jax_system():
    from chrono_tpu.dem import DEMSystem
    from chrono_tpu.utils import samplers
    sys_ = DEMSystem(radius=RADIUS, density=2500, box=BOX, rebuild_every=8,
                     max_neighbors=16)
    sys_.set_material(**MATERIAL)
    sys_.set_wall_material(**MATERIAL)
    sys_.create_particles(block(samplers))
    return sys_


def port_system(dtype):
    import torch
    from chrono_tpu_torch.dem import DEMSystem
    from chrono_tpu_torch.utils import samplers
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    sys_ = DEMSystem(radius=RADIUS, density=2500, box=BOX, rebuild_every=8,
                     max_neighbors=16, dtype=dtype, device="cpu")
    sys_.set_material(**MATERIAL)
    sys_.set_wall_material(**MATERIAL)
    sys_.create_particles(block(samplers))
    return sys_


def report(name, sys_, frames, seconds):
    print(f"{name}: {sys_.state.pos.shape[0]} particles, dt = {sys_.dt!r}, "
          f"{seconds:.1f} s")
    for t, front, ke in frames:
        print(f"  t = {t!r}  front x = {front!r}  KE = {ke!r}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also run the port in float32 and float64")
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()

    t0 = time.perf_counter()
    sys_ = jax_system()
    ref = run(sys_, args.frames)
    report("JAX demo", sys_, ref, time.perf_counter() - t0)
    print("JAX_DAM_FRONT = " + repr(tuple(f for _, f, _ in ref)))
    print("JAX_DAM_KE = " + repr(tuple(k for _, _, k in ref)))
    if not args.port:
        return
    import torch
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        sys_ = port_system(dtype)
        got = run(sys_, args.frames)
        report(f"port, {dtype}", sys_, got, time.perf_counter() - t0)
        d_front = max(abs(a[1] - b[1]) for a, b in zip(got, ref))
        r_ke = max(abs(a[2] - b[2]) / b[2] for a, b in zip(got, ref))
        print(f"port, {dtype} against JAX: front x within {d_front!r} m, "
              f"KE within {r_ke!r} relative")


if __name__ == "__main__":
    main()
