"""Time the NSC sweep U, the SPH sweep A and the 400,000-sphere mixer
against an earlier commit's, in turns, on one CUDA card.

    mkdir -p _checkout/<commit>
    git archive <commit> | tar -x -C _checkout/<commit>
    python3 kernel_turns.py _checkout/<commit>

The earlier commit's ``csrc/nsc_sweep.cu`` and ``csrc/sph_substep.cu`` are
built with nvcc into ``chrono_tpu_torch/_build/turns`` and bound through
ctypes at the launcher signatures they had before U took wall masks and A a
thread order (commit ccc9a6c); this tree's kernels run through the port's
wrappers.  Then:

- NSC U on the bladed mixer of ``chip_smoke.py`` at 400,000 and 40,000
  spheres, after as many steps as phase 8 runs before its twin checks,
  with phase 8's random multipliers on the detected contacts: the earlier
  U, and this U reading the wall masks and writing them, in turns (3
  rounds), each timed by the profiler's device time per launch over 200
  launches; the u values that differ from the earlier U's are counted.
- SPH A on the dam break of ``chip_smoke.py`` after one cycle, rebinned:
  the earlier A and this A (its thread order made once, as the advance
  makes it), in turns, by device time per launch over 20 launches; the
  values that differ from the earlier A's are counted.
- The 400,000-sphere mixer end to end: each tree's
  ``make_nsc_pencil_advance`` in a process of its own (earlier, this,
  this, earlier, then this, earlier, earlier, this), 2 warm-up and 40
  timed steps; DVI iterations per second on the host clock after a
  synchronize.

It prints the card's name and power limit first.  It needs the card; it
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from chrono_tpu_torch.fsi.sph.pencil import (
    make_sph_advance_pencil, state_to_cells,
)
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda import nsc_sweep as ns
from chrono_tpu_torch.ops.cuda import sph_substep as sph
from chrono_tpu_torch.solver.nsc_pencil import (
    make_nsc_pencil_advance, nsc_static_params,
)

ROOT = Path(__file__).resolve().parent
OUT = _build.BUILD_DIR / "turns"
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
TAIL = [P_, I_]                              # stream, device
ROUNDS = 3              # of the kernels in turns
MIXER_ROUNDS = 2        # of four mixer runs: earlier, this, this, earlier
MIXER_STEPS = 40        # timed, after 2 warm-up steps

# the 400,000-sphere mixer's rate, run from a tree's root
MIXER = """
import chip_smoke as cs
from chrono_tpu_torch.solver.nsc_pencil import make_nsc_pencil_advance
p, grid, walls, pts, spin = cs.mixer_scene(400_000)
adv = make_nsc_pencil_advance(p, grid, walls, partners=6, device=cs.DEV)
out, wall = cs.nsc_run(adv, pts, 2, {steps}, 2 * p.dt * spin)
cs.require(int(out[3]) == 0, "overflow")
print("rate", p.n_iter * {steps} / wall)
"""


def build(earlier: Path):
    """The earlier commit's two kernel libraries, built at once:
    ``{name: CDLL}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
         str(earlier / "chrono_tpu_torch" / "csrc" / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("nsc_sweep", "sph_substep")}
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the earlier {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def bind(lib, name, argtypes):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream():
    return torch.cuda.current_stream().cuda_stream


def device_us(fn, reps):
    """Mean device µs per launch of fn's one kernel over ``reps`` calls,
    from the profiler's events; fails unless it saw every launch."""
    fn()
    _, events = cs.device_events(lambda: [fn() for _ in range(reps)])
    names = {e.name for e in events}
    cs.require(len(names) == 1 and len(events) == reps,
               f"{len(events)} device events of {len(names)} kernels over "
               f"{reps} calls")
    return sum(e.time_range.elapsed_us() for e in events) / len(events)


def in_turns(runs, rounds, reps):
    """Each of ``runs`` (label: fn) timed ``rounds`` times, the order
    reversed every other round: ``{label: [ms, ...]}``."""
    times = {label: [] for label in runs}
    for r in range(rounds):
        for label in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[label].append(device_us(runs[label], reps) / 1e3)
    torch.cuda.synchronize()
    return times


def print_times(times):
    for label, ts in times.items():
        print(f"  {label}: " + ", ".join(f"{t:.4f}" for t in ts))


def nsc_turns(libs, n_target, rounds, steps):
    p, grid, walls, pts, spin = cs.mixer_scene(n_target)
    adv = make_nsc_pencil_advance(p, grid, walls, partners=6, device=cs.DEV)
    z = np.zeros_like(pts)
    pos, vel, om = adv(pts, z, z, steps)[:3]
    pos_s, ufree, cells, _ = cs.nsc_bin(grid, pos, vel, om, p)
    c = nsc_static_params(p, walls)
    pose = cs.nsc_blade_cs(walls, steps * p.dt * spin)
    _, inp = cs.nsc_kernels_vs_twins(pos_s, ufree, cells, c, pose, 6,
                                     f"turns {n_target}")
    n, P = inp["part"].shape
    a = (inp["gam"], inp["gprev"], inp["wgam"], inp["wgprev"], inp["beta"])
    earlier = bind(libs["nsc_sweep"], "nsc_sweep_u",
                   [P_] * 12 + [I_, I_, F_, P_] + TAIL)
    outs = {key: torch.empty_like(ufree)
            for key in ("earlier", "reading", "writing")}
    masks = inp["masks"].clone()

    def run_earlier():
        err = earlier(*(t.data_ptr() for t in (
            pos_s, ufree, *a[:4], inp["part"], inp["rev"].start,
            inp["rev"].count, inp["rev"].entry, pose, outs["earlier"])),
            n, P, inp["beta"], ctypes.byref(c.kernel_params), stream(), 0)
        cs.require(err == 0, f"the earlier U: cudaError {err}")

    def run(mode):
        return lambda: ns.nsc_sweep_u(pos_s, ufree, *a, inp["part"],
                                      inp["rev"], pose, c, outs[mode], masks,
                                      write=mode == "writing")

    times = in_turns({"earlier U": run_earlier,
                      "U reading": run("reading"),
                      "U writing": run("writing")}, rounds, 200)
    print(f"NSC U at {n} spheres, {int((inp['part'] >= 0).sum())} "
          f"contacts, {int(masks.bool().sum())} bodies within a wall's "
          f"reach; device ms per launch over {rounds} rounds in turns:")
    print_times(times)
    ref = outs["earlier"]
    for mode in ("reading", "writing"):
        _, ratio = cs.nsc_u_close(outs[mode], ref, f"U {mode}")
        print(f"  U {mode}: {int((outs[mode] != ref).sum())} of "
              f"{ref.numel()} u values differ from the earlier U's, at "
              f"{ratio:.4f} of phase 8's tolerance")


def sph_turns(libs, n_target, rounds):
    params, grid, state, C = cs.dam_scene(n_target)
    adv = make_sph_advance_pencil(params, grid, capacity=C, device=cs.DEV)
    st, ovf = adv(state, 1)
    cs.require(int(ovf) == 0, "dam overflow")
    c = sph.sph_static_params(params)
    feat, _, cells, _ = state_to_cells(grid, C, st, c)
    n = feat.shape[1]
    order = sph.adami_walk_order(feat, cells)
    earlier = bind(libs["sph_substep"], "sph_adami",
                   [P_] * 5 + [I_] * 5 + [P_] + TAIL)
    outs = {key: feat.new_empty((sph.N_ADAMI, n)) for key in ("earlier", "A")}

    def run_earlier():
        err = earlier(feat.data_ptr(), cells.cell.data_ptr(),
                      cells.start.data_ptr(), cells.count.data_ptr(),
                      outs["earlier"].data_ptr(), n, *cells.dims, C,
                      ctypes.byref(c.kernel_params), stream(), 0)
        cs.require(err == 0, f"the earlier A: cudaError {err}")

    times = in_turns({"earlier A": run_earlier,
                      "A": lambda: sph.sph_adami(feat, cells, c, outs["A"],
                                                 order)}, rounds, 20)
    live = (torch.arange(n, device=cs.DEV)
            - cells.start.long()[cells.cell.long()] < C)
    walkers = int(((feat[sph.FLU] < 0.5) & live).sum())
    print(f"SPH A at {n} markers ({walkers} live solids walking); device ms "
          f"per launch over {rounds} rounds in turns:")
    print_times(times)
    ref = outs["earlier"]
    print(f"  A: {int((outs['A'] != ref).sum())} of {ref.numel()} values "
          "differ from the earlier A's")


def mixer_turns(earlier: Path, rounds, steps):
    """The 400,000-sphere mixer's rate from each tree, a process each."""
    rates = {"earlier": [], "this": []}
    for r in range(rounds):
        for tree in (("earlier", "this", "this", "earlier") if r % 2 == 0
                     else ("this", "earlier", "earlier", "this")):
            root = earlier if tree == "earlier" else ROOT
            run = subprocess.run(
                [sys.executable, "-c", MIXER.format(steps=steps)],
                cwd=root, capture_output=True, text=True, timeout=600)
            cs.require(run.returncode == 0,
                       f"the {tree} tree's mixer failed:\n{run.stderr}")
            rate = next(float(line.split()[1]) for line in
                        run.stdout.splitlines() if line.startswith("rate "))
            rates[tree].append(rate)
    print(f"NSC mixer at 400,000 spheres, {steps} timed steps a process, "
          "DVI iterations/s in turns:")
    for tree, rs in rates.items():
        print(f"  {tree} tree: " + ", ".join(f"{x:.6e}" for x in rs))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", type=Path, help="an unpacked earlier commit")
    earlier = ap.parse_args().earlier.resolve()
    cs.require(torch.cuda.is_available(), "kernel_turns.py needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    libs = build(earlier)
    # as many steps as phase 8 runs before its twin checks
    nsc_turns(libs, 400_000, ROUNDS, 22)
    nsc_turns(libs, 40_000, ROUNDS, 50)
    sph_turns(libs, 1_000_000, ROUNDS)
    mixer_turns(earlier, MIXER_ROUNDS, MIXER_STEPS)


if __name__ == "__main__":
    main()
