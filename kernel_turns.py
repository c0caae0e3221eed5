"""Time K2 and NSC detection against an earlier commit's, in turns, on one
CUDA card, and hold the main paths' final states and rates to the earlier
tree's.

    mkdir -p _checkout/<commit>
    git archive <commit> | tar -x -C _checkout/<commit>
    python3 kernel_turns.py _checkout/<commit>

The earlier commit's ``csrc/migrate.cu`` and ``csrc/nsc_detect.cu`` are
built with nvcc into ``chrono_tpu_torch/_build/turns`` and bound through
ctypes at the launcher signatures they had at commit be92341 (K2 on slot
planes; detection with one thread a body and no lane count); this tree's
kernels run through the port's wrappers.  Then:

- K2 on ``chip_smoke.py``'s settling box after one cycle of K1 on the
  binned rows, as phase 2 times it: the earlier path (the rows scattered
  to slot planes, the earlier ``dem_migrate``, rows of its output), the
  earlier kernel alone on those planes, and this ``dem_migrate_rows``, in
  turns (3 rounds): CUDA events over 20 calls, and for the two kernels the
  profiler's device time per call over 20 calls, and this kernel's three
  launches apart; this tree's rows, ids and landing counts against the
  earlier path's, bit for bit.
- NSC detection on the bladed mixer at 400,000 and 40,000 spheres after as
  many steps as phase 8 runs before its twin checks: the earlier kernel
  and this one at 1, 2, 4 and 8 lanes a body, in turns (3 rounds),
  by the profiler's device time per launch over 200 launches; every
  partner table and count against the earlier kernel's, bit for bit.
- End to end, each tree in a process of its own (earlier, this, this,
  earlier, then this, earlier, earlier, this): the settling box (1 warm-up
  and 2 timed cycles, as phase 2), then the mixer at 40,000 spheres (25 +
  25 steps, as phase 8) and at 400,000 (2 + 20 steps); each run's rate on
  the host clock after a synchronize, and a digest of its final state.

It prints the card's name and power limit first.  It needs the card; it
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from chrono_tpu_torch.dem.cell_dense import substep_coefs, to_cells
from chrono_tpu_torch.dem.rows import rows_from_prefix_slots, rows_to_planes
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda import migrate as mig
from chrono_tpu_torch.ops.cuda import nsc_detect as nd
from chrono_tpu_torch.ops.cuda.dem_substep import dem_substep_rows
from chrono_tpu_torch.solver.nsc_pencil import make_nsc_pencil_advance

ROOT = Path(__file__).resolve().parent
OUT = _build.BUILD_DIR / "turns"
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
TAIL = [P_, I_]                              # stream, device
ROUNDS = 3              # of the kernels in turns
TREE_ROUNDS = 2         # of four runs: earlier, this, this, earlier
LANES = (1, 2, 4, 8)
KERNEL_SOURCES = ("dem_substep", "migrate", "nsc_detect", "nsc_sweep")

# the main paths' rates and final states, run from a tree's root
RUN = """
import hashlib, time
import numpy as np, torch
import chip_smoke as cs
from chrono_tpu_torch.dem.cell_dense import make_cell_dense_advance
from chrono_tpu_torch.solver.nsc_pencil import make_nsc_pencil_advance


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


params, bcs, grid, pos, C = cs.bench_scene()
adv = make_cell_dense_advance(params, bcs, grid, capacity=C, migrate=True,
                              device=cs.DEV)
z = np.zeros_like(pos)
p, v, o, ovf = adv(pos, z, z, 1)
torch.cuda.synchronize()
t0 = time.perf_counter()
p, v, o, ovf = adv(p, v, o, 2)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
cs.require(int(ovf) == 0, "settling box overflow")
print("settle", len(pos) * 2 * params.rebuild_every / wall, digest(p, v, o))
for n_target, warm, steps in ((40_000, 25, 25), (400_000, 2, 20)):
    pm, grid, walls, pts, spin = cs.mixer_scene(n_target)
    adv = make_nsc_pencil_advance(pm, grid, walls, partners=6, device=cs.DEV)
    out, wall = cs.nsc_run(adv, pts, warm, steps, warm * pm.dt * spin)
    cs.require(int(out[3]) == 0, "mixer overflow")
    print(f"mixer{n_target}", pm.n_iter * steps / wall, digest(*out[:3]))
"""


def build(earlier: Path):
    """The earlier commit's two kernel libraries, built at once:
    ``{name: CDLL}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
         str(earlier / "chrono_tpu_torch" / "csrc" / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("migrate", "nsc_detect")}
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


def device_ms(fn, reps, per_call=1):
    """Mean device ms per call of fn (``per_call`` kernels) over ``reps``
    calls, from the profiler's events; fails unless it saw every launch."""
    fn()
    _, events = cs.device_events(lambda: [fn() for _ in range(reps)])
    cs.require(len(events) == reps * per_call,
               f"{len(events)} device events over {reps} calls of "
               f"{per_call} kernels")
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def in_turns(runs, rounds, timer):
    """Each of ``runs`` (label: fn) timed ``rounds`` times by ``timer``,
    the order reversed every other round: ``{label: [ms, ...]}``."""
    times = {label: [] for label in runs}
    for r in range(rounds):
        for label in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[label].append(timer(label, runs[label]))
    torch.cuda.synchronize()
    return times


def print_times(times):
    for label, ts in times.items():
        print(f"  {label}: " + ", ".join(f"{t:.4f}" for t in ts))


def migrate_turns(libs, rounds):
    params, bcs, grid, pos, C = cs.bench_scene()
    z = np.zeros_like(pos)
    field = to_cells(grid, C, *(torch.as_tensor(a, device=cs.DEV)
                                for a in (pos, z, z)))
    rows0, ids = cs.rows_and_ids(field, len(pos))
    coefs = substep_coefs(params, bcs, grid, C)
    state, spare = rows0.state, torch.zeros_like(rows0.state)
    for _ in range(params.rebuild_every):
        dem_substep_rows(replace(rows0, state=state), spare, coefs)
        state, spare = spare, state
    rows = replace(rows0, state=state)
    earlier = bind(libs["migrate"], "dem_migrate",
                   [P_] * 5 + [I_, ctypes.POINTER(mig._MigrateParams)]
                   + TAIL)
    params_c = mig._params(grid, C)
    n_rows = rows.n_rows
    _, row_of_slot = rows_from_prefix_slots(field.feat, rows.table[:, 1],
                                            n_rows)
    feat = field.feat.clone()
    feat[0:9] = rows_to_planes(rows.state, row_of_slot).reshape(
        9, *feat.shape[1:])
    moved, moved_ids = torch.empty_like(feat), torch.empty_like(field.ids)
    landed = torch.empty(grid.n_cells, dtype=torch.int32, device=cs.DEV)

    def run_earlier_kernel():
        err = earlier(feat.data_ptr(), field.ids.data_ptr(),
                      moved.data_ptr(), moved_ids.data_ptr(),
                      landed.data_ptr(), grid.n_cells,
                      ctypes.byref(params_c), stream(), 0)
        cs.require(err == 0, f"the earlier K2: cudaError {err}")

    def run_earlier_path():
        _, ros = rows_from_prefix_slots(feat, rows.table[:, 1], n_rows)
        feat[0:9] = rows_to_planes(rows.state, ros).reshape(
            9, *feat.shape[1:])
        run_earlier_kernel()
        out, ros = rows_from_prefix_slots(moved, landed, n_rows)
        out_ids = torch.full((n_rows,), -1, dtype=torch.int32,
                             device=cs.DEV)
        out_ids[ros] = moved_ids.reshape(-1)
        return out, out_ids, landed.clone()

    runs = {"earlier path (planes, earlier K2, rows)": run_earlier_path,
            "earlier K2 alone": run_earlier_kernel,
            "dem_migrate_rows": lambda: cs.k2_rows_run(rows, ids, grid, C)}
    kernels = {"earlier K2 alone": 1, "dem_migrate_rows": 3}
    events = in_turns(runs, rounds, lambda label, fn: cs.cuda_ms(fn, 20))
    device = in_turns({k: runs[k] for k in kernels}, rounds,
                      lambda label, fn: device_ms(fn, 20, kernels[label]))
    by_name = cs.profile_call("20 calls of dem_migrate_rows", lambda: [
        cs.k2_rows_run(rows, ids, grid, C) for _ in range(20)])[0]
    got, ref = cs.k2_rows_run(rows, ids, grid, C), run_earlier_path()
    bad = cs.k2_rows_differ(got, ref)
    print(f"K2 on the settling box's rows after one cycle ({n_rows - 1} "
          f"particles, {grid.n_cells} cells); ms a call by CUDA events "
          f"over 20 calls, {rounds} rounds in turns:")
    print_times(events)
    print("  device ms a call (profiler, 20 calls):")
    print_times(device)
    print("  dem_migrate_rows by kernel, device ms a call: " + ", ".join(
        f"{name.split('(')[0]} {ms / 20:.4f}"
        for name, ms in by_name.items()))
    print("  dem_migrate_rows against the earlier path: "
          + (f"{', '.join(bad)} differ" if bad else "bit for bit"))


def detect_turns(libs, n_target, rounds, steps):
    p, grid, walls, pts, spin = cs.mixer_scene(n_target)
    adv = make_nsc_pencil_advance(p, grid, walls, partners=6, device=cs.DEV)
    z = np.zeros_like(pts)
    pos, vel, om = adv(pts, z, z, steps)[:3]
    pos_s, _, cells, _ = cs.nsc_bin(grid, pos, vel, om, p)
    dc = nd.DetectConsts.of(p.radius, p.envelope)
    n, P = pos_s.shape[1], 6
    earlier = bind(libs["nsc_detect"], "nsc_detect",
                   [P_] * 6 + [I_] * 5 + [F_] * 2 + TAIL)
    outs = {}

    def run_earlier():
        part, count = outs.setdefault("earlier", (
            torch.empty((n, P), dtype=torch.int32, device=cs.DEV),
            torch.empty(n, dtype=torch.int32, device=cs.DEV)))
        err = earlier(pos_s.data_ptr(), cells.cell.data_ptr(),
                      cells.start.data_ptr(), cells.count.data_ptr(),
                      part.data_ptr(), count.data_ptr(), n, *cells.dims, P,
                      dc.two_r, dc.envelope, stream(), 0)
        cs.require(err == 0, f"the earlier detect: cudaError {err}")

    def run(lanes):
        part, count = outs.setdefault(lanes, (
            torch.empty((n, P), dtype=torch.int32, device=cs.DEV),
            torch.empty(n, dtype=torch.int32, device=cs.DEV)))
        return lambda: nd._launch(pos_s, cells, P, dc, part, count, lanes)

    runs = {"earlier": run_earlier,
            **{f"{lanes} lanes": run(lanes) for lanes in LANES}}
    times = in_turns(runs, rounds, lambda label, fn: device_ms(fn, 200))
    ref = outs["earlier"]
    print(f"NSC detect at {n} spheres ({int(ref[1].sum())} contacts, "
          f"most {int(ref[1].max())} a body, P = {P}); device ms a launch "
          f"over 200 launches, {rounds} rounds in turns "
          f"(the wrapper takes {nd.lanes_for(n, cs.DEV)} lanes here):")
    print_times(times)
    for lanes in LANES:
        part, count = outs[lanes]
        same = torch.equal(part, ref[0]) and torch.equal(count, ref[1])
        print(f"  {lanes} lanes: partners and counts "
              + ("equal the earlier kernel's" if same else "DIFFER"))
        cs.require(same, f"detect with {lanes} lanes differs")


def prebuild(root: Path):
    """Build a tree's kernel libraries in a process of its own, so that
    no timed run builds."""
    run = subprocess.run(
        [sys.executable, "-c", "from chrono_tpu_torch.ops.cuda import "
         f"_build; _build.build_all({list(KERNEL_SOURCES)!r})"],
        cwd=root, capture_output=True, text=True, timeout=600)
    cs.require(run.returncode == 0, f"building {root}:\n{run.stderr}")


def tree_turns(earlier: Path, rounds):
    """Each tree's settling box and mixers, a process each, in turns."""
    results = {"earlier": [], "this": []}
    for r in range(rounds):
        for tree in (("earlier", "this", "this", "earlier") if r % 2 == 0
                     else ("this", "earlier", "earlier", "this")):
            run = subprocess.run(
                [sys.executable, "-c", RUN],
                cwd=earlier if tree == "earlier" else ROOT,
                capture_output=True, text=True, timeout=900)
            cs.require(run.returncode == 0,
                       f"the {tree} tree's run failed:\n{run.stderr}")
            results[tree].append(dict(
                (line.split()[0], (float(line.split()[1]), line.split()[2]))
                for line in run.stdout.splitlines()
                if line.split()[:1] in (["settle"], ["mixer40000"],
                                        ["mixer400000"])))
    units = {"settle": "particle-steps/s", "mixer40000": "DVI iterations/s",
             "mixer400000": "DVI iterations/s"}
    for key, unit in units.items():
        print(f"{key}, {unit} in turns, a process a run:")
        for tree, runs in results.items():
            print(f"  {tree} tree: "
                  + ", ".join(f"{run[key][0]:.6e}" for run in runs))
        digests = {tree: sorted({run[key][1] for run in runs})
                   for tree, runs in results.items()}
        same = digests["earlier"] == digests["this"] \
            and len(digests["this"]) == 1
        print("  final state: "
              + (f"one digest over both trees, bit for bit "
                 f"({digests['this'][0][:16]})" if same else
                 "; ".join(f"{tree} tree {', '.join(d)}"
                           for tree, d in digests.items())))


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
    _build.build_all(KERNEL_SOURCES)
    migrate_turns(libs, ROUNDS)
    # as many steps as phase 8 runs before its twin checks
    detect_turns(libs, 400_000, ROUNDS, 22)
    detect_turns(libs, 40_000, ROUNDS, 50)
    prebuild(earlier)
    tree_turns(earlier, TREE_ROUNDS)


if __name__ == "__main__":
    main()
