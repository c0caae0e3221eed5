"""Drive the PyTorch / CUDA port's DEM settling-box main path once on a GPU.

    python3 chip_smoke.py

Needs one CUDA card; raises without one.  It builds the two kernels of the
path from ``chrono_tpu_torch/csrc`` and then runs:

1. parity on the card: kernel K1 (``dem_substep``) against its plain twin
   on the 120-particle box after one substep and after 3 cycles, and on a
   random 64k-particle overlapping scene after one substep; kernel K2
   (``dem_migrate``) against its twin, bit for bit, over 6 cycles;
2. the main path at full size: ``bench.py``'s pinned scene (1 M spheres,
   Hertz–Mindlin with single-step friction, C = 8, 2.1 d cells, 100
   substeps per cycle, migration) for 1 warm-up and 2 timed cycles through
   ``make_cell_dense_advance``, checked for overflow, loss, finite values,
   momentum (the scene has no wall contact, so the mean velocity is pure
   free fall) and that every kernel launch of the run was counted; then
   each kernel against its twin at the main path's shapes, timed with CUDA
   events.

It prints the card's name and power limit, the build time, the errors and
times, one JSON line describing each kernel, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.dem.bc import DEMBoundaries, box_boundaries
from chrono_tpu_torch.dem.cell_dense import (
    make_cell_dense_advance, substep_coefs, to_cells,
)
from chrono_tpu_torch.dem.params import DEMMaterial, DEMParams
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda.dem_substep import (
    dem_substep, dem_substep_plain,
)
from chrono_tpu_torch.ops.cuda.migrate import dem_migrate, dem_migrate_plain
from chrono_tpu_torch.utils.samplers import grid_sample_box

DEV = torch.device("cuda", 0)
G = 9.81
# fp32 pair sums in another order: the tolerances the JAX package holds its
# own backends to (tests/test_pallas_kernel.py)
POS_TOL = dict(rtol=1e-4, atol=1e-5)
VEL_TOL = dict(rtol=1e-3, atol=1e-4)


def require(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def assert_close(got, ref, rtol, atol, what):
    """Raise unless |got − ref| ≤ atol + rtol·|ref| everywhere; return
    max |got − ref|."""
    got, ref = got.double().cpu(), ref.double().cpu()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    require(not bool(bad.any()) and bool(torch.isfinite(got).all()),
            f"{what}: {int(bad.sum())} values off, max err {float(err.max())}")
    return float(err.max())


# ---------------------------------------------------------------- scenes


def small_scene(seed, friction_mode="single_step"):
    """The 120-particle box of tests/test_pallas_kernel.py (grid (5, 4, 3),
    0.13 m cells, C = 16, 4 substeps per cycle)."""
    rng = np.random.default_rng(seed)
    dims = (5, 4, 3)
    pos = np.stack([rng.uniform(0.07, d * 0.13 - 0.07, 120) for d in dims],
                   axis=1).astype(np.float32)
    params = DEMParams(radius=0.05, mass=1.0, gravity=(0.0, 0.0, -G),
                       dt=2e-5, rebuild_every=4, friction_mode=friction_mode)
    bcs = DEMBoundaries(planes=box_boundaries(
        (0, 0, 0), tuple(d * 0.13 for d in dims)))
    return params, bcs, GridSpec(cell_size=0.13, dims=dims), pos, 16


def bench_scene(n_target=1_000_000):
    """bench.py's pinned scene (bench.py:83-158, flat engine): spheres of
    5 mm on a jittered 2.1 r lattice, cells of two lattice spacings with the
    origin at (r, r, r), z trimmed to the bed, C = 8."""
    radius = 0.005
    spacing = 2.1 * radius
    n_side = int(np.ceil(n_target ** (1 / 3)))
    box_w = n_side * spacing * 1.02
    box_h = box_w * 1.6
    mat = DEMMaterial(youngs=1e7, poisson=0.3, restitution=0.5, mu_s=0.5)
    params = DEMParams(radius=radius,
                       mass=2500.0 * 4.0 / 3.0 * np.pi * radius ** 3,
                       material=mat, wall_material=mat,
                       gravity=(0.0, 0.0, -G), dt=2e-6, rebuild_every=100,
                       friction_mode="single_step")
    bcs = DEMBoundaries(planes=box_boundaries((0, 0, 0),
                                              (box_w, box_w, box_h)))
    pts = grid_sample_box((radius,) * 3,
                          (box_w - radius, box_w - radius, box_h - radius),
                          spacing, jitter=0.03, seed=0)[:n_target]
    cell = 2.0 * spacing
    origin = (radius,) * 3
    z_hi = float(pts[:, 2].max()) + radius
    dims = tuple(int(np.ceil((e - o) / cell))
                 for e, o in zip((box_w, box_w, z_hi), origin))
    grid = GridSpec(origin=origin, cell_size=cell,
                    dims=(dims[0], dims[1], dims[2] + 1))
    return params, bcs, grid, pts.astype(np.float32), 8


def overlap_scene(n_side=40, seed=0):
    """n_side³ spheres (64k at 40) on a 2.1 r lattice jittered by ±0.2 of a
    spacing, so neighbours overlap by up to 0.74 r, with random velocities
    and spins; cells as in the bench scene (exactly 8 per cell)."""
    radius = 0.005
    spacing = 2.1 * radius
    pts = grid_sample_box((radius,) * 3, (radius + n_side * spacing,) * 3,
                          spacing, jitter=0.2, seed=seed)
    rng = np.random.default_rng(seed + 1)
    vel = rng.normal(0.0, 0.1, pts.shape)
    omega = rng.normal(0.0, 5.0, pts.shape)
    params = DEMParams(radius=radius, mass=1.3e-3, gravity=(0.0, 0.0, -G),
                       dt=2e-6, rebuild_every=1, friction_mode="single_step")
    box = radius + n_side * spacing + radius
    bcs = DEMBoundaries(planes=box_boundaries((0, 0, 0), (box,) * 3))
    grid = GridSpec(origin=(radius,) * 3, cell_size=2.0 * spacing,
                    dims=(n_side // 2,) * 3)
    return (params, bcs, grid,
            *(a.astype(np.float32) for a in (pts, vel, omega)), 8)


# ---------------------------------------------------------------- phase 1


def k1_one_substep(params, bcs, grid, pos, vel, omega, capacity):
    """One substep by K1 and by its twin from the same binned state;
    returns the max abs error over all planes."""
    field = to_cells(grid, capacity, *(torch.as_tensor(a, device=DEV)
                                       for a in (pos, vel, omega)))
    require(int(field.overflow) == 0, "scene overflows its cells")
    coefs = substep_coefs(params, bcs, grid, capacity)
    got = torch.empty_like(field.feat)
    dem_substep(field.feat, got, coefs)
    ref = dem_substep_plain(field.feat, coefs)
    vscale = max(1.0, float(ref[3:9].abs().max()))
    err = assert_close(got[0:3], ref[0:3], **POS_TOL, what="K1 pos")
    return max(err, assert_close(got[3:9], ref[3:9], rtol=1e-3,
                                 atol=1e-4 * vscale, what="K1 vel/omega"),
               assert_close(got[9], ref[9], 0, 0, what="K1 mask"))


def k1_small_substep(friction_mode):
    """K1 vs its twin on the 120-particle box with random velocities and
    spins (so friction and torques are exercised), one substep."""
    params, bcs, grid, pos, C = small_scene(7, friction_mode)
    rng = np.random.default_rng(3)
    vel = rng.normal(0.0, 0.1, pos.shape).astype(np.float32)
    omega = rng.normal(0.0, 0.5, pos.shape).astype(np.float32)
    return k1_one_substep(params, bcs, grid, pos, vel, omega, C)


def k1_three_cycles(friction_mode):
    """The whole path for 3 cycles on the card vs on the CPU (twins)."""
    params, bcs, grid, pos, C = small_scene(7, friction_mode)
    z = np.zeros_like(pos)
    card, plain = (make_cell_dense_advance(params, bcs, grid, capacity=C,
                                           device=dev)(pos, z, z, 3)
                   for dev in (DEV, torch.device("cpu")))
    require(int(card[3]) == 0 and int(plain[3]) == 0,
            "overflow in the 120-particle box")
    return max(assert_close(card[0], plain[0], **POS_TOL,
                            what="3 cycles pos"),
               *(assert_close(g, r, **VEL_TOL, what="3 cycles vel/omega")
                 for g, r in zip(card[1:3], plain[1:3])))


def k2_six_cycles():
    """K2 vs its twin on the same input after every cycle, bit for bit."""
    params, bcs, grid, pos, C = small_scene(11)
    z = torch.zeros(pos.shape, device=DEV)
    field = to_cells(grid, C, torch.as_tensor(pos, device=DEV), z, z)
    coefs = substep_coefs(params, bcs, grid, C)
    feat, ids = field.feat, field.ids
    spare = torch.empty_like(feat)
    moved = 0
    for _ in range(6):
        for _ in range(params.rebuild_every):
            dem_substep(feat, spare, coefs)
            feat, spare = spare, feat
        f2, i2 = torch.empty_like(feat), torch.empty_like(ids)
        count = torch.empty(grid.n_cells, dtype=torch.int32, device=DEV)
        dem_migrate(feat, ids, f2, i2, count, grid)
        rf, ri, rc = dem_migrate_plain(feat, ids, grid)
        require(torch.equal(f2, rf) and torch.equal(i2, ri)
                and torch.equal(count, rc), "K2 differs from its twin")
        require(int(count.max()) <= C and int((f2[9] > 0.5).sum()) == 120,
                "K2 lost or overflowed particles")
        moved += int((ids != i2).any(dim=1).sum())
        feat, ids = f2, i2
    require(moved > 0, "no particle changed cell in 6 cycles")
    return moved


# ---------------------------------------------------------------- phase 2


def cuda_ms(fn, reps):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_path(card):
    params, bcs, grid, pos, C = bench_scene()
    n = len(pos)
    print(f"main path: {n} particles, grid {grid.dims} "
          f"({grid.n_cells} cells x C={C}), rebuild_every "
          f"{params.rebuild_every}, dt {params.dt}")
    adv = make_cell_dense_advance(params, bcs, grid, capacity=C,
                                  migrate=True, device=DEV)
    z = np.zeros_like(pos)
    dem_substep.launches = dem_migrate.launches = 0
    p, v, o, ovf = adv(pos, z, z, 1)                       # warm-up cycle
    require(int(ovf) == 0, f"warm-up overflow {int(ovf)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, v, o, ovf = adv(p, v, o, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dem_substep": dem_substep.launches,
                "dem_migrate": dem_migrate.launches}
    require(int(ovf) == 0, f"overflow or loss {int(ovf)}")
    require(all(bool(torch.isfinite(a).all()) for a in (p, v, o)),
            "non-finite state")
    require(launches == {"dem_substep": 300, "dem_migrate": 3},
            f"launch counts {launches}")
    # no particle touches a wall in this horizon, so contact forces cancel
    # pairwise and the mean velocity is free fall: −g·t on z
    t_sim = 3 * params.rebuild_every * params.dt
    mean_v = v.double().mean(0).cpu()
    require(abs(float(mean_v[2]) / (-G * t_sim) - 1) < 1e-3
            and float(mean_v[:2].abs().max()) < 1e-3 * G * t_sim,
            f"momentum off: mean v {mean_v.tolist()} vs -g t {-G * t_sim}")
    steps = 2 * params.rebuild_every
    print(f"main path: ovf 0, launches {launches}, mean v "
          f"{mean_v.tolist()} (free fall {-G * t_sim:.6e})")
    print(f"main path: {steps} substeps of {n} particles in {wall:.4f} s = "
          f"{n * steps / wall:.6e} particle-steps/s (bin, 200 substeps, "
          f"2 migrations, unbin; host clock) on {card}")

    # each kernel against its twin at the main path's shapes
    field = to_cells(grid, C, p, v, o)
    coefs = substep_coefs(params, bcs, grid, C)
    out = torch.empty_like(field.feat)
    dem_substep(field.feat, out, coefs)
    ref = dem_substep_plain(field.feat, coefs)
    k1_err = max(assert_close(out[0:3], ref[0:3], **POS_TOL,
                              what="K1 pos at 1M"),
                 assert_close(out[3:9], ref[3:9], **VEL_TOL,
                              what="K1 vel/omega at 1M"))
    del ref
    k1_ms = cuda_ms(lambda: dem_substep(field.feat, out, coefs), 20)
    k1_plain_ms = cuda_ms(lambda: dem_substep_plain(field.feat, coefs), 3)

    ids2 = torch.empty_like(field.ids)
    count = torch.empty(grid.n_cells, dtype=torch.int32, device=DEV)
    mig_out = torch.empty_like(out)
    dem_migrate(out, field.ids, mig_out, ids2, count, grid)
    rf, ri, rc = dem_migrate_plain(out, field.ids, grid)
    require(torch.equal(mig_out, rf) and torch.equal(ids2, ri)
            and torch.equal(count, rc), "K2 differs from its twin at 1M")
    k2_err = float((mig_out - rf).abs().max())
    del rf, ri, rc
    k2_ms = cuda_ms(lambda: dem_migrate(out, field.ids, mig_out, ids2,
                                        count, grid), 20)
    k2_plain_ms = cuda_ms(lambda: dem_migrate_plain(out, field.ids, grid), 3)
    print(f"K1 at 1M: max abs err {k1_err:.3e}, {k1_ms:.4f} ms "
          f"(plain twin {k1_plain_ms:.4f} ms)")
    print(f"K2 at 1M: bit-exact (max abs err {k2_err}), {k2_ms:.4f} ms "
          f"(plain twin {k2_plain_ms:.4f} ms)")
    return [
        {"name": "dem_substep", "route": "cuda",
         "source": "chrono_tpu_torch/csrc/dem_substep.cu",
         "replaces": "chrono_tpu/ops/pallas/dem_flat_kernel.py:169",
         "launches": launches["dem_substep"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "dem_migrate", "route": "cuda",
         "source": "chrono_tpu_torch/csrc/migrate.cu",
         "replaces": "chrono_tpu/ops/pallas/migrate_kernel.py:130",
         "launches": launches["dem_migrate"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]


def main():
    require(torch.cuda.is_available(), "chip_smoke.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    for name in ("dem_substep", "migrate"):
        _build.load(name)
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in ("dem_substep", "migrate"):
        for line in (_build.BUILD_DIR / f"{name}.log").read_text() \
                .splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # phase 1: parity on the card
    for mode in ("frictionless", "single_step"):
        print(f"K1 vs twin, 120 particles, 1 substep, {mode}: "
              f"max abs err {k1_small_substep(mode):.3e}")
        print(f"K1 vs twin, 120 particles, 3 cycles, {mode}: "
              f"max abs err {k1_three_cycles(mode):.3e}")
    print(f"K1 vs twin, 64000 overlapping particles, 1 substep: max abs "
          f"err {k1_one_substep(*overlap_scene()):.3e}")
    print(f"K2 vs twin, 6 cycles: bit-exact "
          f"({k2_six_cycles()} cells changed occupants)")

    # phase 2: the main path at full size
    kernels = main_path(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
