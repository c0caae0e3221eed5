"""The port's CUDA kernels against their plain PyTorch twins.

Tests marked ``cuda`` need a CUDA card and skip without one; they make the
same checks as phases 1 and 3 of ``chip_smoke.py``.  Run them on the card with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``: the
machine with the card has no JAX, which ``tests/conftest.py`` imports.
The others run anywhere: the package imports and runs its twins without a
CUDA compiler.
"""

import pkgutil
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import chrono_tpu_torch
from chrono_tpu_torch.dem.cell_dense import (
    pair_coefs, substep_coefs, to_cells, to_rows,
)
from chrono_tpu_torch.fsi.sph.pencil import state_to_cells
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda import crm_substep as crm
from chrono_tpu_torch.ops.cuda import nsc_detect as nd
from chrono_tpu_torch.ops.cuda import nsc_sweep as ns
from chrono_tpu_torch.ops.cuda import sph_substep as sph
from chrono_tpu_torch.ops.cuda.dem_forces import (
    dem_forces, dem_forces_rows, dem_forces_rows_plain,
)
from chrono_tpu_torch.ops.cuda.dem_substep import (
    dem_substep, dem_substep_rows, dem_substep_rows_plain,
)
from chrono_tpu_torch.ops.cuda.migrate import dem_migrate, dem_migrate_rows

SPH_SWEEPS = ("sph_adami", "sph_momentum", "sph_continuity_drift")
CRM_KERNELS = ("crm_momentum", "crm_gradv_stress", "crm_outer_substeps")
NSC_KERNELS = (nd.nsc_detect, ns.nsc_sweep_u, ns.nsc_sweep_g)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    return chip_smoke


def test_package_imports_without_building(monkeypatch):
    """Every module imports, no module imports JAX or the JAX package, the
    kernel sources are in the package, and CPU tensors run the twins
    without touching the build."""
    names = [m.name for m in pkgutil.walk_packages(
        chrono_tpu_torch.__path__, "chrono_tpu_torch.")]
    probe = subprocess.run(
        [sys.executable, "-c",
         f"import sys, importlib\nfor n in {names!r}: "
         "importlib.import_module(n)\n"
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'chrono_tpu')))"],
        capture_output=True, text=True, check=True, timeout=120,
        cwd=Path(chrono_tpu_torch.__file__).parents[1])
    assert probe.stdout.strip() == "[]"
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "dem_substep.cu", "migrate.cu", "sph_substep.cu", "crm_substep.cu",
        "crm_outer.cu", "nsc_detect.cu", "nsc_sweep.cu", "dem_forces.cu"}
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {
        "cell_pairs.cuh", "crm_sweeps.cuh", "nsc_pair.cuh", "dem_pairs.cuh"}

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    from chip_smoke import small_scene
    params, bcs, grid, pos, C = small_scene(7)
    z = torch.zeros(pos.shape)
    field = to_cells(grid, C, torch.from_numpy(pos), z, z)
    out = torch.empty_like(field.feat)
    launches = (dem_substep_rows.launches, dem_migrate.launches,
                dem_forces_rows.launches)
    dem_substep(field.feat, out, substep_coefs(params, bcs, grid, C))
    count = torch.empty(grid.n_cells, dtype=torch.int32)
    dem_migrate(out, field.ids, torch.empty_like(out),
                torch.empty_like(field.ids), count, grid)
    forces = torch.empty((6,) + tuple(field.feat.shape[1:]))
    dem_forces(field.feat, forces, pair_coefs(params, grid, C))
    assert (dem_substep_rows.launches, dem_migrate.launches,
            dem_forces_rows.launches) == launches
    assert int(count.sum()) == len(pos)
    assert float(forces[0:3].abs().max()) > 0


def test_other_devices_raise():
    from chip_smoke import small_scene
    params, bcs, grid, _, C = small_scene(7)
    n = grid.n_cells
    feat = torch.empty((10, n, C), device="meta")
    ids = torch.empty((n, C), dtype=torch.int32, device="meta")
    count = torch.empty((n,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        dem_substep(feat, torch.empty_like(feat),
                    substep_coefs(params, bcs, grid, C))
    with pytest.raises(ValueError):
        dem_migrate(feat, ids, torch.empty_like(feat), torch.empty_like(ids),
                    count, grid)
    with pytest.raises(ValueError):
        dem_forces(feat, torch.empty((6, n, C), device="meta"),
                   pair_coefs(params, grid, C))


@pytest.mark.cuda
@pytest.mark.parametrize("friction_mode", ["frictionless", "single_step"])
def test_substep_kernel_matches_twin(card, friction_mode):
    n = dem_substep_rows.launches
    assert card.k1_small_substep(friction_mode) < 1e-3
    assert card.k1_three_cycles(friction_mode) < 1e-3
    assert dem_substep_rows.launches > n


@pytest.mark.cuda
def test_substep_kernel_matches_twin_overlapping(card):
    assert np.isfinite(card.k1_one_substep(*card.overlap_scene(n_side=20)))


@pytest.mark.cuda
def test_forces_kernel_matches_twin(card):
    """``dem_forces`` against its twin on the 120-particle box (both
    friction modes) and the forces path on the five-kind scene, card
    against CPU, as phase 9 of chip_smoke.py checks them; and its input
    checks."""
    n = dem_forces_rows.launches
    for mode in ("frictionless", "single_step"):
        assert card.forces_small(mode)[1] <= 1.0
    assert card.forces_path_three_cycles() < 1e-3
    assert dem_forces_rows.launches > n
    params, bcs, grid, pos, C = card.small_scene(7)
    z = torch.zeros(pos.shape, device="cuda")
    feat = to_cells(grid, C, torch.as_tensor(pos, device="cuda"), z, z).feat
    pair = pair_coefs(params, grid, C)
    with pytest.raises(ValueError):               # out overlaps feat
        dem_forces(feat, feat[:6], pair)
    with pytest.raises(ValueError):               # wrong dtype
        dem_forces(feat.double(), torch.empty_like(feat[:6]), pair)
    with pytest.raises(ValueError):               # wrong plane count
        dem_forces(feat, torch.empty_like(feat), pair)


def _row_scenes(card):
    """The 8,000-sphere overlapping scene and the 120-particle box with
    random velocities and spins, as rows on the card:
    ``(params, bcs, grid, C, rows)`` each."""
    params, bcs, grid, pos, vel, omega, C = card.overlap_scene(n_side=20)
    yield params, bcs, grid, C, (pos, vel, omega)
    params, bcs, grid, pos, C = card.small_scene(7)
    rng = np.random.default_rng(3)
    yield params, bcs, grid, C, (pos, rng.normal(0, 0.1, pos.shape),
                                 rng.normal(0, 0.5, pos.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dem_substep", "dem_forces"])
def test_row_kernels_match_twins(card, kernel):
    """K1 and ``dem_forces`` on cell-sorted rows against their row twins,
    at the tolerances of tests/test_pallas_kernel.py; two launches give the
    same bits."""
    for params, bcs, grid, C, state in _row_scenes(card):
        rows = to_rows(grid, C, *(torch.as_tensor(a, dtype=torch.float32,
                                                  device="cuda")
                                  for a in state))[0]
        if kernel == "dem_substep":
            c = substep_coefs(params, bcs, grid, C)
            out = torch.zeros_like(rows.state)
            launch, ref = dem_substep_rows, dem_substep_rows_plain(rows, c)
        else:
            c = pair_coefs(params, grid, C)
            out = rows.state.new_empty((2, rows.n_rows, 4))
            launch, ref = dem_forces_rows, dem_forces_rows_plain(rows, c)
        n = launch.launches
        got = []
        for _ in range(2):
            launch(rows, out, c)
            got.append(out.clone())
        torch.cuda.synchronize()
        assert launch.launches == n + 2
        assert all(torch.equal(g, got[0]) for g in got[1:])
        live = rows.cell >= 0
        got, ref = got[0][:, live, :3], ref[:, live, :3]
        if kernel == "dem_substep":
            vscale = max(1.0, float(ref[1:3].abs().max()))
            torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(got[1:3], ref[1:3], rtol=1e-3,
                                       atol=1e-4 * vscale)
        else:
            f_scale = float(ref[0].abs().max())
            assert f_scale > 0
            t_atol = 1e-5 * max(float(ref[1].abs().max()),
                                params.radius * f_scale)
            torch.testing.assert_close(got[0], ref[0], rtol=1e-4,
                                       atol=1e-5 * f_scale)
            torch.testing.assert_close(got[1], ref[1], rtol=1e-4,
                                       atol=t_atol)


@pytest.mark.cuda
def test_row_wrappers_check_inputs(card):
    params, bcs, grid, pos, C = card.small_scene(7)
    z = torch.zeros(pos.shape, device="cuda")
    rows = to_rows(grid, C, torch.as_tensor(pos, device="cuda"), z, z)[0]
    coefs = substep_coefs(params, bcs, grid, C)
    pair = pair_coefs(params, grid, C)
    with pytest.raises(ValueError):               # in place
        dem_substep_rows(rows, rows.state, coefs)
    with pytest.raises(ValueError):               # wrong row count
        dem_substep_rows(rows, rows.state[:, :-1].clone(), coefs)
    with pytest.raises(ValueError):               # a cell of the wrong type
        dem_forces_rows(replace(rows, cell=rows.cell.long()),
                        rows.state.new_empty((2, rows.n_rows, 4)), pair)
    with pytest.raises(ValueError):               # out of the wrong shape
        dem_forces_rows(rows, torch.empty_like(rows.state), pair)


@pytest.mark.cuda
def test_migrate_kernel_matches_twin_bitwise(card):
    n = dem_migrate.launches
    assert card.k2_six_cycles() > 0
    assert dem_migrate.launches == n + 6


@pytest.mark.cuda
def test_migrate_rows_kernel_matches_twin_and_slot_path(card):
    """Phase 1's checks of ``dem_migrate_rows``: bit for bit against its
    twin and the slot path over 6 cycles at C = 16, stirred, and past
    C = 3; a two-cell jump lost as the slot path loses it."""
    n = dem_migrate_rows.launches
    for C, stir in ((16, False), (16, True), (3, True)):
        changed, most = card.k2_rows_cycles(C, stir)
        assert changed > 0 and (most > C) == (C == 3)
    assert card.k2_rows_jump() == 1
    assert dem_migrate_rows.launches == n + 19


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs(card):
    params, bcs, grid, pos, C = card.small_scene(7)
    z = torch.zeros(pos.shape, device="cuda")
    field = to_cells(grid, C, torch.as_tensor(pos, device="cuda"), z, z)
    coefs = substep_coefs(params, bcs, grid, C)
    with pytest.raises(ValueError):               # in place
        dem_substep(field.feat, field.feat, coefs)
    with pytest.raises(ValueError):               # wrong dtype
        dem_substep(field.feat, field.feat.double(), coefs)
    with pytest.raises(ValueError):               # not contiguous
        dem_substep(field.feat.transpose(1, 2).contiguous().transpose(1, 2),
                    torch.empty_like(field.feat), coefs)
    count = torch.empty(grid.n_cells, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):               # ids of the wrong type
        dem_migrate(field.feat, field.ids.long(),
                    torch.empty_like(field.feat), torch.empty_like(field.ids),
                    count, grid)


def _sph_launches():
    return tuple(getattr(sph, name).launches for name in SPH_SWEEPS)


def _mini_dam_cells(device):
    from chip_smoke import mini_dam
    params, grid, state = mini_dam("artificial", device=device)
    c = sph.sph_static_params(params)
    feat, _, cells, _ = state_to_cells(grid, 32, state, c)
    return feat, cells, c


def test_sph_twins_run_on_cpu_without_building(monkeypatch):
    """CPU tensors run the SPH twins: no build, no launch counted, and the
    three sweeps compose into sph_substep_plain."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    feat, cells, c = _mini_dam_cells("cpu")
    n = feat.shape[1]
    before = _sph_launches()
    out = torch.empty_like(feat)
    sph.sph_substep(feat, cells, c, feat.new_empty((sph.N_ADAMI, n)),
                    feat.new_empty((3, n)), out)
    assert _sph_launches() == before
    assert torch.equal(out, sph.sph_substep_plain(feat, cells, c))
    fluid = feat[sph.FLU] > 0.5
    assert torch.equal(out[0:3, ~fluid], feat[0:3, ~fluid])
    assert bool((out[0:3, fluid] != feat[0:3, fluid]).any())


def test_sph_wrappers_raise_on_other_devices():
    feat, cells, c = _mini_dam_cells("cpu")
    n = feat.shape[1]
    meta = torch.empty((10, n), device="meta")
    mcells = sph.SortedCells(*(t.to("meta") for t in
                               (cells.cell, cells.start, cells.count)),
                             dims=cells.dims, capacity=cells.capacity)
    with pytest.raises(ValueError):
        sph.sph_adami(meta, mcells, c, torch.empty((7, n), device="meta"))
    with pytest.raises(ValueError):
        sph.sph_momentum(meta, torch.empty((7, n), device="meta"), mcells,
                         c, torch.empty((3, n), device="meta"))
    with pytest.raises(ValueError):
        sph.sph_continuity_drift(meta, torch.empty((3, n), device="meta"),
                                 mcells, c, torch.empty_like(meta))


def test_overlaps_compares_byte_ranges():
    """The wrappers' out-of-place guard sees views that overlap from
    different starts, and lets adjacent ones pass."""
    buf = torch.empty((4, 10))
    assert sph.overlaps(buf, buf[1:4]) and sph.overlaps(buf[1:4], buf)
    assert sph.overlaps(buf[0:2], buf[1:3])
    assert not sph.overlaps(buf[0:2], buf[2:4])
    assert not sph.overlaps(buf, torch.empty_like(buf))


@pytest.mark.cuda
@pytest.mark.parametrize("viscosity", ["artificial", "laminar"])
def test_sph_kernels_match_twins(card, viscosity):
    """Phase 3 of chip_smoke.py: each sweep against its twin after one
    substep, and the whole path after 3 cycles, on the mini dam."""
    before = _sph_launches()
    errs = card.sph_one_substep(viscosity)
    assert all(np.isfinite(e) and r <= 1.0 for planes in errs.values()
               for e, r in planes.values())
    assert card.sph_three_cycles(viscosity) < 1e-2
    assert all(a > b for a, b in zip(_sph_launches(), before))


@pytest.mark.cuda
def test_sph_wrappers_check_inputs(card):
    feat, cells, c = _mini_dam_cells("cuda")
    n = feat.shape[1]
    adami = feat.new_empty((sph.N_ADAMI, n))
    with pytest.raises(ValueError):               # in place
        sph.sph_continuity_drift(feat, feat[3:6].contiguous(), cells, c,
                                 feat)
    with pytest.raises(ValueError):               # wrong dtype
        sph.sph_adami(feat.double(), cells, c, adami)
    with pytest.raises(ValueError):               # wrong shape
        sph.sph_momentum(feat, adami[:3].contiguous(), cells, c,
                         feat.new_empty((3, n)))
    with pytest.raises(ValueError):               # table of the wrong type
        sph.sph_adami(feat, sph.SortedCells(
            cells.cell.long(), cells.start, cells.count, cells.dims,
            cells.capacity), c, adami)
    sph.sph_adami(feat, cells, c, adami)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(adami).all())


@pytest.mark.cuda
def test_sph_kernels_match_twins_past_capacity(card):
    """With C below the fullest cell, the kernels and the twins agree on
    which markers take part and carry the rest through."""
    params, grid, state = card.mini_dam("laminar", device="cuda")
    c = sph.sph_static_params(params)
    top = int(state_to_cells(grid, 32, state, c)[2].count.max())
    feat, _, cells, ovf = state_to_cells(grid, top - 4, state, c)
    assert int(ovf) == 4
    errs, (_, _, ref) = card.sph_sweeps_vs_twins(feat, cells, c, "C < max")
    assert all(np.isfinite(e) and r <= 1.0 for planes in errs.values()
               for e, r in planes.values())
    start = cells.start.long()[cells.cell.long()]
    past = torch.arange(feat.shape[1], device="cuda") - start >= top - 4
    assert bool(past.any())
    assert torch.equal(ref[0:7, past], feat[0:7, past])


def test_build_is_stale_when_a_shared_header_changes(tmp_path, monkeypatch):
    """A library older than its source or than any ``csrc/*.cuh`` is
    rebuilt; one newer than both is not."""
    import os

    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    src, hdr, lib = csrc / "k.cu", csrc / "shared.cuh", build / "libk.so"
    assert _build._stale("k")
    for path, t in ((src, 100), (hdr, 100), (lib, 200)):
        path.write_text("")
        os.utime(path, (t, t))
    assert not _build._stale("k")
    os.utime(hdr, (300, 300))
    assert _build._stale("k")
    os.utime(hdr, (100, 100))
    os.utime(src, (300, 300))
    assert _build._stale("k")


def _crm_launches():
    return tuple(getattr(crm, name).launches for name in CRM_KERNELS)


def _crm_mini_engine(device):
    from chip_smoke import crm_bed
    from chrono_tpu_torch.fsi.sph.crm_pencil import make_crm_engine
    params, soil, grid, state = crm_bed((0.4, 0.2), 0.1, 0.02, device=device)
    eng = make_crm_engine(params, soil, grid, 32, device=device)
    feat, _, cells, _ = eng["bin"](state)
    return eng, feat, cells


def _crm_mini_cells(device):
    eng, feat, cells = _crm_mini_engine(device)
    return feat, cells, eng["consts"]


def test_crm_twins_run_on_cpu_without_building(monkeypatch):
    """CPU tensors run the CRM twins through the engine's entries: no
    build, no launch counted; the two sweeps compose into
    crm_substep_plain, the forces-only sweep gives with_acc's
    acceleration, and a one-substep outer step is the per-sweep twins."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    eng, feat, cells = _crm_mini_engine("cpu")
    c = eng["consts"]
    before = _crm_launches()
    out, acc = eng["substep_acc"](feat, cells)
    acc2 = eng["forces"](feat, cells)
    o2, a2, list_ovf = eng["outer"](feat, cells, 1)
    assert _crm_launches() == before
    ref, ref_acc = crm.crm_substep_plain(feat, cells, c, with_acc=True)
    assert torch.equal(out, ref) and torch.equal(acc, ref_acc)
    assert torch.equal(eng["substep"](feat, cells), out)
    assert torch.equal(acc2, acc) and torch.equal(o2, out)
    assert torch.equal(a2, acc) and int(list_ovf) == 0
    walls = feat[crm.INT] < 0.5
    assert torch.equal(out[0:crm.SYZ + 1, walls], feat[0:crm.SYZ + 1, walls])
    assert bool((out[0:3, ~walls] != feat[0:3, ~walls]).any())
    assert bool((acc[:, walls] != 0).any())


def test_crm_wrappers_raise_on_other_devices():
    feat, cells, c = _crm_mini_cells("cpu")
    n = feat.shape[1]
    meta = torch.empty((crm.N_STATE, n), device="meta")
    mcells = sph.SortedCells(*(t.to("meta") for t in
                               (cells.cell, cells.start, cells.count)),
                             dims=cells.dims, capacity=cells.capacity)
    mv = torch.empty((crm.N_MV, n), device="meta")
    with pytest.raises(ValueError):
        crm.crm_momentum(meta, mcells, c, mv=mv)
    with pytest.raises(ValueError):
        crm.crm_gradv_stress(meta, mv, mcells, c, torch.empty_like(meta))
    with pytest.raises(ValueError):
        crm.crm_outer_substeps(meta, mcells, c, 2, torch.empty_like(meta),
                               torch.empty((3, n), device="meta"))
    with pytest.raises(ValueError):               # neither output
        crm.crm_momentum(feat, cells, c)


@pytest.mark.cuda
def test_crm_kernels_match_twins(card):
    """Phase 5 of chip_smoke.py: each sweep against its twin after one
    substep of the stirred mini bed, crm_outer against the per-sweep
    kernels and its twin, and the whole path after 3 cycles."""
    before = _crm_launches()
    errs, outer = card.crm_one_substep()
    for group in (errs, outer):
        assert all(np.isfinite(e) and r <= 1.0 for planes in group.values()
                   for e, r in planes.values())
    assert card.crm_three_cycles() < 1.0
    assert all(a > b for a, b in zip(_crm_launches(), before))


@pytest.mark.cuda
def test_crm_wrappers_check_inputs(card):
    feat, cells, c = _crm_mini_cells("cuda")
    n = feat.shape[1]
    mv = feat.new_empty((crm.N_MV, n))
    lists = crm.NeighbourList.empty(n, "cuda")
    with pytest.raises(ValueError):               # in place
        crm.crm_gradv_stress(feat, mv, cells, c, feat, lists)
    with pytest.raises(ValueError):               # mv and acc alias
        crm.crm_momentum(feat, cells, c, mv=mv, acc=mv[:3])
    with pytest.raises(ValueError):               # overlap, other start
        crm.crm_momentum(feat, cells, c, mv=mv, acc=mv[1:4])
    with pytest.raises(ValueError):               # wrong dtype
        crm.crm_momentum(feat.double(), cells, c, mv=mv)
    with pytest.raises(ValueError):               # wrong shape
        crm.crm_gradv_stress(feat, mv[:3].contiguous(), cells, c,
                             torch.empty_like(feat), lists)
    with pytest.raises(ValueError):               # no list to replay
        crm.crm_gradv_stress(feat, mv, cells, c, torch.empty_like(feat))
    with pytest.raises(ValueError):               # a list without a kick
        crm.crm_momentum(feat, cells, c, acc=mv[:3], lists=lists)
    with pytest.raises(ValueError):               # list lengths of int64
        crm.crm_momentum(feat, cells, c, mv=mv, lists=crm.NeighbourList(
            lists.nbrs, lists.n_listed.long()))
    with pytest.raises(ValueError):               # no substep
        crm.crm_outer_substeps(feat, cells, c, 0, torch.empty_like(feat),
                               feat.new_empty((3, n)))
    crm.crm_momentum(feat, cells, c, mv=mv, lists=lists)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(mv).all())


@pytest.mark.cuda
def test_crm_kernels_match_twins_past_capacity(card):
    """With C below the fullest cell, the kernels and the twins agree on
    which markers take part, and the rest keep their state bit for bit."""
    from chrono_tpu_torch.fsi.sph.crm_pencil import crm_state_to_cells
    params, soil, grid, state = card.crm_bed((0.4, 0.2), 0.1, 0.02)
    c = crm.crm_static_params(params, soil)
    top = int(crm_state_to_cells(grid, 32, state)[2].count.max())
    feat, _, cells, ovf = crm_state_to_cells(grid, top - 4, state)
    assert int(ovf) == 4
    errs, (_, _, ref), _ = card.crm_sweeps_vs_twins(feat, cells, c,
                                                     "C < max")
    assert all(np.isfinite(e) and r <= 1.0 for planes in errs.values()
               for e, r in planes.values())
    past = feat[crm.VAL] < 0.5
    assert bool(past.any())
    assert torch.equal(ref[:, past], feat[:, past])


def _cap_at_and_past(count: torch.Tensor) -> int:
    """A capacity that one cell fills exactly while the fullest passes
    it: the second-largest cell count."""
    return sorted(set(count[count > 0].tolist()))[-2]


def test_crm_outer_checks_its_list():
    """The whole-outer wrapper refuses a neighbour list of the wrong type,
    shape, layout or device before it looks at the state's device."""
    feat, cells, c = _crm_mini_cells("cpu")
    n = feat.shape[1]
    meta = torch.empty((crm.N_STATE, n), device="meta")
    mcells = sph.SortedCells(*(t.to("meta") for t in
                               (cells.cell, cells.start, cells.count)),
                             dims=cells.dims, capacity=cells.capacity)
    out, acc = torch.empty_like(meta), torch.empty((3, n), device="meta")
    bad = (torch.empty((8, n), dtype=torch.int64, device="meta"),
           torch.empty((8, n + 1), dtype=torch.int32, device="meta"),
           torch.empty((0, n), dtype=torch.int32, device="meta"),
           torch.empty((8 * n,), dtype=torch.int32, device="meta"),
           torch.empty((n, 8), dtype=torch.int32, device="meta").T,
           torch.empty((8, n), dtype=torch.int32))
    for nbrs in bad:
        with pytest.raises(ValueError, match="nbrs"):
            crm.crm_outer_substeps(meta, mcells, c, 2, out, acc, nbrs)


def test_crm_outer_reports_a_short_list_on_cpu():
    """On the CPU the whole-outer step counts the neighbours its kernel
    lists: a list of 16 slots overflows on the mini bed, the engine's
    default one does not, and the state is the per-sweep twins' either
    way."""
    eng, feat, cells = _crm_mini_engine("cpu")
    c = eng["consts"]
    out, acc, list_ovf = eng["outer"](feat, cells, 1)
    ref, ref_acc = crm.crm_substep_plain(feat, cells, c, with_acc=True)
    assert torch.equal(out, ref) and torch.equal(acc, ref_acc)
    most = int(crm.crm_neighbour_counts_plain(feat, cells, c).max())
    assert int(list_ovf) == 0 and crm.LIST_SLOTS > most
    nbrs = torch.empty((16, feat.shape[1]), dtype=torch.int32)
    list_ovf = crm.crm_outer_substeps(feat, cells, c, 1, out, acc, nbrs)
    assert int(list_ovf) == most - 16 > 0
    assert torch.equal(out, ref) and torch.equal(acc, ref_acc)


@pytest.mark.cuda
def test_crm_outer_short_list_reports_overflow(card):
    """crm_outer with a list too short for the mini bed reports the
    overflow and still matches the per-sweep kernels and its twin (a
    marker past its list walks again); a list that aliases an output is
    refused."""
    errs, list_ovf = card.crm_outer_short_list(slots=16)
    assert list_ovf > 0
    assert all(np.isfinite(e) and r <= 1.0 for planes in errs.values()
               for e, r in planes.values())
    feat, cells, c = _crm_mini_cells("cuda")
    out, acc = torch.empty_like(feat), feat.new_empty((3, feat.shape[1]))
    with pytest.raises(ValueError):
        crm.crm_outer_substeps(feat, cells, c, 1, out, acc,
                               out.view(torch.int32)[:4])


@pytest.mark.cuda
def test_compacted_walks_match_twins_at_and_past_capacity(card):
    """B, CD and crm_outer, whose walks split a run at a cell past its
    capacity, against their twins (and crm_outer against the per-sweep
    kernels) where one cell holds exactly C markers and the fullest
    more."""
    params, grid, state = card.mini_dam("artificial", device="cuda")
    c = sph.sph_static_params(params)
    cap = _cap_at_and_past(state_to_cells(grid, 32, state, c)[2].count)
    feat, _, cells, ovf = state_to_cells(grid, cap, state, c)
    assert int(ovf) > 0 and bool((cells.count == cap).any())
    errs, _ = card.sph_sweeps_vs_twins(feat, cells, c, f"C = {cap}")
    assert all(np.isfinite(e) and r <= 1.0
               for name in ("sph_momentum", "sph_continuity_drift")
               for e, r in errs[name].values())
    from chrono_tpu_torch.fsi.sph.crm_pencil import crm_state_to_cells
    params, soil, grid, state = card.crm_bed((0.4, 0.2), 0.1, 0.02)
    cap = _cap_at_and_past(crm_state_to_cells(grid, 32, state)[2].count)
    feat, _, cells, ovf = crm_state_to_cells(grid, cap, state)
    assert int(ovf) > 0 and bool((cells.count == cap).any())
    c = crm.crm_static_params(params, soil)
    errs, list_ovf, _ = card.crm_outer_vs_sweeps(feat, cells, c, 4,
                                                 f"C = {cap}")
    assert list_ovf == 0
    assert all(np.isfinite(e) and r <= 1.0 for planes in errs.values()
               for e, r in planes.values())


def _nsc_launches():
    return tuple(k.launches for k in NSC_KERNELS)


def _nsc_sweep_inputs(device):
    """The sweep scene of chip_smoke.py phase 7 on ``device``: the binned
    bodies, the constants, the blade poses, the partner and reverse tables
    and zero multipliers."""
    import chip_smoke
    from chrono_tpu_torch.solver.nsc_pencil import nsc_static_params
    p, grid, pos, vel, om = chip_smoke.nsc_sweep_scene()
    dev = torch.device(device)
    pos_s, ufree, cells, _ = chip_smoke.nsc_bin(grid, pos, vel, om, p,
                                                device=dev)
    cs = chip_smoke.nsc_blade_cs(chip_smoke.NSC_BLADE_WALLS, 0.3, dev)
    c = nsc_static_params(p, chip_smoke.NSC_BLADE_WALLS)
    dc = nd.DetectConsts.of(p.radius, p.envelope)
    part, _ = nd.nsc_detect_plain(pos_s, cells, 12, dc)
    n, W = pos_s.shape[1], len(c.walls)
    g = torch.zeros((3, n, 12), device=dev)
    wg = torch.zeros((3, n, W), device=dev)
    return pos_s, ufree, cells, c, cs, dc, part, nd.reverse_table(part), g, wg


def test_nsc_twins_run_on_cpu_without_building(monkeypatch):
    """CPU tensors run the NSC twins through the advance: no build, no
    launch counted, and the wrappers give the twins' values."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    import chip_smoke
    from chrono_tpu_torch.solver.nsc_pencil import make_nsc_pencil_advance
    before = _nsc_launches()
    p, grid, walls, pos, vel, kw = chip_smoke.nsc_blade_scene(False)
    out = make_nsc_pencil_advance(p.replace(n_iter=3), grid, walls,
                                  device="cpu")(pos, vel, 0 * vel, 1, **kw)
    assert int(out[3]) == 0 and bool(torch.isfinite(out[1]).all())
    pos_s, ufree, cells, c, cs, dc, part, rev, g, wg = _nsc_sweep_inputs(
        "cpu")
    assert torch.equal(nd.nsc_detect(pos_s, cells, 12, dc)[0], part)
    u = torch.empty_like(ufree)
    ns.nsc_sweep_u(pos_s, ufree, g + 0.01, g, wg + 0.01, wg, 0.3, part, rev,
                   cs, c, u)
    assert torch.equal(u, ns.nsc_sweep_u_plain(pos_s, ufree, g + 0.01, g,
                                               wg + 0.01, wg, 0.3, part, cs,
                                               c))
    assert not torch.equal(u, ufree)
    gout, wout = torch.empty_like(g), torch.empty_like(wg)
    ns.nsc_sweep_g(pos_s, u, g, g, wg, wg, 0.0, part, cs, c, gout, wout)
    ref = ns.nsc_sweep_g_plain(pos_s, u, g, g, wg, wg, 0.0, part, cs, c)
    assert torch.equal(gout, ref[0]) and torch.equal(wout, ref[1])
    assert _nsc_launches() == before


def test_nsc_wrappers_raise_on_other_devices():
    pos_s, ufree, cells, c, cs, dc, part, rev, g, wg = _nsc_sweep_inputs(
        "cpu")

    def meta(t):
        return t.to("meta")

    mcells = sph.SortedCells(*(meta(t) for t in
                               (cells.cell, cells.start, cells.count)),
                             dims=cells.dims, capacity=cells.capacity)
    with pytest.raises(ValueError):
        nd.nsc_detect(meta(pos_s), mcells, 12, dc)
    with pytest.raises(ValueError):
        ns.nsc_sweep_u(meta(pos_s), meta(ufree), meta(g), meta(g), meta(wg),
                       meta(wg), 0.3, meta(part), rev, meta(cs), c,
                       meta(ufree))
    with pytest.raises(ValueError):
        ns.nsc_sweep_g(meta(pos_s), meta(ufree), meta(g), meta(g), meta(wg),
                       meta(wg), 0.3, meta(part), meta(cs), c, meta(g),
                       meta(wg))


@pytest.mark.cuda
def test_nsc_kernels_match_twins(card):
    """Phase 7 of chip_smoke.py: each NSC kernel against its twin on the
    sweep scene (nsc_detect bit for bit, P = 12 and an overflowing P = 2),
    and two steps of the blade and dynamic-blade scenes on the card against
    the twins on the CPU."""
    before = _nsc_launches()
    for errs in card.nsc_one_sweep().values():
        assert all(np.isfinite(e) and r <= 1.0 for planes in errs.values()
                   for e, r in planes.values())
    for dynamic in (False, True):
        assert np.isfinite(card.nsc_two_steps(dynamic))
    assert all(a > b for a, b in zip(_nsc_launches(), before))


@pytest.mark.cuda
def test_nsc_wrappers_check_inputs(card):
    pos_s, ufree, cells, c, cs, dc, part, rev, g, wg = _nsc_sweep_inputs(
        "cuda")
    u = torch.empty_like(ufree)
    with pytest.raises(ValueError):               # in place
        ns.nsc_sweep_g(pos_s, ufree, g, g, wg, wg, 0.3, part, cs, c, g,
                       torch.empty_like(wg))
    gout = torch.empty_like(g)
    with pytest.raises(ValueError):               # outputs overlap
        ns.nsc_sweep_g(pos_s, ufree, g, g, wg, wg, 0.3, part, cs, c, gout,
                       gout.reshape(-1)[:wg.numel()].view(wg.shape))
    with pytest.raises(ValueError):               # wrong dtype
        ns.nsc_sweep_u(pos_s.double(), ufree, g, g, wg, wg, 0.3, part, rev,
                       cs, c, u)
    with pytest.raises(ValueError):               # wrong shape
        ns.nsc_sweep_u(pos_s, ufree, g[:, :, :6].contiguous(), g, wg, wg,
                       0.3, part, rev, cs, c, u)
    with pytest.raises(ValueError):               # table of the wrong type
        ns.nsc_sweep_u(pos_s, ufree, g, g, wg, wg, 0.3, part.long(), rev, cs,
                       c, u)
    with pytest.raises(ValueError):               # P = 0
        nd.nsc_detect(pos_s, cells, 0, dc)
    ns.nsc_sweep_u(pos_s, ufree, g, g, wg, wg, 0.3, part, rev, cs, c, u)
    torch.cuda.synchronize()
    assert torch.equal(u, ufree)


def test_nsc_sweep_u_wall_masks_compose_on_cpu():
    """On CPU tensors U's wall masks come from their twin and U's twin on
    the masks gives the plain twin's bits: a writing call fills the masks,
    a reading call uses them (a cleared mask moves u)."""
    pos_s, ufree, cells, c, cs, dc, part, rev, g, wg = _nsc_sweep_inputs(
        "cpu")
    n = part.shape[0]
    args = (pos_s, ufree, g + 0.01, g, wg + 0.01, wg, 0.3, part, rev, cs, c)
    ref = ns.nsc_sweep_u_plain(*args[:8], cs, c)
    masks = torch.empty(n, dtype=torch.int32)
    written, read = torch.empty_like(ufree), torch.empty_like(ufree)
    ns.nsc_sweep_u(*args, written, masks, write=True)
    ns.nsc_sweep_u(*args, read, masks)
    assert torch.equal(written, ref) and torch.equal(read, ref)
    assert torch.equal(masks, ns.wall_masks_plain(pos_s, cs, c))
    assert bool(masks.any())
    masks.zero_()
    ns.nsc_sweep_u(*args, read, masks)
    assert not torch.equal(read, ref)


@pytest.mark.cuda
def test_nsc_wall_masks_check_inputs(card):
    """U refuses wall masks of the wrong length or type and masks that
    overlap another array; U reading the masks that U wrote gives the
    writing launch's u, bit for bit."""
    pos_s, ufree, cells, c, cs, dc, part, rev, g, wg = _nsc_sweep_inputs(
        "cuda")
    n = part.shape[0]
    masks = torch.empty(n, dtype=torch.int32, device="cuda")
    u = torch.empty_like(ufree)
    args = (pos_s, ufree, g + 0.01, g, wg + 0.01, wg, 0.3, part, rev, cs, c)
    with pytest.raises(ValueError):               # wrong length
        ns.nsc_sweep_u(*args, u, masks[:-1])
    with pytest.raises(ValueError):               # wrong type
        ns.nsc_sweep_u(*args, u, masks.float())
    with pytest.raises(ValueError):               # written masks are u
        ns.nsc_sweep_u(*args, u, u.reshape(-1)[:n].view(torch.int32),
                       write=True)
    with pytest.raises(ValueError):               # written masks are pos
        ns.nsc_sweep_u(*args, u, pos_s.reshape(-1)[:n].view(torch.int32),
                       write=True)
    with pytest.raises(ValueError):               # read masks are u
        ns.nsc_sweep_u(*args, u, u.reshape(-1)[:n].view(torch.int32))
    before = ns.nsc_sweep_u.launches
    written = torch.empty_like(ufree)
    ns.nsc_sweep_u(*args, written, masks, write=True)
    ns.nsc_sweep_u(*args, u, masks)
    torch.cuda.synchronize()
    assert torch.equal(u, written)
    assert torch.equal(masks, ns.wall_masks_plain(pos_s, cs, c))
    assert ns.nsc_sweep_u.launches == before + 2


@pytest.mark.cuda
def test_sph_adami_order_checks(card):
    """A refuses a thread order of the wrong type or length, and gives the
    same planes with its order given or made by the wrapper."""
    feat, cells, c = _mini_dam_cells("cuda")
    n = feat.shape[1]
    adami, again = (feat.new_empty((sph.N_ADAMI, n)) for _ in range(2))
    order = sph.adami_walk_order(feat, cells)
    with pytest.raises(ValueError):               # wrong type
        sph.sph_adami(feat, cells, c, adami, order.long())
    with pytest.raises(ValueError):               # wrong length
        sph.sph_adami(feat, cells, c, adami, order[:-1].contiguous())
    sph.sph_adami(feat, cells, c, adami, order)
    sph.sph_adami(feat, cells, c, again)
    torch.cuda.synchronize()
    assert torch.equal(adami, again)


def test_sph_adami_refuses_an_order_that_is_not_a_permutation():
    """On every device A refuses a thread order that misses a binned marker
    (one index twice), which would leave that marker's column of its
    output unwritten on the card; the walk order itself is accepted, and
    its check is kept on the tensor until the tensor changes."""
    feat, cells, c = _mini_dam_cells("cpu")
    n = feat.shape[1]
    adami = feat.new_empty((sph.N_ADAMI, n))
    order = sph.adami_walk_order(feat, cells)
    sph.sph_adami(feat, cells, c, adami, order)
    assert order._permutation_of == (n, order._version)
    bad = order.clone()
    bad[-1] = bad[0]
    with pytest.raises(ValueError, match="permutation"):
        sph.sph_adami(feat, cells, c, adami, bad)
    order[-1] = order[0]                # an in-place change is checked again
    with pytest.raises(ValueError, match="permutation"):
        sph.sph_adami(feat, cells, c, adami, order)


def _persistent_reduction(dev):
    """The persistent vehicle path's reduction (``body_forces_planes``) on
    the single-wheel mini bed after one binning with the aux rows and one
    forces-only M sweep: (force, torque) of the wheel, twice."""
    from chip_smoke import crm_wheel_scene
    from chrono_tpu_torch.fsi.crm_terrain import (
        bce_extras, body_forces_planes, rigid_slots,
    )
    from chrono_tpu_torch.fsi.sph.crm_pencil import make_crm_engine

    scene = crm_wheel_scene(device=dev)
    params, soil, grid = scene["params"], scene["soil"], scene["grid"]
    terrain, bodies = scene["state"].terrain, scene["state"].bodies
    eng = make_crm_engine(params, soil, grid, 32, device=dev)
    feat, _, cells, ovf, aux = eng["bin"](terrain, bce_extras(terrain))
    assert int(ovf) == 0
    is_wheel = torch.ones(bodies.n, dtype=torch.bool, device=dev)
    rs = rigid_slots(aux, is_wheel, scene["n_rigid"])
    acc = eng["forces"](feat, cells)
    return [body_forces_planes(params, feat, acc, rs, bodies)
            for _ in range(2)]


@pytest.mark.cuda
def test_persistent_reduction_is_deterministic_on_the_card(card):
    """The wheel's force and torque from the sorted planes: two reductions
    on the card equal bit for bit, and equal the CPU's (the twins) within
    float32 rounding of the pair sums (1e-4 relative, 1e-4 of the
    largest component)."""
    (f1, t1), (f2, t2) = _persistent_reduction("cuda")
    assert torch.equal(f1, f2) and torch.equal(t1, t2)
    (fc, tc), _ = _persistent_reduction("cpu")
    for got, ref in ((f1, fc), (t1, tc)):
        ref = ref.numpy()
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.cuda
def test_side_plan_sums_are_deterministic_on_the_card(card):
    """The contact solve's ``Dᵀγ`` (``descriptor.apply_DT_sorted``) at the
    general mixer's scale (10,000 movable bodies, 360,000 rows, most rows
    inactive, one body on 3,000 sides): two calls on the card equal bit for
    bit, and equal the same sums on the CPU within float32 rounding."""
    from chrono_tpu_torch.solver import descriptor as desc
    from chrono_tpu_torch.physics.constraints import ConstraintRows

    rng = np.random.default_rng(70)
    n, m, live = 10_001, 360_000, 40_000
    ba = rng.integers(1, n, m)
    bb = rng.integers(0, n, m)
    bb[:3000] = 7                                  # a heavily loaded body
    J = rng.normal(size=(4, m, 3)).astype(np.float32)
    active = np.zeros(m, bool)
    active[:live] = True
    rows = ConstraintRows.two_body(
        body_a=torch.tensor(ba, dtype=torch.int32),
        body_b=torch.tensor(bb, dtype=torch.int32),
        **{k: torch.tensor(J[i]) for i, k in enumerate(
            ("Ja_v", "Ja_w", "Jb_v", "Jb_w"))},
        rhs=torch.zeros(m), active=torch.tensor(active))
    minv = torch.ones((n, 8))
    minv[0] = 0.0
    gamma = torch.tensor(rng.normal(size=m).astype(np.float32))

    def dt(dev):
        p = desc.pack_rows(rows.replace(**{
            f: getattr(rows, f).to(dev) for f in (
                "body_a", "body_b", "body_c", "Ja_v", "Ja_w", "Jb_v",
                "Jb_w", "Jc_w", "rhs", "active")}), has_c=False)
        plan = desc.build_side_plan(p, minv.to(dev))
        return [desc.apply_DT_sorted(plan, gamma.to(dev)) for _ in range(2)]

    a, b = dt("cuda")
    assert torch.equal(a, b)
    cpu = dt("cpu")[0]
    np.testing.assert_allclose(a.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_closed_loop_graph_equals_eager_loop(card):
    """The HMMWV double lane change's closed loop (``run_closed_loop``, one
    captured step replayed) equals the eager loop of ``closed_loop_step``
    bit for bit over 20 steps, steering included (the steer angle is
    written into the motor profile inside the captured step); with no
    step it captures and returns an empty record."""
    _, graph = card.dlc_graph(card.DEV, 20)
    state, xs = card.dlc_eager(card.DEV, 20)
    for f in "xqvw":
        assert torch.equal(getattr(graph.state, f), getattr(state, f)), f
    assert torch.equal(graph.chassis_x, xs)
    assert graph.chassis_x.shape == (20, 3)
    _, empty = card.dlc_graph(card.DEV, 0)
    assert empty.chassis_x.shape == (0, 3)
