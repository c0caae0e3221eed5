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
from pathlib import Path

import numpy as np
import pytest
import torch

import chrono_tpu_torch
from chrono_tpu_torch.dem.cell_dense import substep_coefs, to_cells
from chrono_tpu_torch.fsi.sph.pencil import state_to_cells
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda import sph_substep as sph
from chrono_tpu_torch.ops.cuda.dem_substep import dem_substep
from chrono_tpu_torch.ops.cuda.migrate import dem_migrate

SPH_SWEEPS = ("sph_adami", "sph_momentum", "sph_continuity_drift")


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
        "dem_substep.cu", "migrate.cu", "sph_substep.cu"}

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    from chip_smoke import small_scene
    params, bcs, grid, pos, C = small_scene(7)
    z = torch.zeros(pos.shape)
    field = to_cells(grid, C, torch.from_numpy(pos), z, z)
    out = torch.empty_like(field.feat)
    launches = dem_substep.launches, dem_migrate.launches
    dem_substep(field.feat, out, substep_coefs(params, bcs, grid, C))
    count = torch.empty(grid.n_cells, dtype=torch.int32)
    dem_migrate(out, field.ids, torch.empty_like(out),
                torch.empty_like(field.ids), count, grid)
    assert (dem_substep.launches, dem_migrate.launches) == launches
    assert int(count.sum()) == len(pos)


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


@pytest.mark.cuda
@pytest.mark.parametrize("friction_mode", ["frictionless", "single_step"])
def test_substep_kernel_matches_twin(card, friction_mode):
    n = dem_substep.launches
    assert card.k1_small_substep(friction_mode) < 1e-3
    assert card.k1_three_cycles(friction_mode) < 1e-3
    assert dem_substep.launches > n


@pytest.mark.cuda
def test_substep_kernel_matches_twin_overlapping(card):
    assert np.isfinite(card.k1_one_substep(*card.overlap_scene(n_side=20)))


@pytest.mark.cuda
def test_migrate_kernel_matches_twin_bitwise(card):
    n = dem_migrate.launches
    assert card.k2_six_cycles() > 0
    assert dem_migrate.launches == n + 6


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
