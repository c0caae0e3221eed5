"""The port's CUDA kernels against their plain PyTorch twins.

Tests marked ``cuda`` need a CUDA card and skip without one; they make the
same checks as phase 1 of ``chip_smoke.py``.  Run them on the card with
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
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda.dem_substep import dem_substep
from chrono_tpu_torch.ops.cuda.migrate import dem_migrate


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
        "dem_substep.cu", "migrate.cu"}

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
