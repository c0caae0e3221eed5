"""The CUDA sources of the compacted pair walk, run on the CPU.

``csrc/sph_substep.cu``, ``csrc/crm_substep.cu`` and ``csrc/crm_outer.cu``
are compiled with g++ against ``tests/cuda_emu`` (one CPU thread per CUDA
thread, warp votes and grid barriers on ``std::barrier``) and launched
through the wrappers' own ctypes signatures on CPU tensors.  So the walk's
logic (the nine runs and the cell cap, the warp votes, the hit buffer and
its flushes, ``crm_outer``'s neighbour list and its overflow) is held here
to the plain twins and to the per-sweep kernels, without a card.  The
arithmetic is the host compiler's: the kernels match the twins to the
tolerances ``chip_smoke.py`` holds the card to, and each other bit for bit
where they run the same code.  Skips without g++.
"""

import ctypes
import re
import shutil
import subprocess
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from chrono_tpu_torch.fsi.sph.crm_pencil import crm_state_to_cells
from chrono_tpu_torch.fsi.sph.pencil import state_to_cells
from chrono_tpu_torch.fsi.sph.state import FLUID
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda import crm_substep as crm
from chrono_tpu_torch.ops.cuda import sph_substep as sph

EMU = Path(__file__).resolve().parent / "cuda_emu"
SOURCES = ("sph_substep", "crm_substep", "crm_outer")


def _for_the_cpu(src: str) -> str:
    """A kernel source with its CUDA-only syntax replaced by calls into
    ``tests/cuda_emu``: dynamic shared memory, ``<<<...>>>`` launches and
    the cooperative launch."""
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = static_cast<\1*>(emu_smem);", src)
    src = re.sub(r"(\w+)\s*<<<(.*?)>>>\s*\((.*?)\);",
                 r"emu::run(\2, [&] { \1(\3); });", src, flags=re.S)
    return re.sub(r"cudaLaunchCooperativeKernel\(\s*"
                  r"reinterpret_cast<const void\*>\((\w+)\),",
                  r"emu::launch_cooperative(\1,", src)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The three sources built for the CPU, one g++ each, all at once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("emulated")
    procs = []
    for name in SOURCES:
        src = out / f"{name}.cpp"
        src.write_text(_for_the_cpu((_build.CSRC / f"{name}.cu").read_text()))
        procs.append((name, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
             f"-I{EMU}", f"-I{_build.CSRC}", "-o", str(out / f"{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    for name, proc in procs:
        _, err = proc.communicate()
        assert proc.returncode == 0, f"g++ failed on {name}:\n{err}"
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in SOURCES}


@contextmanager
def _emulated(libs):
    """Inside the block the wrappers' launchers bind the CPU builds."""
    saved = _build.load
    _build.load = lambda name: libs[name]
    try:
        with _build.variant("CPU_EMULATION"):
            yield
    finally:
        _build.load = saved


def _launch(libs, module, name, *args):
    with _emulated(libs):
        fn = module._launcher(name)
    assert fn(*args, None, 0) == 0, f"{name} refused its arguments"


def _table(cells):
    return (cells.cell.data_ptr(), cells.start.data_ptr(),
            cells.count.data_ptr())


def _cd(libs, feat, vel, cells, c):
    out = torch.empty_like(feat)
    _launch(libs, sph, "sph_continuity_drift", feat.data_ptr(),
            vel.data_ptr(), *_table(cells), out.data_ptr(), feat.shape[1],
            *cells.dims, cells.capacity, ctypes.byref(c.kernel_params))
    return out


def _at_and_past(counts):
    """A capacity that one cell fills exactly while the fullest passes it:
    the second-largest cell count."""
    return sorted(set(counts[counts > 0].tolist()))[-2]


def _dam(viscosity, at_cap=False):
    """The mini dam of chip_smoke.py's phase 3 on the CPU, binned at C = 32
    (or, with ``at_cap``, at :func:`_at_and_past`), and kicked fluid
    velocities."""
    params, grid, state = cs.mini_dam(viscosity, device="cpu")
    c = sph.sph_static_params(params)
    capacity = 32
    if at_cap:
        capacity = _at_and_past(state_to_cells(grid, 32, state, c)[2].count)
    feat, _, cells, ovf = state_to_cells(grid, capacity, state, c)
    rng = np.random.default_rng(17)
    fluid = (feat[sph.FLU] > 0.5).double()
    vel = (feat[3:6].double() + fluid * torch.as_tensor(
        rng.normal(0.0, 0.1, (3, feat.shape[1])))).float().contiguous()
    return feat, vel, cells, c, int(ovf)


def _cd_close(got, ref, c):
    cs.check_close(got[0:3], ref[0:3], **cs.SPH_POS_TOL, what="x")
    assert torch.equal(got[3:6], ref[3:6]) and torch.equal(got[7], ref[7])
    cs.check_close(got[6], ref[6], **cs.SPH_RHO_TOL, what="rho")
    cs.sph_p_close(got[8], ref[8], c, "p")
    cs.check_close(got[9], ref[9], **cs.SPH_RHO_TOL, what="1/rho")


@pytest.mark.parametrize("viscosity", ["artificial", "laminar"])
def test_emulated_cd_matches_twin(libs, viscosity):
    """CD against its twin; only fluid markers move."""
    feat, vel, cells, c, _ = _dam(viscosity)
    got = _cd(libs, feat, vel, cells, c)
    _cd_close(got, sph.sph_continuity_drift_plain(feat, vel, cells, c), c)
    moved = feat[sph.FLU] > 0.5
    assert bool((got[0:3, moved] != feat[0:3, moved]).any())
    assert torch.equal(got[0:3, ~moved], feat[0:3, ~moved])


def test_emulated_cd_at_and_past_capacity(libs):
    """With one cell filled exactly to C and the fullest past it, CD's runs
    split at the capped cell as the twin's candidates do."""
    feat, vel, cells, c, ovf = _dam("artificial", at_cap=True)
    assert ovf > 0 and bool((cells.count == cells.capacity).any())
    got = _cd(libs, feat, vel, cells, c)
    _cd_close(got, sph.sph_continuity_drift_plain(feat, vel, cells, c), c)


def _bed(at_cap=False):
    """A 0.16 x 0.1 m CRM bed of the demo's loam, 0.06 m deep at d0 = 0.02
    (1,632 markers) with its granular velocities perturbed as chip_smoke.py
    stirs its mini bed, binned at C = 32 (or, with ``at_cap``, at
    :func:`_at_and_past`)."""
    params, soil, grid, state = cs.crm_bed((0.16, 0.1), 0.06, 0.02,
                                           device="cpu")
    capacity = 32
    if at_cap:
        capacity = _at_and_past(crm_state_to_cells(grid, 32, state)[2].count)
    rng = np.random.default_rng(23)
    gran = state.kind == FLUID
    vel = state.vel.clone()
    vel[gran] += torch.as_tensor(rng.normal(0.0, 0.05, (int(gran.sum()), 3)),
                                 dtype=torch.float32)
    feat, _, cells, ovf = crm_state_to_cells(grid, capacity,
                                             state.replace(vel=vel))
    return feat, cells, crm.crm_static_params(params, soil), int(ovf)


def _outer(libs, feat, cells, c, n_sub, slots):
    n = feat.shape[1]
    out, acc = torch.empty_like(feat), feat.new_empty((3, n))
    spare, mv = torch.empty_like(feat), feat.new_empty((crm.N_MV, n))
    valid = feat[crm.VAL] > 0.5
    kick = valid & (feat[crm.INT] > 0.5)
    order = torch.argsort(2 - valid.to(torch.int8) - kick.to(torch.int8),
                          stable=True).to(torch.int32)
    nbrs = torch.full((slots, n), -1, dtype=torch.int32)
    n_listed = torch.empty(n, dtype=torch.int32)
    most = torch.zeros(n, dtype=torch.int32)
    _launch(libs, crm, "crm_outer", feat.data_ptr(), *_table(cells),
            out.data_ptr(), spare.data_ptr(), mv.data_ptr(), acc.data_ptr(),
            order.data_ptr(), nbrs.data_ptr(), n_listed.data_ptr(),
            most.data_ptr(), n, *cells.dims, cells.capacity, n_sub, slots,
            ctypes.byref(c.kernel_params))
    return out, acc, int(most.max())


def _per_sweep(libs, feat, cells, c, n_sub):
    """n_sub substeps of the per-sweep kernels, the last with its
    acceleration."""
    n = feat.shape[1]
    mv, acc = feat.new_empty((crm.N_MV, n)), feat.new_empty((3, n))
    cur = feat
    for s in range(n_sub):
        nxt = torch.empty_like(feat)
        a = acc.data_ptr() if s == n_sub - 1 else None
        _launch(libs, crm, "crm_momentum", cur.data_ptr(), *_table(cells),
                mv.data_ptr(), a, n, *cells.dims, cells.capacity,
                ctypes.byref(c.kernel_params))
        _launch(libs, crm, "crm_gradv_stress", cur.data_ptr(),
                *_table(cells), mv.data_ptr(), nxt.data_ptr(), n,
                *cells.dims, cells.capacity, ctypes.byref(c.kernel_params))
        cur = nxt
    return cur, acc


@pytest.mark.parametrize("slots", [crm.LIST_SLOTS, 16])
def test_emulated_crm_outer_matches_per_sweep_kernels(libs, slots):
    """crm_outer (2 substeps) gives the per-sweep kernels' state and
    acceleration bit for bit, whether its list holds every neighbour or a
    marker past 16 walks again in G; its largest list length is the twin's
    count; it matches the twin to chip_smoke.py's tolerances."""
    feat, cells, c, _ = _bed()
    got, acc, most = _outer(libs, feat, cells, c, 2, slots)
    ref, ref_acc = _per_sweep(libs, feat, cells, c, 2)
    assert torch.equal(got, ref) and torch.equal(acc, ref_acc)
    twin_most = torch.zeros((), dtype=torch.int32)
    twin, twin_acc = crm.crm_outer_substeps_plain(feat, cells, c, 2,
                                                  twin_most)
    assert abs(most - int(twin_most)) <= 1
    assert (most > slots) == (slots == 16)
    assert all(r <= 1.0 for _, r in cs.crm_state_errs(got, twin,
                                                      "outer").values())
    cs.crm_scaled_close(acc, twin_acc, 1e-4, 5e-5, "acc")


def test_emulated_crm_outer_at_and_past_capacity(libs):
    """With one cell filled exactly to C and the fullest past it, crm_outer
    and the per-sweep kernels agree bit for bit and the markers past C keep
    their state."""
    feat, cells, c, ovf = _bed(at_cap=True)
    assert ovf > 0 and bool((cells.count == cells.capacity).any())
    got, acc, _ = _outer(libs, feat, cells, c, 2, crm.LIST_SLOTS)
    ref, ref_acc = _per_sweep(libs, feat, cells, c, 2)
    assert torch.equal(got, ref) and torch.equal(acc, ref_acc)
    past = feat[crm.VAL] < 0.5
    assert bool(past.any()) and torch.equal(got[:, past], feat[:, past])
