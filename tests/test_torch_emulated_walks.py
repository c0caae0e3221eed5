"""The CUDA sources of the compacted pair walk, of the NSC sweeps and
detection, and of the DEM row migration, run on the CPU.

``csrc/sph_substep.cu``, ``csrc/crm_substep.cu``, ``csrc/crm_outer.cu``,
``csrc/nsc_sweep.cu``, ``csrc/nsc_detect.cu`` and ``csrc/migrate.cu`` are
compiled with g++ against ``tests/cuda_emu`` (one CPU thread per CUDA
thread, warp votes, ballots and block and grid barriers on
``std::barrier``) and launched through the wrappers' own ctypes signatures
on CPU tensors.  So the walk's logic (the nine runs and the cell cap, the
warp votes, the hit buffer and its flushes, ``crm_outer``'s neighbour list
and its overflow) and NSC G's rows (contact rows, empty slots, wall rows of
each kind) are held here to the plain twins and to the per-sweep kernels,
without a card.  So are the per-sweep CRM M's neighbour list and G's
replay of it: against the twins, and against ``crm_outer`` bit for bit on a
state that moved after binning, with a planted fault (a list short of one
neighbour) that must show.  ``nsc_detect``'s lane groups and the row
migration's three passes (keys, counts and a block scan, the copy) are held
to their twins exactly, at the faces, edges and corners of a small grid and
past P or C; a copy of each source with one line changed (a hit ranked out
of walk order, a lander's rank off by one) is built beside it and must
differ.  The arithmetic is the host compiler's: the
kernels match the twins to the tolerances ``chip_smoke.py`` holds the card
to, and each other bit for bit where they run the same code.  Skips
without g++.
"""

import ctypes
import re
import shutil
import subprocess
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from chrono_tpu_torch.dem.rows import CellRows, rows_from_prefix_slots
from chrono_tpu_torch.fsi.sph.crm_pencil import crm_state_to_cells
from chrono_tpu_torch.fsi.sph.pencil import state_to_cells
from chrono_tpu_torch.fsi.sph.state import FLUID
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda import crm_substep as crm
from chrono_tpu_torch.ops.cuda import migrate as mig
from chrono_tpu_torch.ops.cuda import nsc_detect as nd
from chrono_tpu_torch.ops.cuda import nsc_sweep as ns
from chrono_tpu_torch.ops.cuda import sph_substep as sph
from chrono_tpu_torch.solver.nsc_pencil import nsc_static_params

EMU = Path(__file__).resolve().parent / "cuda_emu"
SOURCES = ("sph_substep", "crm_substep", "crm_outer", "nsc_sweep",
           "nsc_detect", "migrate")
# planted faults: a source with one line changed, built beside the others
MUTANTS = {
    # a step's hits ranked from the highest lane down
    "detect_out_of_order": ("nsc_detect", "__popc(votes & below)",
                            "__popc(votes & ~below & ~(1u << wl))"),
    # each cell's landers placed one row further on
    "lander_rank_off_by_one": ("migrate", "count[q] + __popc(same & below)",
                               "count[q] + __popc(same & below) + 1"),
}


def _for_the_cpu(src: str) -> str:
    """A kernel source with its CUDA-only syntax replaced by calls into
    ``tests/cuda_emu``: dynamic shared memory, ``<<<...>>>`` launches and
    the cooperative launch."""
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = static_cast<\1*>(emu_smem);", src)
    src = re.sub(r"(\w+(?:<\w+>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                 r"emu::run(\2, [&] { \1(\3); });", src, flags=re.S)
    return re.sub(r"cudaLaunchCooperativeKernel\(\s*"
                  r"reinterpret_cast<const void\*>\((\w+)\),",
                  r"emu::launch_cooperative(\1,", src)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The sources built for the CPU, one g++ each, all at once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("emulated")
    procs = []
    jobs = {name: (name, None, None) for name in SOURCES} | MUTANTS
    for name, (source, old, new) in jobs.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        if old is not None:
            assert text.count(old) == 1, f"{name}: {old!r} not in {source}"
            text = text.replace(old, new)
        src = out / f"{name}.cpp"
        src.write_text(_for_the_cpu(text))
        procs.append((name, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
             f"-I{EMU}", f"-I{_build.CSRC}", "-o", str(out / f"{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    for name, proc in procs:
        _, err = proc.communicate()
        assert proc.returncode == 0, f"g++ failed on {name}:\n{err}"
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in jobs}


@contextmanager
def _emulated(libs, mutant=None):
    """Inside the block the wrappers' launchers bind the CPU builds, with
    the planted fault ``mutant`` in place of its source."""
    saved = _build.load
    swap = {MUTANTS[mutant][0]: mutant} if mutant else {}
    _build.load = lambda name: libs[swap.get(name, name)]
    try:
        with _build.variant("CPU_EMULATION", *swap.values()):
            yield
    finally:
        _build.load = saved


def _launch(libs, module, name, *args, mutant=None):
    with _emulated(libs, mutant):
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


def _dam(viscosity, at_cap=False, fluid_past=False):
    """The mini dam of chip_smoke.py's phase 3 on the CPU, binned at C = 32
    (or, with ``at_cap``, at :func:`_at_and_past` of the cells' counts, or
    with ``fluid_past`` too, of the counts of the cells that hold fluid
    markers, so that fluid markers pass C), and kicked fluid velocities."""
    params, grid, state = cs.mini_dam(viscosity, device="cpu")
    c = sph.sph_static_params(params)
    capacity = 32
    if at_cap:
        feat, _, cells, _ = state_to_cells(grid, 32, state, c)
        counts = cells.count
        if fluid_past:
            wet = torch.bincount(cells.cell[feat[sph.FLU] > 0.5].long(),
                                 minlength=counts.numel())
            counts = torch.where(wet > 0, counts, 0)
        capacity = _at_and_past(counts)
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


def _stirred(feat, cells, c):
    """The mini dam's planes with random fluid velocities (σ = 0.1 m/s) and
    densities (±1 %), as chip_smoke.py's phase 3 stirs them, so that
    pressure and viscosity act in B."""
    rng = np.random.default_rng(19)
    fluid = feat[sph.FLU] > 0.5
    n_f = int(fluid.sum())
    vel = feat[3:6].T.clone()
    vel[fluid] = torch.as_tensor(rng.normal(0.0, 0.1, (n_f, 3)),
                                 dtype=torch.float32)
    rho = feat[sph.RHO].clone()
    rho[fluid] *= torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, n_f),
                                  dtype=torch.float32)
    return sph.state_planes(feat[0:3].T, vel, rho, fluid, c)


@pytest.mark.parametrize("viscosity,at_cap", [("artificial", False),
                                              ("laminar", False),
                                              ("artificial", True)])
def test_emulated_momentum_matches_twin(libs, viscosity, at_cap):
    """B on the compacted walk against its twin at phase 4's velocity
    tolerance, for both viscosity modes and with one cell filled exactly to
    C and the fullest cells of fluid past it; solids and the markers past C
    keep their velocities bit for bit."""
    feat, _, cells, c, ovf = _dam(viscosity, at_cap, fluid_past=at_cap)
    assert (ovf > 0) == at_cap
    if at_cap:
        assert bool((cells.count == cells.capacity).any())
    feat = _stirred(feat, cells, c)
    adami = sph.sph_adami_plain(feat, cells, c)
    got = torch.empty((3, feat.shape[1]))
    _launch(libs, sph, "sph_momentum", feat.data_ptr(), adami.data_ptr(),
            *_table(cells), got.data_ptr(), feat.shape[1], *cells.dims,
            cells.capacity, ctypes.byref(c.kernel_params))
    ref = sph.sph_momentum_plain(feat, adami, cells, c)
    cs.sph_vel_close(got, ref, f"B {viscosity}")
    start = cells.start.long()[cells.cell.long()]
    live = torch.arange(feat.shape[1]) - start < cells.capacity
    kick = (feat[sph.FLU] > 0.5) & live
    assert bool((~live & (feat[sph.FLU] > 0.5)).any()) == at_cap
    assert torch.equal(got[:, ~kick], feat[3:6, ~kick])
    assert bool((got[:, kick] != feat[3:6, kick]).all(0).any())


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
    lists = _lists(n, slots)
    most = torch.zeros(n, dtype=torch.int32)
    rec = feat.new_empty((crm.N_RECORD, n))
    _launch(libs, crm, "crm_outer", feat.data_ptr(), *_table(cells),
            out.data_ptr(), spare.data_ptr(), mv.data_ptr(), acc.data_ptr(),
            rec.data_ptr(), order.data_ptr(), lists.nbrs.data_ptr(),
            lists.n_listed.data_ptr(), most.data_ptr(), n, *cells.dims,
            cells.capacity, n_sub, slots, ctypes.byref(c.kernel_params))
    lists.n_listed[~kick] = -1
    return out, acc, int(most.max()), lists


def _ptr(t):
    return None if t is None else t.data_ptr()


def _momentum(libs, feat, cells, c, mv=None, acc=None, lists=None):
    """Sweep M's emulated kernel."""
    n = feat.shape[1]
    rec = feat.new_empty((crm.N_RECORD, n))
    _launch(libs, crm, "crm_momentum", feat.data_ptr(), *_table(cells),
            rec.data_ptr(), _ptr(mv), _ptr(acc), _ptr(lists and lists.nbrs),
            _ptr(lists and lists.n_listed), n, *cells.dims, cells.capacity,
            lists.nbrs.shape[0] if lists else 0,
            ctypes.byref(c.kernel_params))


def _gradv(libs, feat, mv, cells, c, lists):
    """Sweep G's emulated kernel, replaying ``lists``: the next state."""
    n = feat.shape[1]
    out = torch.empty_like(feat)
    rec = feat.new_empty((crm.N_GRADV_RECORD, n))
    _launch(libs, crm, "crm_gradv_stress", feat.data_ptr(), *_table(cells),
            rec.data_ptr(), mv.data_ptr(), out.data_ptr(),
            lists.nbrs.data_ptr(), lists.n_listed.data_ptr(), n,
            *cells.dims, cells.capacity, lists.nbrs.shape[0],
            ctypes.byref(c.kernel_params))
    return out


def _lists(n, slots=crm.LIST_SLOTS):
    return crm.NeighbourList(torch.full((slots, n), -1, dtype=torch.int32),
                             torch.full((n,), -1, dtype=torch.int32))


def _per_sweep(libs, feat, cells, c, n_sub):
    """n_sub substeps of the per-sweep kernels, the last with its
    acceleration."""
    n = feat.shape[1]
    mv, acc = feat.new_empty((crm.N_MV, n)), feat.new_empty((3, n))
    lists = _lists(n)
    cur = feat
    for s in range(n_sub):
        _momentum(libs, cur, cells, c, mv, acc if s == n_sub - 1 else None,
                  lists)
        cur = _gradv(libs, cur, mv, cells, c, lists)
    return cur, acc


@pytest.mark.parametrize("slots", [crm.LIST_SLOTS, 16])
def test_emulated_crm_outer_matches_per_sweep_kernels(libs, slots):
    """crm_outer (2 substeps) gives the per-sweep kernels' state and
    acceleration bit for bit, whether its list holds every neighbour or a
    marker past 16 walks again in G; its largest list length is the twin's
    count; it matches the twin to chip_smoke.py's tolerances."""
    feat, cells, c, _ = _bed()
    got, acc, most, _ = _outer(libs, feat, cells, c, 2, slots)
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
    got, acc, _, _ = _outer(libs, feat, cells, c, 2, crm.LIST_SLOTS)
    ref, ref_acc = _per_sweep(libs, feat, cells, c, 2)
    assert torch.equal(got, ref) and torch.equal(acc, ref_acc)
    past = feat[crm.VAL] < 0.5
    assert bool(past.any()) and torch.equal(got[:, past], feat[:, past])


def _mixer(blade_inertia):
    """A 400-sphere bed of chip_smoke.py's mixer scene under three walls,
    one of each kind: its floor (gravity along −x) raised 4 mm into reach
    of the lowest layer, a cylinder about x that the outer spheres touch or
    overlap, and its blade turned 0.4 rad into the bed; with
    ``blade_inertia`` > 0 the blade is dynamic (ρ²/I_b on its rows'
    diagonal).  Returns the G inputs at P = 6 with random velocities (seed
    7) and multipliers (seed 5)."""
    p, grid, walls, pts, _ = cs.mixer_scene(400)
    p = p.replace(blade_inertia=blade_inertia)
    blade = walls[-1]
    centre = (0.0, blade[2][1], blade[2][2])
    rad = np.hypot(pts[:, 1] - centre[1], pts[:, 2] - centre[2])
    cyl = ("cyl", 0, centre, float(np.quantile(rad, 0.9)) + p.radius, 0.7,
           0.35)
    walls = (("plane", (1.0, 0.0, 0.0), 0.004, (0.0, 0.0, 0.0), 0.4), cyl,
             blade)
    rng = np.random.default_rng(7)
    vel, om = rng.normal(0.0, 0.2, pts.shape), rng.normal(0.0, 2.0, pts.shape)
    pos_s, u, cells, ovf = cs.nsc_bin(grid, pts, vel, om, p,
                                      device="cpu")
    assert ovf == 0
    c = nsc_static_params(p, walls)
    P, n = 6, pos_s.shape[1]
    part, _ = nd.nsc_detect_plain(
        pos_s, cells, P, nd.DetectConsts.of(c.radius, c.envelope))
    rng = np.random.default_rng(5)
    valid = (part >= 0).numpy()
    gam, gprev = (torch.as_tensor(np.where(valid, rng.uniform(
        -0.005, 0.01, (3, n, P)), 0.0), dtype=torch.float32)
                  for _ in range(2))
    wgam, wgprev = (torch.as_tensor(rng.uniform(-0.005, 0.01, (3, n, 3)),
                                    dtype=torch.float32) for _ in range(2))
    pose = cs.nsc_blade_cs(walls, 0.4, device="cpu")
    return pos_s, u, gam, gprev, wgam, wgprev, part, pose, c


@pytest.mark.parametrize("blade_inertia", [0.0, 0.05])
def test_emulated_sweep_g_matches_twin(libs, blade_inertia):
    """G, one thread per row, against its twin at phase 8's tolerance on a
    scene with empty partner slots and active rows of each wall kind."""
    pos_s, u, gam, gprev, wgam, wgprev, part, pose, c = _mixer(blade_inertia)
    assert (c.inv_Ib > 0.0) == (blade_inertia > 0.0)
    gout, wout = torch.empty_like(gam), torch.empty_like(wgam)
    _launch(libs, ns, "nsc_sweep_g", pos_s.data_ptr(), u.data_ptr(),
            gam.data_ptr(), gprev.data_ptr(), wgam.data_ptr(),
            wgprev.data_ptr(), part.data_ptr(), pose.data_ptr(),
            gout.data_ptr(), wout.data_ptr(), part.shape[0], part.shape[1],
            0.3, ctypes.byref(c.kernel_params))
    ref, ref_w = ns.nsc_sweep_g_plain(pos_s, u, gam, gprev, wgam, wgprev,
                                      0.3, part, pose, c)
    cs.check_close(gout, ref, **cs.NSC_SWEEP_TOL, what="G gamma")
    cs.check_close(wout, ref_w, **cs.NSC_SWEEP_TOL, what="G wall gamma")
    empty = part < 0
    assert bool(empty.any()) and bool((part >= 0).any())
    assert bool((gout[:, empty] == 0).all())
    assert bool((ref[:, ~empty] != 0).any())
    for w in range(3):   # every wall kind has rows inside and beyond reach
        active = (ref_w[:, :, w] != 0).any(0)
        assert bool(active.any()) and not bool(active.all())


@pytest.mark.parametrize("at_cap", [False, True])
def test_emulated_crm_sweeps_match_twins(libs, at_cap):
    """M on the compacted walk and G on M's list against their twins at phase
    5's tolerances, at C = 32 and with one cell filled exactly to C and the
    fullest past it: M's list holds each kicked marker's neighbours in the
    twin's walk order and their number, exactly; the markers past C keep
    their state bit for bit."""
    feat, cells, c, ovf = _bed(at_cap)
    assert (ovf > 0) == at_cap
    n = feat.shape[1]
    mv, acc, lists = feat.new_empty((crm.N_MV, n)), feat.new_empty((3, n)), \
        _lists(n)
    _momentum(libs, feat, cells, c, mv, acc, lists)
    ref_mv, ref_acc = crm.crm_momentum_plain(feat, cells, c, with_acc=True)
    cs.crm_scaled_close(mv[0:3], ref_mv[0:3], 1e-4, 3e-5, "M v")
    cs.check_close(mv[3], ref_mv[3], **cs.CRM_INV_TOL, what="M 1/rho")
    cs.crm_scaled_close(acc, ref_acc, 1e-4, 5e-5, "M acc")
    nbrs, n_listed = crm.crm_neighbour_list_plain(feat, cells, c)
    kick = (feat[crm.VAL] > 0.5) & (feat[crm.INT] > 0.5)
    assert torch.equal(lists.n_listed[kick], n_listed[kick])
    assert bool((lists.n_listed[~kick] == -1).all())
    assert torch.equal(lists.nbrs[:, kick], nbrs[:, kick])
    got = _gradv(libs, feat, mv, cells, c, lists)
    ref = crm.crm_gradv_stress_plain(feat, mv, cells, c)
    assert all(r <= 1.0 for _, r in cs.crm_state_errs(got, ref,
                                                      "G").values())
    past = feat[crm.VAL] < 0.5
    assert bool(past.any()) == at_cap
    assert torch.equal(got[:, past], feat[:, past])


def _moved():
    """The stirred bed binned, then its integrated markers moved by up to
    0.5 h on each axis (uniform, seed 29), as the drift between rebinnings
    moves them."""
    feat, cells, c, _ = _bed()
    rng = np.random.default_rng(29)
    move = (feat[crm.VAL] > 0.5) & (feat[crm.INT] > 0.5)
    delta = 0.5 * c.h
    feat = feat.clone()
    feat[crm.PX:crm.PZ + 1, move] += torch.as_tensor(
        rng.uniform(-delta, delta, (3, int(move.sum()))), dtype=torch.float32)
    return feat, cells, c


def _substep(libs, feat, cells, c, slots=crm.LIST_SLOTS):
    """One substep of the per-sweep kernels, M with its acceleration: the
    state, the acceleration and M's list."""
    n = feat.shape[1]
    mv, acc, lists = feat.new_empty((crm.N_MV, n)), feat.new_empty((3, n)), \
        _lists(n, slots)
    _momentum(libs, feat, cells, c, mv, acc, lists)
    return _gradv(libs, feat, mv, cells, c, lists), acc, lists


@pytest.mark.parametrize("slots", [crm.LIST_SLOTS, 16])
def test_emulated_per_sweep_list_matches_crm_outer(libs, slots):
    """On a state whose markers moved by up to 0.5 h after binning, the
    per-sweep M lists crm_outer's neighbours in its order, and M and G give
    its acceleration and state bit for bit; with 16 slots the markers past
    them walk again in G, with the same bits."""
    feat, cells, c = _moved()
    ref, ref_acc, _, ref_lists = _outer(libs, feat, cells, c, 1,
                                        crm.LIST_SLOTS)
    got, acc, lists = _substep(libs, feat, cells, c, slots)
    assert torch.equal(lists.n_listed, ref_lists.n_listed)
    held = min(slots, crm.LIST_SLOTS)
    assert torch.equal(lists.nbrs[:held], ref_lists.nbrs[:held])
    assert bool((lists.n_listed > slots).any()) == (slots == 16)
    assert torch.equal(acc, ref_acc) and torch.equal(got, ref)


def test_emulated_g_on_a_list_short_of_a_neighbour_differs(libs):
    """Planted fault: G replaying M's list with each marker's last listed
    neighbour dropped gives another state (as the test above would see)."""
    feat, cells, c = _moved()
    n = feat.shape[1]
    mv, lists = feat.new_empty((crm.N_MV, n)), _lists(n)
    _momentum(libs, feat, cells, c, mv, None, lists)
    ref = _gradv(libs, feat, mv, cells, c, lists)
    kick = lists.n_listed > 0
    short = crm.NeighbourList(lists.nbrs, torch.where(
        kick, lists.n_listed - 1, lists.n_listed).to(torch.int32))
    got = _gradv(libs, feat, mv, cells, c, short)
    assert not torch.equal(got, ref)
    assert torch.equal(got[:, ~kick], ref[:, ~kick])



def _u_scene(blade_inertia, P):
    """:func:`_mixer`'s bodies and three walls with a partner budget of P,
    two bodies of the lowest layer put 0.999 and 1.001 envelopes from the
    floor (a wall row just inside its reach and one just outside; both stay
    in their cells), random multipliers (seed 31) and the reverse table.
    Returns the inputs of U, the two bodies and the largest contact count."""
    p, grid, walls, pts, _ = cs.mixer_scene(400)
    p = p.replace(blade_inertia=blade_inertia)
    blade = walls[-1]
    centre = (0.0, blade[2][1], blade[2][2])
    rad = np.hypot(pts[:, 1] - centre[1], pts[:, 2] - centre[2])
    walls = (("plane", (1.0, 0.0, 0.0), 0.004, (0.0, 0.0, 0.0), 0.4),
             ("cyl", 0, centre, float(np.quantile(rad, 0.9)) + p.radius,
              0.7, 0.35), blade)
    rng = np.random.default_rng(7)
    vel, om = rng.normal(0.0, 0.2, pts.shape), rng.normal(0.0, 2.0, pts.shape)
    pos_s, ufree, cells, _ = cs.nsc_bin(grid, pts, vel, om, p, device="cpu")
    c = nsc_static_params(p, walls)
    low = torch.argsort(pos_s[0])[:2]
    edge = 0.004 + c.radius
    pos_s[0, low] = torch.tensor([edge + 0.999 * c.envelope,
                                  edge + 1.001 * c.envelope])
    part, count = nd.nsc_detect_plain(
        pos_s, cells, P, nd.DetectConsts.of(c.radius, c.envelope))
    n = pos_s.shape[1]
    rng = np.random.default_rng(31)
    valid = (part >= 0).numpy()
    gam, gprev = (torch.as_tensor(np.where(valid, rng.uniform(
        -0.005, 0.01, (3, n, P)), 0.0), dtype=torch.float32)
                  for _ in range(2))
    wgam, wgprev = (torch.as_tensor(rng.uniform(-0.005, 0.01, (3, n, 3)),
                                    dtype=torch.float32) for _ in range(2))
    pose = cs.nsc_blade_cs(walls, 0.4, device="cpu")
    inputs = (pos_s, ufree, gam, gprev, wgam, wgprev, part,
              nd.reverse_table(part), pose, c)
    return inputs, low, int(count.max())


def _sweep_u(libs, inputs, masks, write, beta=0.3):
    """U's emulated kernel, writing the wall masks or reading them: u."""
    pos_s, ufree, gam, gprev, wgam, wgprev, part, rev, pose, c = inputs
    n, P = part.shape
    u = torch.empty_like(ufree)
    _launch(libs, ns, "nsc_sweep_u", pos_s.data_ptr(), ufree.data_ptr(),
            gam.data_ptr(), gprev.data_ptr(), wgam.data_ptr(),
            wgprev.data_ptr(), part.data_ptr(), rev.start.data_ptr(),
            rev.count.data_ptr(), rev.entry.data_ptr(), pose.data_ptr(),
            masks.data_ptr(), u.data_ptr(), n, P, beta, int(write),
            ctypes.byref(c.kernel_params))
    return u


@pytest.mark.parametrize("blade_inertia", [0.0, 0.05])
@pytest.mark.parametrize("P", [12, 2])
def test_emulated_sweep_u_on_wall_masks_matches_twin(libs, blade_inertia,
                                                     P):
    """U writing the wall masks, as a step's first launch does, and U
    reading them, against its twin at phase 8's tolerance, with a budget
    that holds every contact (12) and one that overflows (2); the masks
    equal their twin's, each wall kind reaches some bodies but not all, and
    the two bodies at the floor's envelope are in and out of its mask."""
    inputs, low, most = _u_scene(blade_inertia, P)
    pos_s, ufree, gam, gprev, wgam, wgprev, part, rev, pose, c = inputs
    assert (most > P) == (P == 2)
    twin = ns.wall_masks_plain(pos_s, pose, c)
    assert [int(twin[i]) & 1 for i in low] == [1, 0]
    for w in range(3):
        held = ((twin >> w) & 1).bool()
        assert bool(held.any()) and not bool(held.all())
    ref = ns.nsc_sweep_u_plain(pos_s, ufree, gam, gprev, wgam, wgprev, 0.3,
                               part, pose, c)
    masks = torch.empty(pos_s.shape[1], dtype=torch.int32)
    cs.nsc_u_close(_sweep_u(libs, inputs, masks, True), ref, "U writing")
    assert torch.equal(masks, twin)
    cs.nsc_u_close(_sweep_u(libs, inputs, masks, False), ref, "U reading")
    assert float((ref - ufree).abs().max()) > 1e-4


def test_emulated_sweep_u_masks_hold_geometry_only(libs):
    """The wall masks that a step's first launch writes from its zero
    multipliers equal those of a launch on other multipliers, and U reading
    them gives the writing launch's u on the same multipliers, bit for
    bit."""
    inputs, _, _ = _u_scene(0.0, 6)
    n = inputs[0].shape[1]
    first, again = (torch.empty(n, dtype=torch.int32) for _ in range(2))
    zero = [torch.zeros_like(t) for t in inputs[2:6]]
    _sweep_u(libs, inputs[:2] + tuple(zero) + inputs[6:], first, True,
             beta=0.0)
    u_written = _sweep_u(libs, inputs, again, True)
    assert torch.equal(first, again) and bool(first.any())
    assert torch.equal(_sweep_u(libs, inputs, first, False), u_written)


def test_emulated_sweep_u_on_a_cleared_mask_differs(libs):
    """Planted fault: one body's wall mask cleared moves its u beyond the
    tolerance that the tests above hold U to, and no other body's."""
    inputs, low, _ = _u_scene(0.0, 6)
    n = inputs[0].shape[1]
    masks = torch.empty(n, dtype=torch.int32)
    good = _sweep_u(libs, inputs, masks, True)
    body = int(low[0])
    assert int(masks[body]) & 1
    masks[body] = 0
    bad = _sweep_u(libs, inputs, masks, False)
    with pytest.raises(RuntimeError, match="values off"):
        cs.nsc_u_close(bad, good, "U on a cleared mask")
    moved = (bad != good).any(0)
    assert torch.nonzero(moved).reshape(-1).tolist() == [body]


def _adami(libs, feat, cells, c, order):
    out = feat.new_empty((sph.N_ADAMI, feat.shape[1]))
    _launch(libs, sph, "sph_adami", feat.data_ptr(), order.data_ptr(),
            *_table(cells), out.data_ptr(), feat.shape[1], *cells.dims,
            cells.capacity, ctypes.byref(c.kernel_params))
    return out


@pytest.mark.parametrize("at_cap", [False, True])
def test_emulated_adami_walks_solids_only(libs, at_cap):
    """A, its threads in adami_walk_order (the live solids first), against
    its twin at phase 3's plane tolerances, at C = 32 and with one cell
    filled exactly to C and the fullest past it; solids with fluid
    neighbours and solids without (the ``has`` false branch: p = 0, the
    marker's own velocity) both occur; fluid markers and markers past C keep
    their own values bit for bit."""
    feat, _, cells, c, ovf = _dam("artificial", at_cap)
    assert (ovf > 0) == at_cap
    feat = _stirred(feat, cells, c)
    n = feat.shape[1]
    order = sph.adami_walk_order(feat, cells)
    start = cells.start.long()[cells.cell.long()]
    live = torch.arange(n) - start < cells.capacity
    walk = (feat[sph.FLU] < 0.5) & live
    idx = torch.arange(n, dtype=torch.int32)
    assert torch.equal(order, torch.cat([idx[walk], idx[~walk]]))
    got = _adami(libs, feat, cells, c, order)
    ref = sph.sph_adami_plain(feat, cells, c)
    cs.sph_p_close(got[0], ref[0], c, "A p")
    cs.sph_vel_close(got[1:4], ref[1:4], "A v_bc")
    cs.check_close(got[4], ref[4], **cs.SPH_RHO_TOL, what="A rho")
    cs.sph_p_close(got[5], ref[5], c, "A p/rho2", per_rho2=True)
    cs.check_close(got[6], ref[6], **cs.SPH_RHO_TOL, what="A 1/rho")
    dry = walk & (ref[sph.A_P] == 0)
    assert bool(dry.any()) and bool((walk & ~dry).any())
    assert torch.equal(got[1:4, dry], feat[3:6, dry])
    assert bool((got[0, dry] == 0).all())
    assert bool((~live).any()) == at_cap
    keep = ~walk
    assert torch.equal(got[0, keep], feat[sph.PRS, keep])
    assert torch.equal(got[1:4, keep], feat[3:6, keep])


# ------------------------------------------------------- NSC detection


def _detect_scene():
    """300 spheres of r = 0.025 drawn uniformly over a (4, 3, 5) grid of
    0.1 m cells (seed 23), so that every face, edge and corner cell holds
    bodies and pairs, binned as a DVI step bins them."""
    p = cs.NSCPencilParams(radius=0.025, mass=0.5, mu=0.3, dt=1e-3,
                           envelope=0.005)
    grid = cs.GridSpec(cell_size=0.1, dims=(4, 3, 5))
    rng = np.random.default_rng(23)
    pos = (rng.uniform(0.0, 1.0, (300, 3))
           * np.array([0.4, 0.3, 0.5])).astype(np.float32)
    z = np.zeros_like(pos)
    pos_s, _, cells, _ = cs.nsc_bin(grid, pos, z, z, p, device="cpu")
    assert bool((cells.count > 0).all())
    return pos_s, cells, nd.DetectConsts.of(p.radius, p.envelope)


def _detect(libs, pos_s, cells, P, dc, lanes, mutant=None):
    n = pos_s.shape[1]
    part = torch.empty((n, P), dtype=torch.int32)
    count = torch.empty(n, dtype=torch.int32)
    _launch(libs, nd, "nsc_detect", pos_s.data_ptr(), *_table(cells),
            part.data_ptr(), count.data_ptr(), n, *cells.dims, P, dc.two_r,
            dc.envelope, lanes, mutant=mutant)
    return part, count


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("P", [12, 2])
def test_emulated_detect_matches_twin(libs, lanes, P):
    """The six runs walked by groups of ``lanes`` lanes give the twin's
    partner table and counts exactly, at P = 12 and past P = 2."""
    pos_s, cells, dc = _detect_scene()
    part, count = _detect(libs, pos_s, cells, P, dc, lanes)
    ref_part, ref_count = nd.nsc_detect_plain(pos_s, cells, P, dc)
    assert torch.equal(part, ref_part) and torch.equal(count, ref_count)
    assert (int(count.max()) > P) == (P == 2)
    assert bool((count == 0).any()) and int(count.sum()) > 300


def test_emulated_detect_out_of_walk_order_differs(libs):
    """A build that ranks a step's hits from the highest lane down gives
    another partner table (the same counts)."""
    pos_s, cells, dc = _detect_scene()
    part, count = _detect(libs, pos_s, cells, 12, dc, 8,
                          mutant="detect_out_of_order")
    ref_part, ref_count = nd.nsc_detect_plain(pos_s, cells, 12, dc)
    assert torch.equal(count, ref_count)
    assert not torch.equal(part, ref_part)


# ------------------------------------------------------ DEM row migration


def _migrate_scene(capacity, jump=False, dims=(4, 3, 5)):
    """Particles drawn uniformly over a grid of 0.1 m cells, 20 a cell on
    average (seed 31), binned at ``capacity`` into rows with their ids,
    then each moved by up to 0.9 cell per axis (seed 37), some past the
    grid's faces (clipped to its edge cells); with ``jump`` the first row
    moves two cells along x.  The default grid has one segment of a
    column per warp; (2, 2, 70) has three, the last 6 cells wide."""
    grid = cs.GridSpec(cell_size=0.1, dims=dims)
    rng = np.random.default_rng(31)
    n = 20 * grid.n_cells
    pos = torch.as_tensor(rng.uniform(0.0, 1.0, (n, 3))
                          * 0.1 * np.array(dims), dtype=torch.float32)
    field = cs.to_cells(grid, capacity, pos, pos * 2.0, pos * 3.0)
    rows, row_of_slot = rows_from_prefix_slots(
        field.feat, (field.feat[9] > 0.5).sum(1), n + 1)
    ids = torch.full((n + 1,), -1, dtype=torch.int32)
    ids[row_of_slot] = field.ids.reshape(-1)
    rng = np.random.default_rng(37)
    live = (rows.cell >= 0)[:, None]
    state = rows.state.clone()
    state[0, :, :3] += torch.as_tensor(
        rng.uniform(-0.09, 0.09, (n + 1, 3)), dtype=torch.float32) * live
    if jump:
        state[0, 0, 0] = 0.25              # row 0 lies in the first x layer
    return replace(rows, state=state), ids, grid


def _migrate(libs, rows, ids, grid, capacity, mutant=None):
    n_rows, n_cells = rows.n_rows, grid.n_cells
    out = CellRows(state=torch.empty_like(rows.state),
                   cell=torch.empty_like(rows.cell),
                   table=torch.empty_like(rows.table))
    ids_out, landed = torch.empty_like(ids), torch.empty(n_cells,
                                                         dtype=torch.int32)
    key = torch.empty(n_rows, dtype=torch.int32)
    n_blocks = mig.row_blocks(grid)
    block_total = torch.empty(n_blocks, dtype=torch.int32)
    params = mig._params(grid, capacity)
    _launch(libs, mig, "dem_migrate_rows", *(t.data_ptr() for t in (
        rows.state, rows.cell, rows.table, ids, out.state, out.cell,
        out.table, ids_out, landed, key, block_total)), n_rows, n_cells,
        n_blocks, ctypes.byref(params), mutant=mutant)
    return out, ids_out, landed


def _same_rows(got, ref):
    return all(torch.equal(a, b) for a, b in (
        (got[0].state, ref[0].state), (got[0].cell, ref[0].cell),
        (got[0].table, ref[0].table), (got[1], ref[1]), (got[2], ref[2])))


@pytest.mark.parametrize("capacity,jump,dims", [
    (64, False, (4, 3, 5)), (16, False, (4, 3, 5)), (64, True, (4, 3, 5)),
    (64, False, (2, 2, 70))])
def test_emulated_migrate_rows_matches_twin(libs, capacity, jump, dims):
    """The key pass, the counting sweep with its block scan, and the
    copying sweep give the twin's rows, ids and landing counts exactly:
    with every particle landing (C = 64), past C = 16 (cells overflow: the
    same landers kept), with a two-cell jump (lost by both), and with three
    segments a column."""
    rows, ids, grid = _migrate_scene(capacity, jump, dims)
    got = _migrate(libs, rows, ids, grid, capacity)
    ref = mig.dem_migrate_rows_plain(rows, ids, grid, capacity)
    assert _same_rows(got, ref)
    n_live = int(rows.table[:, 1].sum())
    assert bool((got[0].cell[:n_live] != rows.cell[:n_live]).any())
    assert (int(got[2].max()) > capacity) == (capacity == 16)
    assert (int(got[2].sum()) == n_live - 1) == jump


def test_emulated_migrate_rows_rank_off_by_one_differs(libs):
    rows, ids, grid = _migrate_scene(64)
    got = _migrate(libs, rows, ids, grid, 64,
                   mutant="lander_rank_off_by_one")
    assert not _same_rows(got, mig.dem_migrate_rows_plain(rows, ids, grid,
                                                          64))
