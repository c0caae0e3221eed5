"""chrono_tpu_torch — the PyTorch / CUDA port of chrono_tpu for NVIDIA Hopper.

The JAX package ``chrono_tpu`` is the reference; this package mirrors its
layout so that every module has a counterpart of the same path.  Plain tensor
code is PyTorch; each Pallas TPU kernel on a ported path is a hand-written
CUDA C++ kernel for ``sm_90a`` (sources in ``csrc/``, built on first CUDA use
by ``ops.cuda._build``), with a plain PyTorch twin beside it that runs on CPU
tensors.  This package never imports ``jax`` or ``chrono_tpu``.

Ported so far: the granular DEM settling box and the other cell-dense
backends (``dem.cell_dense.make_cell_dense_advance`` with ``backend`` flat,
sym, pencil, pallas or xla; every wall kind of ``dem.bc`` on the forces
path), with the kernels ``ops.cuda.dem_substep``, ``ops.cuda.migrate`` and
``ops.cuda.dem_forces``; the WCSPH dam break (``fsi.sph.pencil.
make_sph_advance_pencil``), with the three sweeps of
``ops.cuda.sph_substep``; CRM terrain alone (``fsi.crm_terrain.
make_crm_terrain_state``, ``fsi.sph.crm_pencil.make_crm_advance_pencil``),
with the two sweeps and the whole-outer step of ``ops.cuda.crm_substep``;
the NSC many-body stepper of the bladed mixer (``solver.nsc_pencil.
make_nsc_pencil_advance``), with contact detection ``ops.cuda.nsc_detect``
and the two APGD sweeps of ``ops.cuda.nsc_sweep``; the multibody core
(``core`` quaternions, frames and motion functions; ``physics`` bodies, the
17 joint kinds, couplers, motors, force elements, ``SystemBuilder``,
``step_euler_implicit_linearized`` and ``simulate``; ``solver.descriptor``
and the compensated dense Schur solve ``solver.direct``), which has no TPU
kernel: plain tensor code whose step ``simulate`` captures in a CUDA graph
on the card with the direct solver; rigid-body contact (``collision``:
the grid, the analytic narrowphase, ``detect_contacts``, ``contact_rows``
and ``nsc_step`` for spheres, boxes and triangle meshes; ``physics.smc``
penalty contact and ``smc_step``; the VI and Krylov solvers of
``solver.vi`` and ``solver.krylov`` with the cone projector), also plain
tensor code, whose solvers read their loop tests on the host and run
eagerly; the vehicle on CRM terrain, config #5 (``fsi.crm_terrain``:
rigid BCE markers, ``crm_fsi_step``, ``make_crm_fsi_advance_fn`` with the
active domains of ``fsi.active``, ``make_crm_fsi_advance_persistent``;
``fsi.bce``'s rigid-body pieces; ``vehicle.suspension``'s templates), on
the CRM kernels with the multibody step replayed as a CUDA graph;
wheeled vehicles and rovers (``vehicle``: tires, SCM and rigid terrain,
powertrain, drivers, ``vehicle_step`` and the closed path-following loop
``closed_loop.run_closed_loop`` replayed as a CUDA graph, the DBP rig;
``models``: the wheeled decks and the rovers; ``physics.shafts``), plain
tensor code with no TPU kernel; the neighbour-list (gather) backend
(``dem.neighbors`` on periodic or closed grids; ``fsi.sph.wcsph``,
``fsi.sph.system.make_sph_advance_fn``, ``fsi.sph.isph``; rigid bodies
in WCSPH or ISPH, ``fsi.system.fsi_step`` and ``make_fsi_advance_fn``;
CRM's gather engine, ``fsi.sph.crm.crm_step`` and the default of
``fsi.crm_terrain.make_crm_fsi_advance_fn``), plain tensor code with no
TPU kernel; the DEM system on the neighbour list (``dem.system``:
``DEMSystem``, ``make_dem_state``, ``make_advance_fn``, the four
integrators, every friction mode with its history, Schwartz and
elastic–plastic rolling, the user force model; ``dem.forces``'s list and
wall passes; ``dem.mesh``'s sphere–triangle coupling;
``vehicle.granular_terrain``; ``utils.samplers``; and ``io``'s writers,
exporters and checkpoints), plain tensor code with no TPU kernel; convex
contact and tracked vehicles (``collision.mpr``, the convex branches of
``detect_contacts``, ``collision.profile2d``, ``collision.ray``,
``collision.decomp``; ``vehicle.tracked``, ``vehicle.track_shoes``,
``models.m113``, ``models.decks.build_marder``, ``vehicle.crg``), and the
other steppers (``physics.implicit``: HHT, Newmark and the projected Euler;
``physics.explicit``; ``physics.external``: ODE blocks and the hydraulic
actuator; ``core.rotation_functions``), plain tensor code with no TPU
kernel.  Its builders put the model on the card unless the caller passes
``device="cpu"``; flexible BCE markers are refused, and so are periodic
grids on the paths that only ever ran closed boxes.  Of ``io`` the YAML, URDF, ADAMS, OpenSim, FMI and
archive modules are not ported.
"""
