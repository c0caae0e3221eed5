"""Drive the PyTorch / CUDA port's main paths once on a GPU.

    python3 chip_smoke.py [--profile]

Needs one CUDA card; raises without one.  It builds the kernels of the
ported paths from ``chrono_tpu_torch/csrc`` (one nvcc per source, all at
once) and then runs:

1. DEM parity on the card: kernel K1 (``dem_substep``) against its plain
   twin on the 120-particle box after one substep and after 3 cycles, and on
   a random 64k-particle overlapping scene after one substep; the slot
   kernel K2 (``dem_migrate``) against its twin, bit for bit, over 6
   cycles; the row kernel K2 (``dem_migrate_rows``) against its twin and
   against the slot path (rows scattered to slot planes, ``dem_migrate``,
   rows of its output), bit for bit, over 6 cycles of K1 at C = 16, at
   C = 16 with the particles stirred by up to 0.45 cell a cycle, and at
   C = 3 (cells overflow: the same landers kept), and a planted two-cell
   jump that all three lose;
2. the DEM settling box at full size: ``bench.py``'s pinned scene (1 M
   spheres, Hertz–Mindlin with single-step friction, C = 8, 2.1 d cells,
   100 substeps per cycle, migration) for 1 warm-up and 2 timed cycles
   through ``make_cell_dense_advance``, checked for overflow, loss, finite
   values, momentum (the scene has no wall contact, so the mean velocity is
   pure free fall) and that every kernel launch of the run was counted
   (``dem_migrate_rows`` 3, the slot ``dem_migrate`` 0), with a digest of
   the final state; then K1 against the float64 pair reference with two
   planted faults, and after one cycle of K1 on the binned rows
   ``dem_migrate_rows`` against its twin and the slot path, each timed
   with CUDA events at the main path's shapes (K1 on the cell-sorted rows
   it walks: M particles, its launch grid, its occupied candidates a
   particle and its bound from those rows; K2 beside the slot path it
   replaced and the slot kernel alone on the same state);
3. SPH parity on the card: each of the three WCSPH sweeps (``sph_adami``,
   ``sph_momentum``, ``sph_continuity_drift``) against its twin on the mini
   dam of tests/test_sph_pencil.py (756 markers), for both viscosity
   models, after one substep and after 3 cycles of 4 substeps;
4. the WCSPH dam break at full width: ``bench_suite.py``'s config #4 scene
   (968,750 fluid markers + 3 floor layers, 1,069,751 in all, cells of
   1.25·2h, C = 32, 8 substeps per cycle) for 1 warm-up and 2 timed cycles
   through ``make_sph_advance_pencil``, checked for overflow, finite values,
   immobile boundary markers, fluid density bounds and launch counts; then
   each sweep against its twin at those shapes, timed with CUDA events
   (A with its thread order, the live solids first, made once as the
   advance makes it); the body-issue share of A's, B's and CD's walks (all
   ``for_pairs_compact``) from the counter build; with ``--profile``, a
   ``torch.profiler`` trace of one more cycle: its wall time, the device
   time by kernel and the device's idle share;
5. CRM parity on the card, on the mini bed of tests/test_torch_crm.py
   (0.4 × 0.2 × 0.1 m at d0 = 0.02, 5,017 markers): each sweep
   (``crm_momentum`` in its three modes, ``crm_gradv_stress``) against its
   twin after one substep of a stirred state, 3 cycles of
   ``make_crm_advance_pencil`` on the card against the twins on the CPU,
   and the whole-outer kernel ``crm_outer`` (4 substeps) against the
   per-sweep kernels and against its twin, with its neighbour list of 128
   slots (no overflow) and of 16 (an overflow reported, the same state);
6. CRM terrain at full width: a 10 × 4 × 0.2 m vehicle test lane of the
   demo's loam at d0 = 0.02 (1,000,000 granular markers and the wall
   layers, cells of 2h, C = 32, 4 substeps per cycle) for 1 warm-up and
   2 timed cycles through ``make_crm_advance_pencil``, checked for
   overflow, finite values, walls unmoved bit for bit and every granular
   stress inside the Drucker–Prager cone; then the same cycles through
   the engine's whole-outer path (bin, one ``crm_outer`` launch, unbin),
   its cell and neighbour-list overflow 0; then, 3 substeps after a
   binning, M and G against their twins, M's neighbour list against the
   twin's walk order and its lengths against ``crm_neighbour_counts_plain``
   exactly (the markers past its slots counted), each kernel timed with
   CUDA events beside its bound (the list's and the records' traffic
   printed apart: it is the design's scratch), ``crm_outer`` against its 8
   per-sweep launches in turns, the walks' candidates and body issues from
   the counter build, and ``crm_outer`` against its 8 per-sweep launches
   on the demo-sized bed (2.0 × 1.2 × 0.15 m at d0 = 0.05);
7. NSC parity on the card: ``nsc_detect`` (bit for bit), ``nsc_sweep_u``
   and ``nsc_sweep_g`` against their twins on the 24-sphere scene of
   tests/test_nsc_pencil.py under the blade walls at θ = 0.3 (with P = 12,
   and P = 2, which overflows; U writing the wall masks, as a step's first
   launch does, which equal their twin's, and U reading them, the two bit
   for bit), and two steps of
   ``make_nsc_pencil_advance`` on the card against the twins on the CPU for
   the blade scene and the dynamic blade;
8. the NSC bladed mixer at full width: ``bench_suite.py``'s config #2
   scene (40,000 spheres of r = 3 cm in a box tank with a rotbox blade at
   π/3 rad/s, 50 APGD iterations, P = 6, cells of 3.5 r) for 25 warm-up
   and 25 timed steps, checked for overflow, finite values, launch counts,
   a blade torque that resists the spin and the deepest overlap; a
   profiled step (the profiler must see every launch the wrappers count);
   then each kernel against its twin at those shapes, its
   device time per launch from the profiler beside CUDA events around
   back-to-back wrapper calls (at this size the host's cost per call is
   the longer); then the same scene at 400,000 spheres (2 warm-up and 20
   timed steps; profiled runs of one and two steps that give a step's
   device time and each kernel's device time per launch (U's reading and
   writing launches apart) beside its bound; each kernel against its twin
   there); each size prints a digest of its state after the timed steps;
9. the DEM forces path on the card: ``dem_forces`` against its twin on the
   120-particle box of phase 1 (both friction modes, random velocities and
   spins), and 3 cycles of ``make_cell_dense_advance(backend="pallas")`` on
   the card against the twins on the CPU on a scene with a conveyor floor,
   a z-cylinder, a cone, a spherical obstacle and a sinking spinning wheel;
10. the other cell-dense backends at full width, each for 1 warm-up and 2
   timed cycles of 100 substeps with a sort rebin every cycle: ``bench.py``'s
   scene for its ``sym`` / ``pencil`` engines (cells of 1.45 d, C = 8; one
   run serves both names, the same K1 path) and for ``pallas`` / ``xla``
   (cells of two lattice spacings, C = 16), and a silo of 1,000,000 of the
   same spheres inside a z-cylinder over a cone around a spherical
   obstacle through ``pallas``; each checked for overflow, finite values,
   no wall touched and free-fall momentum, every kernel launch counted;
   then K1 or ``dem_forces`` against the float64 pair reference with two
   planted faults and timed on the scene's rows, beside its row twin; the
   forces path's wall pass and Euler step on the rows timed, one sort
   rebin timed, and one forces-path cycle traced with ``torch.profiler``;
11. the multibody core (config #1, no TPU kernel on its path):
   ``bench_suite.py``'s ``bench_mbs`` (a double pendulum and a
   slider-crank, 6 bodies, 26 joint rows) built by the port's builder on
   the card, 2,000 steps at h = 1e-3 with the direct solver through
   ``simulate`` (one step captured in a CUDA graph and replayed) and 300
   through an eager loop of the step, each timed by the host clock (ms per
   step, real-time factor); the replay held to the eager loop over those
   300 (bit for bit, or within 1e-6 relative), the card to the port's CPU
   run over 200
   steps (x within 2e-4), a finite state and a joint violation below 1e-3
   after 2,000 steps; one eager step's kernel launches from the profiler;
   the slider-crank demo for 3,000 steps (the slider inside its stroke
   ± 0.01, the crank at the motor's 2 rad/s); a double pendulum on the
   float32 precision stack (filtered Baumgarte, Kahan position carry),
   card against CPU over 200 steps and 300 steps on the card;
12. rigid-body contact (config #2 as ``bench_suite.py``'s ``bench_mixer``
   builds it, no TPU kernel on its path): 10,000 spheres of r = 3 cm and a
   20 kg stirrer on a speed motor in a box of wall boxes, ``nsc_step`` with
   APGD (50 iterations, the warm start carried as the bench carries it),
   150 settling and 50 timed steps (DVI iterations/s, ms a step, RTF,
   contacts and iterations a step, host reads a step, how often the JAX
   package's capped gather plan would have overflowed), checked at every
   step (finite, ``count <= max_contacts``, the fullest cell within
   ``max_per_cell``, every sphere inside the box, the stirrer at 2 rad/s
   within 1 %), two runs of 20 steps from one state equal bit for bit, one
   profiled step (kernels, device time); the scene cut to 512 spheres, card
   against the port on the CPU in float64 and float32; ``nsc_step`` on
   ``tests/test_contact.py``'s ``drop_scene`` with every VI solver, the
   direct solver's APGD fallback and rolling friction, card against CPU;
   ``bench_mbs`` through ``simulate`` with CG, MINRES and GMRES for 30
   steps (an eager loop: their loop tests are host reads), joint violation
   below 1e-3;
   ``smc_step`` on a stack of spheres, card against CPU;
13. the vehicle on CRM terrain (config #5 as ``bench_suite.py``'s
   ``bench_crm`` builds it, on the CRM kernels of phases 5–6): (a) the
   single-wheel mini bed of tests/test_crm_terrain.py (4,636 markers),
   4 outer steps of 2 substeps through ``crm_fsi_step``, through
   ``make_crm_fsi_advance_fn`` with and without an active box and through
   the persistent advance at ``rebuild_outer`` 1 and 3 with ``whole_outer`` on
   and off, card against the port on the CPU, M's acceleration on the
   wheel's markers against its twin, the reduction twice bit for bit and
   against the CPU, two runs bit for bit; (b) the demo's 17-body vehicle
   (four double-wishbone corners, BCE wheels) on its 2.0 × 1.2 × 0.15 m
   bed at d0 = 0.05 for ``bench_crm``'s 6 intervals of 40 outer steps
   through ``make_crm_fsi_advance_persistent`` with ``whole_outer`` on and
   then off (dv "last"), each interval printed as the demo prints it, the
   steady-state RTF, a profiled chunk (ms and kernels an outer step, the
   multibody step's share), checked for overflow, finite values, walls
   unmoved, rigid markers at x_b + R ξ, the Drucker–Prager cone, joint
   violation, the rut, a bit-for-bit repeat, the engines against each
   other and the first 10 outer steps against the port on the CPU; then
   driven to the demo's 0.4 s (the chassis turns forward); (c) the same
   vehicle on phase 6's 10 × 4 × 0.2 m lane (1,400,335 markers), 1
   warm-up and 2 timed intervals on each engine with the same checks;
14. wheeled vehicles and rovers (no kernel on their path): (a) the HMMWV
   double lane change of demos/demo_vehicle_dlc.py for 200 steps through
   ``run_closed_loop``'s CUDA graph (twice, bit for bit), eagerly
   (equal to the graph) and on the CPU (within the float32 floor); (b)
   its 15,000 steps through the graph, timed, one step profiled eager and
   replayed, held to the JAX demo's outcome (tools/dlc_reference.py);
   (c) Curiosity on SCM (tests/test_models_modal.py's scene) for 1,500
   steps through a graph of ``rover_step_scm`` with that test's checks,
   twice bit for bit, 50 steps card against CPU, the SCM pass alone
   timed, and the DBP rig of tests/test_dbp.py with its checks; (d) the
   Polaris wishbone build and the sedan, 300 steps card against CPU;
15. the neighbour-list (gather) backend (no kernel on its path): (a) at
   the JAX tests' sizes, the card against the port on the CPU, two runs
   on the card bit for bit and the lists equal at step 0: the floating
   block of tests/test_fsi.py (20 outer steps of ``make_fsi_advance_fn``,
   10 with ISPH), the periodic column of tests/test_sph.py (3 cycles of
   ``make_sph_advance_fn``) and the wheel bed (4 outer steps of
   ``crm_fsi_step`` on the gather engine); (b) config #4's rigid body at
   d0 = 0.006 (85,660 markers; cells of W/16, 96 neighbours, 32 a cell,
   48 for the heavy block): the light block for 0.4 s and the heavy one
   for 0.25 s with
   tests/test_fsi.py's checks, overflow 0 at every rebuild, the floor
   unmoved, the rigid markers on their body, ms an outer step and one
   profiled outer step by part; (c) phase 4's dam break through
   ``make_sph_advance_fn`` (64 a cell, 96 neighbours), 1 warm-up and 2
   timed cycles with phase 4's checks, marker-steps/s and peak memory,
   and one substep against phase 4's CUDA sweeps; (d) config #5's demo
   bed on CRM's default engine (``make_crm_fsi_advance_fn``, gather):
   bench_crm's 6 intervals with phase 13's checks and RTF, and the first
   10 outer steps against the pencil engine;
16. the DEM system on the neighbour list (no kernel on its path): (a) the
   card against the port on the CPU after 3 cycles, and two card runs bit
   for bit: each of the four integrators with each friction mode on
   tests/test_dem.py's 1 m box, Schwartz and elastic–plastic rolling
   against phase 9's walls without the wheel, the user force model,
   ``sphere_mesh_forces`` on a ramp of two triangles, and 20 outer steps
   of tests/test_granular_terrain.py's coupled wheel; (b) ``bench.py``'s
   gather engine at 1,000,000 spheres through ``make_dem_state`` and
   ``make_advance_fn`` (12 neighbours, 16 a cell, skin 0.3, 100 substeps
   a cycle), 1 warm-up and 2 timed cycles with phase 2's checks,
   particle-steps/s, peak memory and one profiled cycle (the rebuild and
   the substeps apart); (c) the same spheres through ``DEMSystem`` with
   its defaults (multi-step friction, centred differences, dt from
   ``suggest_step_size``), two timed ``advance`` calls of a cycle; (d)
   demos/demo_dem_dam_break.py on the port (2,380 spheres, 12 frames of
   0.05 s, PLY frames through ``export_particle_sequence``) held to the
   JAX demo's count, dt, fronts and kinetic energies
   (tools/dem_dam_break_reference.py); (e) the granular rig's 550 outer
   steps with its test's assertions, and the same wheel on a 2.0 × 0.5 ×
   0.1 m bed of r = 5 mm spheres, 200 timed outer steps of 20 substeps.
17. convex contact, tracked vehicles and the other steppers (no kernel on
   their path): (a) the card against the port on the CPU and two card runs
   bit for bit: 1,000 random MPR pairs over the five convex kinds (float64
   within MPR's tolerance, the ill-conditioned pairs, whose CPU answer
   moves past it when positions and orientations move by 1e-9 or 1e-7,
   excluded; float32 bit for bit and finite), 25 ``nsc_step``s of the
   capsule on a box and of the cylinder on the mesh ramp (float64, card
   against CPU, the first 10 steps of two card runs bit for bit), HHT on
   the stiff spring (the Newton iterations and ``h_used`` of every step
   equal), RK4 on the gyroscope and the hydraulic actuator; (b) the M113
   acceleration run (btest_VEH_m113Acc: 3,000 steps of 2 ms at 6,000 N·m
   a sprocket) through ``m113_acceleration_run``'s CUDA graph of
   ``tracked_step``, twice bit for bit, 200 eager steps against the graph,
   timed (ms a step, kernels a step, RTF) and held to the JAX run's speeds
   (tools/m113_reference.py), then ``build_marder`` with
   tests/test_model_decks.py's checks; (c) tests/test_tracked.py's geared
   single-pin rig (ω 6 rad/s, μ_rim 0.1, the gear on) for 8 steps (1.15 s
   a step on the card), timed (ms, kernels and host reads a step),
   checked finite and for loop integrity (pin distances within 15 % of the
   pitch), its first 6 card steps each stepped once on the CPU.
18. robots and model files (no kernel on their path): (a)
   demos/demo_industrial_arm.py whole (the 6R arm, its poly345
   trajectory sampled by IK at 49 points, 200 settling and 750 running
   steps of 2 ms on the direct solver) through two CUDA graphs, twice bit
   for bit, against an eager loop over the settling and the first 100
   running steps, its end pose and tracking error held to the JAX run's
   (tools/arm_reference.py), finite, joint violation below 1e-3; (c)
   tests/test_robots.py's copter (hover, climb, yaw) and turtlebot
   (straight, turning) scenes through captured steps with that file's
   assertions, against the port on the CPU; (d) the IMU, GPS and
   tachometer on (c)'s turtlebot, noise-free card against CPU and noisy
   moments from a seeded generator; a 360 × 16 lidar scan and a 64 × 48
   depth image of a 20,000-triangle height field with boxes, spheres and
   a plane, card against CPU, timed; (e) URDF, OpenSim and ADAMS decks
   written here, built on the card and run 200 steps through
   ``simulate`` against the CPU; ``python -m chrono_tpu_torch.run`` on an
   MBS and a DEM spec (two processes started with the phase) and what
   they wrote; (a)'s model through ``archive_out`` / ``archive_in``; (b)
   demos/demo_robosimian_drive.py at full width (33 moving bodies, 32
   motors, APGD 60) on a driving table written here, for the demo's 500
   steps or, when the first 50 say those would not fit what is left of
   the phase's 145 s, the test's 300: tests/test_robosimian.py's
   locomotion bounds and the JAX run's advance
   (tools/robosimian_reference.py), timed (ms, kernels and host reads a
   step).

It prints the card's name and power limit, the build time, the errors and
times, one JSON line describing each kernel (with its bound: the least time
the card could take for the same work), and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from chrono_tpu_torch import convert
from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.dem.bc import (
    CONTACTS, DEMBoundaries, box_boundaries, n_walls,
)
from chrono_tpu_torch.dem.cell_dense import (
    forces_substep, from_cells, integrate_rows, make_cell_dense_advance,
    pair_coefs, substep_coefs, to_cells, to_rows, wall_rows,
)
from chrono_tpu_torch.dem.forces import _cross, _pair_force
from chrono_tpu_torch.dem.mesh import (
    bin_triangles_numpy, make_triangle_mesh, sphere_mesh_forces,
)
from chrono_tpu_torch.dem.params import DEMMaterial, DEMParams
from chrono_tpu_torch.dem.system import (
    DEMSystem, SubstepBlock, make_advance_fn, make_dem_state,
    rebuild_neighbors,
)
from chrono_tpu_torch.fsi import bce as fsi_bce
from chrono_tpu_torch.fsi.active import ActiveDomainSpec
from chrono_tpu_torch.fsi.crm_terrain import (
    CRMFSIState, MBSStep, bce_extras, crm_fsi_step, make_crm_fsi_advance_fn,
    make_crm_fsi_advance_persistent, make_crm_terrain_state, rigid_slots,
    wheel_bce_markers,
)
from chrono_tpu_torch.fsi.crm_terrain import (
    body_forces_planes as fsi_body_forces,
)
from chrono_tpu_torch.fsi.sph.crm import CRMParams
from chrono_tpu_torch.fsi.sph.crm_pencil import (
    cells_to_crm_state, make_crm_advance_pencil, make_crm_engine,
    make_crm_substeps_pencil,
)
from chrono_tpu_torch.fsi.sph.pencil import (
    bin_to_cells, make_sph_advance_pencil, state_to_cells,
)
from chrono_tpu_torch.fsi.sph.state import (
    BOUNDARY, FLUID, RIGID_BCE, SPHParams,
)
from chrono_tpu_torch.fsi.sph.system import (
    make_sph_advance_fn, make_sph_state, rebuild_sph_neighbors, sph_substep,
    suggest_sph_dt,
)
from chrono_tpu_torch.fsi.sph import kernels as sph_kernels
from chrono_tpu_torch.fsi.sph import wcsph as sph_wcsph
from chrono_tpu_torch.fsi.system import FSIState, make_fsi_advance_fn
from chrono_tpu_torch.dem.neighbors import build_neighbor_list
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda import crm_substep as crm
from chrono_tpu_torch.ops.cuda import sph_substep as sph
from chrono_tpu_torch.dem.rows import (
    CellRows, neighbour_runs, rows_from_prefix_slots, rows_from_slots,
    rows_to_planes,
)
from chrono_tpu_torch.ops.cuda.dem_forces import (
    dem_forces, dem_forces_plain, dem_forces_rows, dem_forces_rows_plain,
)
from chrono_tpu_torch.ops.cuda.dem_substep import (
    dem_substep, dem_substep_plain, dem_substep_rows, dem_substep_rows_plain,
)
from chrono_tpu_torch.ops.cuda import nsc_detect as nd
from chrono_tpu_torch.ops.cuda import nsc_sweep as ns
from chrono_tpu_torch.ops.cuda.migrate import (
    dem_migrate, dem_migrate_plain, dem_migrate_rows, dem_migrate_rows_plain,
)
from chrono_tpu_torch.ops.nsc_pair import wall_geometry
from chrono_tpu_torch.collision import (
    BoxShapes, CollisionModel, ConvexShapes, MeshShapes, SphereShapes,
    nsc_step,
)
from chrono_tpu_torch.collision.mpr import ConvexShape, mpr_contact
from chrono_tpu_torch.collision.cell_list import cell_occupancy_max
from chrono_tpu_torch.core.functions import FConst
from chrono_tpu_torch.physics import SystemBuilder
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics.explicit import step_rk4
from chrono_tpu_torch.physics.external import (
    HydraulicParams, make_hydraulic_actuator, make_ode_coupled_step,
)
from chrono_tpu_torch.physics.implicit import make_hht_mbs_step
from chrono_tpu_torch.physics.smc import SMCParams, smc_step
from chrono_tpu_torch.physics.joints import JOINT_TYPES, joint_violation
from chrono_tpu_torch.physics.system import (
    SolverSettings, init_stab_state, simulate,
    step_euler_implicit_linearized,
)
from chrono_tpu_torch.solver import vi as tvi
from chrono_tpu_torch.solver.nsc_pencil import (
    NSCPencilParams, make_nsc_pencil_advance, nsc_static_params,
)
from chrono_tpu_torch.io import (
    CSVWriter, FrameWriter, archive_in, archive_out, build_from_urdf,
    export_particle_sequence, load_adm, load_osim,
)
from chrono_tpu_torch.utils.samplers import grid_sample_box, hcp_sample_box
from chrono_tpu_torch.vehicle.suspension import (
    WishboneHardpoints, add_double_wishbone_corner,
)
from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.models import (
    build_m113, build_marder, create_curiosity, create_hmmwv,
    create_polaris, create_sedan, m113_acceleration_run, rover_step_scm,
    set_wheel_speeds,
)
from chrono_tpu_torch.models.industrial import (
    Arm6R, create_arm_6dof, fk_6r, joint_programs_from_trajectory,
    make_trajectory, traj_eval,
)
from chrono_tpu_torch.models.robosimian import (
    WHEEL_RADIUS, create_robosimian, gait_programs,
)
from chrono_tpu_torch.models.robots import (
    copter_hover_omega, copter_step, create_copter, create_turtlebot,
    set_turtlebot_speeds, turtlebot_step,
)
from chrono_tpu_torch.sensors import (
    RayScene, depth_image, gps_read, imu_read, lidar_scan, make_gps,
    make_imu, tachometer_read,
)
from chrono_tpu_torch.utils.graph import capture
from chrono_tpu_torch.utils.tree import fields_as_tensors
from chrono_tpu_torch.vehicle import (
    PathFollower, SCMParams, SpeedController, double_lane_change_path,
    flat_terrain, make_scm_state, run_dbp_rig, scm_wheel_forces,
    straight_path,
)
from chrono_tpu_torch.vehicle.closed_loop import (
    closed_loop_step, run_closed_loop,
)
from chrono_tpu_torch.vehicle.granular_terrain import (
    GranularFSIState, make_granular_advance_fn, make_granular_terrain_state,
)
from chrono_tpu_torch.vehicle.track_shoes import (
    add_segmented_track, ground_shape, make_sprocket_gear,
    matched_track_span, sprocket_gear_contacts, track_collision_shapes,
)
from chrono_tpu_torch.vehicle.tracked import tracked_step

DEV = torch.device("cuda", 0)
G = 9.81
# fp32 pair sums in another order: the tolerances the JAX package holds its
# own backends to (tests/test_pallas_kernel.py)
POS_TOL = dict(rtol=1e-4, atol=1e-5)
VEL_TOL = dict(rtol=1e-3, atol=1e-4)
# SPH: the tolerances tests/test_sph_pencil.py holds the JAX backends to
# (ρ rtol 2e-5 / atol 1e-3; v rtol 1e-4 / atol 2e-5·max|v|; x rtol 1e-6 /
# atol 1e-7); the Adami planes are held as velocities are
SPH_RHO_TOL = dict(rtol=2e-5, atol=1e-3)
SPH_POS_TOL = dict(rtol=1e-6, atol=1e-7)
SPH_VEL_RTOL, SPH_VEL_ATOL = 1e-4, 2e-5
# the published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
# rates a later phase prints beside its own: phase 4's dam break, phase
# 13's config #5
RATES = {}
PEAK_F32_S = 67e12
KERNELS = ("dem_substep", "migrate", "sph_substep", "crm_substep",
           "crm_outer", "nsc_detect", "nsc_sweep", "dem_forces")
# the sources whose pair walks the counter build (-DPAIR_COUNTERS,
# csrc/cell_pairs.cuh) tallies
COUNTED = ("sph_substep", "crm_substep", "crm_outer")


def require(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def check_close(got, ref, rtol, atol, what):
    """Raise unless |got − ref| ≤ atol + rtol·|ref| everywhere; return
    max |got − ref| and the largest ratio of |got − ref| to that tolerance
    (≤ 1 passes)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    err = (got - ref).abs()
    tol = atol + rtol * ref.abs()
    bad = err > tol
    require(not bool(bad.any()) and bool(torch.isfinite(got).all()),
            f"{what}: {int(bad.sum())} values off, max err {float(err.max())}")
    ratio = torch.where(err > 0, err / tol, torch.zeros_like(err))
    return float(err.max()), float(ratio.max())


def assert_close(got, ref, rtol, atol, what):
    """``check_close``'s max |got − ref|."""
    return check_close(got, ref, rtol, atol, what)[0]


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


def bench_params():
    """bench.py's spheres and material: r = 5 mm, ρ = 2500, E = 1e7,
    ν 0.3, e 0.5, μ 0.5 (walls alike), dt = 2e-6, 100 substeps a cycle,
    single-step friction."""
    radius = 0.005
    mat = DEMMaterial(youngs=1e7, poisson=0.3, restitution=0.5, mu_s=0.5)
    return DEMParams(radius=radius,
                     mass=2500.0 * 4.0 / 3.0 * np.pi * radius ** 3,
                     material=mat, wall_material=mat,
                     gravity=(0.0, 0.0, -G), dt=2e-6, rebuild_every=100,
                     friction_mode="single_step")


def bench_scene(n_target=1_000_000):
    """bench.py's pinned scene (bench.py:83-158, flat engine): spheres of
    5 mm on a jittered 2.1 r lattice, cells of two lattice spacings with the
    origin at (r, r, r), z trimmed to the bed, C = 8."""
    params = bench_params()
    radius = params.radius
    spacing = 2.1 * radius
    n_side = int(np.ceil(n_target ** (1 / 3)))
    box_w = n_side * spacing * 1.02
    box_h = box_w * 1.6
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


def five_kind_walls():
    """Numpy leaves of one wall of each kind around a 0.52 m cube of
    0.13 m cells: a conveyor floor, a z-cylinder, a cone opening +z below
    the floor, a spherical obstacle and a sinking, spinning wheel."""
    f32 = np.float32
    return {
        "planes": {"point": np.zeros((1, 3), f32),
                   "normal": np.array([[0.0, 0.0, 1.0]], f32),
                   "vel": np.array([[0.2, 0.0, 0.0]], f32)},
        "cylinders": {"center": np.array([[0.26, 0.26]], f32),
                      "radius": np.array([0.25], f32),
                      "vel": np.zeros((1, 3), f32)},
        "spheres": {"center": np.array([[0.26, 0.26, 0.30]], f32),
                    "radius": np.array([0.07], f32),
                    "vel": np.zeros((1, 3), f32)},
        "cones": {"apex": np.array([[0.26, 0.26, -0.12]], f32),
                  "slope": np.array([1.6], f32),
                  "vel": np.zeros((1, 3), f32)},
        "wheels": {"center": np.array([[0.26, 0.26, 0.46]], f32),
                   "axis": np.array([[1.0, 0.0, 0.0]], f32),
                   "radius": np.array([0.06], f32),
                   "half_width": np.array([0.12], f32),
                   "vel": np.array([[0.0, 0.0, -0.2]], f32),
                   "omega": np.array([[6.0, 0.0, 0.0]], f32)}}


def five_kind_scene(n=120, seed=4):
    """``(params, bcs, grid, pos, C)``: n particles of r = 5 cm drawn
    uniformly in the cylinder, each at most 0.4 r deep in any wall, so that
    every kind has contacts from the start; single-step friction with a
    wall μ (0.3) unlike the particles' (0.5); 4 substeps per cycle."""
    bcs = convert.dem_boundaries_from_numpy(five_kind_walls())
    radius = 0.05
    rng = np.random.default_rng(seed)
    pos = np.zeros((0, 3), np.float32)
    while len(pos) < n:
        cand = rng.uniform((0.0, 0.0, 0.03), (0.52, 0.52, 0.50),
                           (4 * n, 3)).astype(np.float32)
        gap = wall_gaps(bcs, torch.from_numpy(cand), radius)
        pos = np.concatenate([pos, cand[(gap > -0.4 * radius).all(1)]])
    params = DEMParams(radius=radius, mass=1.0,
                       material=DEMMaterial(mu_s=0.5),
                       wall_material=DEMMaterial(mu_s=0.3),
                       gravity=(0.0, 0.0, -G), dt=2e-5, rebuild_every=4,
                       friction_mode="single_step")
    return (params, bcs, GridSpec(cell_size=0.13, dims=(4, 4, 4)),
            pos[:n], 16)


def wall_gaps(bcs, pos, radius):
    """(N, B) signed surface gaps of every particle to every wall."""
    return torch.cat([CONTACTS[k](getattr(bcs, k).to(pos.device), pos,
                                  radius).gap for k in bcs.kinds()], dim=1)


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


def k2_rows_binned(seed, capacity, device=None):
    """The 120-particle box binned at ``capacity`` as the main path bins
    it: ``(params, bcs, grid, rows, ids, feat, slot ids)``, the rows with
    their particle ids (−1 on dead rows), and the slot planes and slot ids
    they came from."""
    dev = device or DEV
    params, bcs, grid, pos, _ = small_scene(seed)
    z = torch.zeros(pos.shape, device=dev)
    field = to_cells(grid, capacity, torch.as_tensor(pos, device=dev), z, z)
    rows, ids = rows_and_ids(field, len(pos))
    return params, bcs, grid, rows, ids, field.feat, field.ids


def state_digest(*arrays):
    """sha256 of the arrays' bytes, in order: equal digests, equal bits."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def rows_and_ids(field, n):
    """Rows of ``to_cells``'s slots (R = n + 1) and each row's particle id,
    as ``make_cell_dense_advance`` lays them out before its first cycle."""
    rows, row_of_slot = rows_from_prefix_slots(
        field.feat, (field.feat[9] > 0.5).sum(1), n + 1)
    ids = torch.full((n + 1,), -1, dtype=torch.int32, device=rows.cell.device)
    ids[row_of_slot] = field.ids.reshape(-1)
    return rows, ids


def k2_slot_path(rows, feat, slot_ids, grid):
    """K2 as the main path ran it through PR 10: the rows' state scattered
    into the slot planes, the slot kernel ``dem_migrate`` (its twin on the
    CPU), rows of its output: ``((rows', ids', landed), planes', slot
    ids')``."""
    n_rows = rows.n_rows
    _, row_of_slot = rows_from_prefix_slots(feat, rows.table[:, 1], n_rows)
    feat = feat.clone()
    feat[0:9] = rows_to_planes(rows.state, row_of_slot).reshape(
        9, *feat.shape[1:])
    moved, moved_ids = torch.empty_like(feat), torch.empty_like(slot_ids)
    landed = torch.empty(grid.n_cells, dtype=torch.int32, device=feat.device)
    dem_migrate(feat, slot_ids, moved, moved_ids, landed, grid)
    out, row_of_slot = rows_from_prefix_slots(moved, landed, n_rows)
    ids = torch.full((n_rows,), -1, dtype=torch.int32, device=feat.device)
    ids[row_of_slot] = moved_ids.reshape(-1)
    return (out, ids, landed), moved, moved_ids


def k2_rows_run(rows, ids, grid, capacity):
    """``dem_migrate_rows`` into new buffers: ``(rows', ids', landed)``."""
    out = CellRows(state=torch.empty_like(rows.state),
                   cell=torch.empty_like(rows.cell),
                   table=torch.empty_like(rows.table))
    ids_out = torch.empty_like(ids)
    landed = torch.empty(grid.n_cells, dtype=torch.int32,
                         device=ids.device)
    dem_migrate_rows(rows, ids, out, ids_out, landed, grid, capacity)
    return out, ids_out, landed


def k2_rows_differ(got, ref):
    """The parts of two migrations' ``(rows, ids, landed)`` that differ."""
    (r, i, n), (rr, ri, rn) = got, ref
    parts = {"state": (r.state, rr.state), "cell": (r.cell, rr.cell),
             "table": (r.table, rr.table), "ids": (i, ri),
             "landed": (n, rn)}
    return [k for k, (a, b) in parts.items() if not torch.equal(a, b)]


def k2_rows_check(rows, ids, grid, capacity, feat, slot_ids, what):
    """``dem_migrate_rows`` against its twin and against the slot path,
    bit for bit: ``(its output, slot planes', slot ids')``."""
    got = k2_rows_run(rows, ids, grid, capacity)
    twin = dem_migrate_rows_plain(rows, ids, grid, capacity)
    slot, feat, slot_ids = k2_slot_path(rows, feat, slot_ids, grid)
    for name, ref in (("its twin", twin), ("the slot path", slot)):
        bad = k2_rows_differ(got, ref)
        require(not bad, f"dem_migrate_rows, {what}: {', '.join(bad)} "
                f"differ from {name}")
    return got, feat, slot_ids


def k2_rows_cycles(capacity, stir, device=None):
    """6 cycles of K1 on the box's rows, each ended by ``dem_migrate_rows``,
    held to its twin and to the slot path bit for bit; with ``stir`` each
    live particle also moves by up to 0.45 cell per axis (seed 3) before
    the migration.  Returns the particles that changed cell, by id, and
    the largest landing count."""
    params, bcs, grid, rows, ids, feat, slot_ids = k2_rows_binned(
        11, capacity, device)
    coefs = substep_coefs(params, bcs, grid, capacity)
    rng = np.random.default_rng(3)
    n = rows.n_rows - 1
    changed, most = 0, 0
    for cycle in range(6):
        state = rows.state
        for _ in range(params.rebuild_every):
            nxt = torch.zeros_like(state)
            dem_substep_rows(replace(rows, state=state), nxt, coefs)
            state = nxt
        if stir:
            kick = torch.as_tensor(rng.uniform(-0.45, 0.45, (n + 1, 3))
                                   * grid.cell_size, dtype=torch.float32,
                                   device=state.device)
            state = state.clone()
            state[0, :, :3] += torch.where((rows.cell >= 0)[:, None], kick,
                                           0.0)
        rows = replace(rows, state=state)
        got, feat, slot_ids = k2_rows_check(
            rows, ids, grid, capacity, feat, slot_ids,
            f"C={capacity}, cycle {cycle}")
        cell_of = [torch.full((n + 2,), -1, dtype=torch.int32,
                              device=state.device) for _ in range(2)]
        cell_of[0][ids.long()] = rows.cell          # dead rows: index −1
        cell_of[1][got[1].long()] = got[0].cell
        changed += int(((cell_of[0] != cell_of[1]) & (cell_of[0] >= 0)
                        & (cell_of[1] >= 0))[:n].sum())
        most = max(most, int(got[2].max()))
        rows, ids = got[0], got[1]
    return changed, most


def k2_rows_jump(device=None):
    """A particle moved two cells along x is found by no cell: the kernel,
    its twin and the slot path all lose it.  Returns the loss."""
    _, _, grid, rows, ids, feat, slot_ids = k2_rows_binned(11, 16, device)
    nx, ny, nz = grid.dims
    require(int(rows.cell[0]) // (ny * nz) + 2 < nx,
            "row 0 cannot jump two cells along x")
    state = rows.state.clone()
    state[0, 0, 0] += 2.0 * grid.cell_size
    rows = replace(rows, state=state)
    (out, out_ids, landed), _, _ = k2_rows_check(
        rows, ids, grid, 16, feat, slot_ids, "a two-cell jump")
    loss = int(rows.table[:, 1].sum()) - int(landed.sum())
    m = int(out.table[:, 1].sum())
    require(m == int(landed.sum()) and not bool((out_ids == ids[0]).any())
            and bool((out.cell[m:] == -1).all())
            and not bool(out.state[:, m:].any()),
            "dem_migrate_rows: the jumped particle was not dropped cleanly")
    return loss


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


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# What float32 may lose on one pair, which the reference moves its inputs
# by: the kernel's |d| (three squares, two sums, an rsqrt and a product)
# is good to ~4.2 ulp of 2r and its relative velocity to ~3·2⁻²⁴ of the
# speeds it sums; the reference takes twice that.  The rest of a pair's
# float32 arithmetic is held at test_pallas_kernel's rtol.
D_ULPS = 8
V_EPS = 8 * 2.0 ** -24
F32_RTOL = 1e-4
F32_EPS = 2.0 ** -23        # an ulp of x is at most F32_EPS·|x|
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def f32(x):
    return float(np.float32(x))


def pair_reference(feat, c, chunk_elems=2 ** 25):
    """The pair forces and torques of (10, n_cells, C) float32 planes in
    float64, with ``c``'s constants rounded to float32 as the kernels take
    them, and the tolerance float32 supports: per slot and component, the
    sum over the slot's pairs of, for each component of the pair's
    displacement and of its relative velocity, the larger change of f when
    that component moves by ±D_ULPS ulp of 2r or ±V_EPS of the summed
    speeds, plus F32_RTOL·|f| (r·|f| for torques, whose normal part cancels
    only in exact arithmetic) at the largest |f| of those moves.  Returns
    ``(ref, tol)``, each (6, n_cells, C), and the overlaps of the contacts,
    each pair from both of its sides.  Works on slabs of x with at most
    ``chunk_elems`` pairs per offset."""
    nx, ny, nz = c.dims
    C = feat.shape[2]
    g = feat.double().reshape((10, nx, ny, nz, C))
    P = torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1, 1, 1))
    r, kn, gn, kt, gt, mu, dt = (f32(getattr(c, k)) for k in
                                 ("radius", "kn", "gn", "kt", "gt", "mu",
                                  "dt"))
    eps_d = D_ULPS * float(np.spacing(np.float32(2.0 * r)))
    not_self = ~torch.eye(C, dtype=torch.bool, device=feat.device)
    ref = g.new_zeros((6, nx, ny, nz, C))
    tol = g.new_zeros((6, nx, ny, nz, C))
    overlaps = []
    step = max(1, chunk_elems // (ny * nz * C * C))
    for i0 in range(0, nx, step):
        i1 = min(nx, i0 + step)
        me = g[:, i0:i1, ..., :, None]
        for dx, dy, dz in _OFFSETS:
            nb = P[:, 1 + dx + i0:1 + dx + i1, 1 + dy:1 + dy + ny,
                   1 + dz:1 + dz + nz, None, :]
            ok = (me[9] > 0.5) & (nb[9] > 0.5)
            if (dx, dy, dz) == (0, 0, 0):
                ok &= not_self
            d0 = [nb[a] - me[a] for a in range(3)]
            dv = [nb[3 + a] - me[3 + a] for a in range(3)]
            ws = [nb[6 + a] + me[6 + a] for a in range(3)]
            speed = sum(nb[3 + a].abs() + me[3 + a].abs() + r * ws[a].abs()
                        for a in range(3))

            def pair(d, vshift):
                dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                inv = torch.rsqrt(dist2 + 1e-18)
                overlap = 2.0 * r - dist2 * inv
                on = ok & (overlap > 0)
                nh = [a * inv for a in d]
                delta = torch.clamp(overlap, min=0.0)
                arm = r - 0.5 * delta
                cr = _cross(ws, nh)
                vr = [dv[a] - arm * cr[a] + vshift[a] for a in range(3)]
                pf = _pair_force(nh, delta, vr, on, kn, gn, kt, gt, mu, dt,
                                 c.friction)
                size = torch.sqrt(pf[0] * pf[0] + pf[1] * pf[1]
                                  + pf[2] * pf[2])
                return [*pf, *(arm * t for t in _cross(nh, pf))], \
                    overlap[on], (size, arm * size)

            zero = (0.0, 0.0, 0.0)
            base, ov, (size, moment) = pair(d0, zero)
            overlaps.append(ov)
            lost = [torch.zeros_like(size)] * 6
            for a in range(3):
                for moved in ("d", "v"):
                    most = None
                    for sign in (-1.0, 1.0):
                        if moved == "d":
                            d = list(d0)
                            d[a] = d0[a] + sign * eps_d
                            out, _, (sz, mo) = pair(d, zero)
                        else:
                            vs = [0.0] * 3
                            vs[a] = sign * V_EPS * speed
                            out, _, (sz, mo) = pair(d0, vs)
                        size = torch.maximum(size, sz)
                        moment = torch.maximum(moment, mo)
                        ch = [(o - b).abs() for o, b in zip(out, base)]
                        most = ch if most is None else \
                            [torch.maximum(m, x) for m, x in zip(most, ch)]
                    lost = [x + m for x, m in zip(lost, most)]
            # a component of f or of its moment sums terms as large as |f|
            # or r·|f|, whatever the cancellation among them, and a contact
            # that float32 may see where float64 does not brings its own
            lost = [x + F32_RTOL * m for x, m in
                    zip(lost, [size] * 3 + [moment] * 3)]
            for k in range(6):
                ref[k, i0:i1] += base[k].sum(-1)
                tol[k, i0:i1] += lost[k].sum(-1)
    shape = (6,) + tuple(feat.shape[1:])
    return ref.reshape(shape), tol.reshape(shape), torch.cat(overlaps)


def tol_ratio(got, ref, tol):
    """``(max |got − ref|, max |got − ref| / tol)``: ≤ 1 passes, and a
    difference where ``tol`` is 0 counts as infinitely far."""
    err = (got.double() - ref).abs()
    ratio = torch.where(err > 0, err / tol, torch.zeros_like(err))
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf")
    return float(err.max()), float(ratio.max())


def planted_faults(c, overlaps):
    """Two wrong kernels, as constants handed to the right one: kn 1 % low,
    and the contact radius short by half the median overlap, which drops
    every contact shallower than the median."""
    median = float(overlaps.median())
    return {"kn x 0.99": replace(c, kn=0.99 * c.kn),
            f"radius short by {0.5 * median:.3e} m":
                replace(c, radius=c.radius - 0.5 * median)}


# K1's float32 operations, counted from csrc/dem_substep.cu: per contact
# (Hertz normal + capped tangential force + torque) and per particle (the
# six walls' distance tests, gravity and the Euler update)
DEM_OPS_PER_CONTACT = 110
DEM_OPS_PER_PARTICLE = 80
# the TPU kernels K1 computes (rows 2, 4 and 5b of the kernel table): the
# fused substep in the flat-lane, symmetric-pencil and dense-pencil layouts
DEM_SUBSTEP_REPLACES = ("chrono_tpu/ops/pallas/dem_flat_kernel.py:169",
                        "chrono_tpu/ops/pallas/dem_sym_kernel.py:330",
                        "chrono_tpu/ops/pallas/dem_pencil_kernel.py:306")
# and those dem_forces computes (rows 5a and 6): the pair forces alone
DEM_FORCES_REPLACES = ("chrono_tpu/ops/pallas/dem_pencil_kernel.py:245",
                       "chrono_tpu/ops/pallas/dem_cell_kernel.py:186")


def k1_reference(feat, coefs):
    """K1's next planes in float64 from the pair reference, and per value
    the tolerance: the pair tolerance through dt/m and dt/I, an ulp of the
    output, and for positions dt times the velocity's tolerance.  Holds no
    wall force, so it is for states in which no particle touches a wall."""
    f, f_tol, overlaps = pair_reference(feat, coefs)
    x = feat.double()
    m = x[9]
    dt, inv_m, inv_I = (f32(getattr(coefs, k))
                        for k in ("dt", "inv_m", "inv_I"))
    g = torch.tensor([f32(a) for a in coefs.gravity], dtype=torch.float64,
                     device=feat.device).reshape(3, 1, 1)
    kick = dt * (f[0:3] * inv_m + g) * m
    spin = dt * f[3:6] * inv_I * m
    v2, w2 = x[3:6] + kick, x[6:9] + spin
    x2 = x[0:3] + dt * v2 * m
    v_tol = dt * inv_m * f_tol[0:3] + F32_EPS * (v2.abs() + kick.abs())
    w_tol = dt * inv_I * f_tol[3:6] + F32_EPS * (w2.abs() + spin.abs())
    x_tol = F32_EPS * x2.abs() + dt * v_tol
    ref = torch.cat([x2, v2, w2, x[9:]])
    tol = torch.cat([x_tol, v_tol * m, w_tol * m, torch.zeros_like(m)[None]])
    return ref, tol, overlaps


def row_stats(rows, dims, n_cells):
    """M, the launch grid, the occupied candidates per particle that the
    nine runs hold, and the least bytes a row pass must move besides its
    per-particle state: the (start, count) table."""
    m = int((rows.cell >= 0).sum())
    runs = neighbour_runs(rows.cell, rows.table, dims)
    cand = sum(int((hi - lo).sum()) for lo, hi in runs) - m
    blocks = (rows.n_rows + 255) // 256
    return {"M": m, "grid": f"{blocks} x 256",
            "candidates_per_particle": cand / max(m, 1),
            "table_bytes": 8 * n_cells}


def k1_at(params, bcs, grid, C, state, what, plain=True):
    """K1 against the float64 pair reference on the binned ``state`` (no
    particle may touch a wall), two planted faults that must fail that
    tolerance, K1's time on the state's rows (CUDA events), its twin's
    and its bound: ``(field, K1's output as slot planes, row)``."""
    field = to_cells(grid, C, *state)
    feat = field.feat
    coefs = substep_coefs(params, bcs, grid, C)
    require(float(wall_gaps(bcs, state[0], params.radius).min()) > 0.0,
            f"K1, {what}: a particle touches a wall, which the pair "
            "reference does not hold")
    ref, tol, overlaps = k1_reference(feat, coefs)
    out = torch.empty_like(feat)
    dem_substep(feat, out, coefs)
    err, ratio = tol_ratio(out, ref, tol)
    planes = {k: tol_ratio(out[sl], ref[sl], tol[sl])[1] for k, sl in
              (("x", slice(0, 3)), ("v", slice(3, 6)), ("ω", slice(6, 9)),
               ("mask", slice(9, 10)))}
    require(ratio <= 1.0, f"K1, {what}: {planes} of its tolerance")
    faults = {}
    bad_out = torch.empty_like(feat)
    for name, bad in planted_faults(coefs, overlaps).items():
        dem_substep(feat, bad_out, bad)
        faults[name] = tol_ratio(bad_out, ref, tol)[1]
        require(faults[name] > 1.0, f"K1, {what}: the planted fault {name} "
                f"passes ({faults[name]:.3f} of the tolerance)")
    del ref, tol, bad_out
    rows, _ = rows_from_slots(feat)
    nxt = torch.empty_like(rows.state)
    ms = cuda_ms(lambda: dem_substep_rows(rows, nxt, coefs), 20)
    plain_ms = cuda_ms(lambda: dem_substep_rows_plain(rows, coefs), 3) \
        if plain else None
    st = row_stats(rows, grid.dims, grid.n_cells)
    n_slots = feat.shape[1] * C
    contacts = len(overlaps)
    # the occupied particles' 9 floats in and out, and the per-cell table
    b = bound(2 * 9 * 4 * st["M"] + st["table_bytes"],
              contacts * DEM_OPS_PER_CONTACT
              + st["M"] * DEM_OPS_PER_PARTICLE)
    plain_txt = f" (plain twin {plain_ms:.4f} ms)" if plain else ""
    print(f"K1, {what}: max abs err {err:.3e} against the float64 pair "
          "reference (of its tolerance: "
          + ", ".join(f"{k} {v:.4f}" for k, v in planes.items())
          + "; planted faults "
          + ", ".join(f"{k} {v:.2f}" for k, v in faults.items())
          + f" of it), {ms:.4f} ms per launch{plain_txt}, {contacts} "
          f"contacts (both sides, median overlap "
          f"{float(overlaps.median()):.3e} m) among M = {st['M']} "
          f"particles in {n_slots} slots, grid {st['grid']}, "
          f"{st['candidates_per_particle']:.2f} occupied candidates a "
          f"particle, bound {b[0]:.4f} ms by {b[1]}")
    return field, out, {"max_abs_err": err, "err_over_tol": ratio,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                        "bound_by": b[1], "M": st["M"]}


def main_path(card):
    params, bcs, grid, pos, C = bench_scene()
    n = len(pos)
    print(f"main path: {n} particles, grid {grid.dims} "
          f"({grid.n_cells} cells x C={C}), rebuild_every "
          f"{params.rebuild_every}, dt {params.dt}")
    adv = make_cell_dense_advance(params, bcs, grid, capacity=C,
                                  migrate=True, device=DEV)
    z = np.zeros_like(pos)
    dem_substep_rows.launches = dem_migrate.launches = 0
    dem_migrate_rows.launches = 0
    p, v, o, ovf = adv(pos, z, z, 1)                       # warm-up cycle
    require(int(ovf) == 0, f"warm-up overflow {int(ovf)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, v, o, ovf = adv(p, v, o, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dem_substep": dem_substep_rows.launches,
                "dem_migrate_rows": dem_migrate_rows.launches,
                "dem_migrate": dem_migrate.launches}
    require(int(ovf) == 0, f"overflow or loss {int(ovf)}")
    require(all(bool(torch.isfinite(a).all()) for a in (p, v, o)),
            "non-finite state")
    require(launches == {"dem_substep": 300, "dem_migrate_rows": 3,
                         "dem_migrate": 0}, f"launch counts {launches}")
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
    print(f"main path: final (pos, vel, omega) sha256 "
          f"{state_digest(p, v, o)}")

    # each kernel against its twin at the main path's shapes
    field, _, k1 = k1_at(params, bcs, grid, C, (p, v, o), "at 1M")

    k2_rows, k2 = k2_at(params, bcs, grid, C, field)
    return [
        {"name": "dem_substep", "route": "cuda",
         "source": "chrono_tpu_torch/csrc/dem_substep.cu",
         "replaces": "; ".join(DEM_SUBSTEP_REPLACES),
         "launches": launches["dem_substep"], **k1, "library_ms": None},
        {"name": "dem_migrate_rows", "route": "cuda",
         "source": "chrono_tpu_torch/csrc/migrate.cu",
         "replaces": K2_REPLACES,
         "launches": launches["dem_migrate_rows"], **k2_rows,
         "library_ms": None},
        {"name": "dem_migrate", "route": "cuda",
         "source": "chrono_tpu_torch/csrc/migrate.cu",
         "replaces": K2_REPLACES,
         "launches": launches["dem_migrate"], **k2, "library_ms": None,
         "note": "the slot-plane form; the main path runs dem_migrate_rows"},
    ]


K2_REPLACES = "chrono_tpu/ops/pallas/migrate_kernel.py:130"
# float32 operations of the key of a row: three subtractions, divisions,
# floors and clips and the id's two multiply-adds
K2_KEY_OPS = 14


def k2_walk_candidates(rows, dims):
    """The keys one walk of every destination cell's nine runs compares:
    each live row once for each in-grid cell within one of its own."""
    nx, ny, nz = dims
    c = rows.cell[rows.cell >= 0].long()
    i, j, k = c // (ny * nz), (c // nz) % ny, c % nz

    def span(x, n):
        return 1 + (x > 0).long() + (x < n - 1).long()

    return int((span(i, nx) * span(j, ny) * span(k, nz)).sum())


def k2_at(params, bcs, grid, C, field):
    """K2 at the main path's shapes: one cycle of K1 (``rebuild_every``
    substeps) on the rows of the binned state, then ``dem_migrate_rows``
    against its twin and against the slot path bit for bit; the row
    kernel, its twin, the slot kernel alone (on the same state's planes)
    and the slot path with its upkeep (scatter to planes, the slot kernel,
    rows of its output) timed with CUDA events; both kernels' bounds."""
    n = int((field.feat[9] > 0.5).sum())
    rows0, ids = rows_and_ids(field, field.perm.numel())
    coefs = substep_coefs(params, bcs, grid, C)
    state, spare = rows0.state, torch.zeros_like(rows0.state)
    for _ in range(params.rebuild_every):
        dem_substep_rows(replace(rows0, state=state), spare, coefs)
        state, spare = spare, state
    rows = replace(rows0, state=state)
    del spare
    got, planes, planes_ids = k2_rows_check(rows, ids, grid, C, field.feat,
                                            field.ids, "at 1M")
    moved = int((got[0].cell != rows.cell).sum())
    ms = cuda_ms(lambda: k2_rows_run(rows, ids, grid, C), 20)
    plain_ms = cuda_ms(lambda: dem_migrate_rows_plain(rows, ids, grid, C), 3)
    path_ms = cuda_ms(lambda: k2_slot_path(rows, field.feat, field.ids,
                                           grid), 20)
    # the slot kernel alone, on the planes of the same state
    _, row_of_slot = rows_from_prefix_slots(field.feat, rows.table[:, 1],
                                            rows.n_rows)
    feat = field.feat.clone()
    feat[0:9] = rows_to_planes(rows.state, row_of_slot).reshape(
        9, *feat.shape[1:])
    ids2, mig_out = torch.empty_like(field.ids), torch.empty_like(feat)
    count = torch.empty(grid.n_cells, dtype=torch.int32, device=DEV)
    dem_migrate(feat, field.ids, mig_out, ids2, count, grid)
    rf, ri, rc = dem_migrate_plain(feat, field.ids, grid)
    require(torch.equal(mig_out, rf) and torch.equal(ids2, ri)
            and torch.equal(count, rc), "K2 differs from its twin at 1M")
    del rf, ri, rc
    slot_ms = cuda_ms(lambda: dem_migrate(feat, field.ids, mig_out, ids2,
                                          count, grid), 20)
    slot_plain_ms = cuda_ms(lambda: dem_migrate_plain(feat, field.ids,
                                                      grid), 3)
    m_out = int(got[0].table[:, 1].sum())
    # rows: the live rows' state, cell and id in; every row out (the dead
    # ones zeroed); the table in, the table and landed out
    rows_bound = bound(56 * n + 56 * rows.n_rows + 20 * grid.n_cells,
                       K2_KEY_OPS * n + k2_walk_candidates(rows, grid.dims))
    n_slots = feat.shape[1] * C
    # slots: the planes and ids in and out, the per-cell count; its work is
    # comparisons, a few per candidate of each valid particle
    slot_bound = bound(2 * 11 * n_slots * 4 + grid.n_cells * 4, 27 * n)
    print(f"K2 at 1M after one cycle ({moved} of {m_out} rows changed "
          f"cell): dem_migrate_rows bit-exact against its twin and the "
          f"slot path, {ms:.4f} ms a call of its three launches (plain twin "
          f"{plain_ms:.4f} ms), bound {rows_bound[0]:.4f} ms by "
          f"{rows_bound[1]}; the slot path it replaced (scatter to planes, "
          f"dem_migrate, rows of its output) {path_ms:.4f} ms, of it "
          f"dem_migrate {slot_ms:.4f} ms (bit-exact, plain twin "
          f"{slot_plain_ms:.4f} ms, bound {slot_bound[0]:.4f} ms by "
          f"{slot_bound[1]}) on the same state")
    row = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": rows_bound[0], "bound_by": rows_bound[1],
           "slot_path_ms": path_ms}
    slot = {"max_abs_err": 0.0, "ms": slot_ms, "plain_ms": slot_plain_ms,
            "bound_ms": slot_bound[0], "bound_by": slot_bound[1]}
    return row, slot


# ---------------------------------------------------------------- phase 3


def mini_dam(viscosity, rebuild_every=4, device=None):
    """The mini dam of tests/test_sph_pencil.py: d0 = 0.02, a (W/2, W, H)
    fluid column with W = H = 0.12 in a 0.24-long tank, 3 floor layers,
    cells of 2h: 756 markers, on ``device`` (the card by default).  The
    laminar case takes a glycerol-like μ = 1 Pa·s, as tests/test_torch_sph.py
    does: water's 1e-3 moves v by ~1e-6 m/s per substep, below the velocity
    tolerance, so a wrong laminar term would pass."""
    d0, W, H, L = 0.02, 0.12, 0.12, 0.24
    params = SPHParams(d0=d0, h=1.2 * d0, rho0=1000.0,
                       mu=1.0 if viscosity == "laminar" else 1e-3, c_s=10.0,
                       gravity=(0.0, 0.0, -G), dt=1e-4,
                       rebuild_every=rebuild_every,
                       integrator="symplectic", viscosity_model=viscosity)
    params = params.replace(dt=suggest_sph_dt(params))
    fluid = grid_sample_box((0, 0, 0), (W / 2, W, H), d0)
    floors = [grid_sample_box((-3 * d0, -3 * d0, -(k + 1) * d0),
                              (L + 3 * d0, W + 3 * d0, -(k + 1) * d0), d0)
              for k in range(3)]
    state = make_sph_state(params, fluid, boundary_pts=np.concatenate(floors),
                           device=device or DEV)
    cell = 2.0 * params.h
    grid = GridSpec(origin=(-4 * d0, -4 * d0, -5 * d0), cell_size=cell,
                    dims=(int(np.ceil((L + 8 * d0) / cell)),
                          int(np.ceil((W + 8 * d0) / cell)),
                          int(np.ceil((2 * H + 9 * d0) / cell))))
    return params, grid, state


def sph_vel_close(got, ref, what):
    scale = max(float(ref.abs().max()), 1e-6)
    return check_close(got, ref, SPH_VEL_RTOL, SPH_VEL_ATOL * scale, what)


def sph_p_close(got, ref, c, what, per_rho2=False):
    """A pressure plane (p, or p/ρ² with ``per_rho2``), held at the ρ
    tolerance carried through the EOS slope dp/dρ = c_s²: near ρ0 the Tait
    pressure B((ρ/ρ0)^7 − 1) cancels, and one ulp of ρ/ρ0 is 7 of p/B."""
    atol = c.c_s ** 2 * SPH_RHO_TOL["atol"] / (c.rho0 ** 2 if per_rho2
                                               else 1.0)
    return check_close(got, ref, SPH_RHO_TOL["rtol"], atol, what)


def sph_sweeps_vs_twins(feat, cells, c, what):
    """Each sweep by its kernel and by its twin from the same inputs (the
    twin's output of the sweep before).  Returns (max abs error, its ratio
    to the tolerance) of each output plane by kernel, and the twins'
    outputs."""
    n = feat.shape[1]
    adami, vel, out = (feat.new_empty((k, n)) for k in (sph.N_ADAMI, 3, 10))
    ref_a = sph.sph_adami_plain(feat, cells, c)
    sph.sph_adami(feat, cells, c, adami, sph.adami_walk_order(feat, cells))
    ref_v = sph.sph_momentum_plain(feat, ref_a, cells, c)
    sph.sph_momentum(feat, ref_a, cells, c, vel)
    ref_o = sph.sph_continuity_drift_plain(feat, ref_v, cells, c)
    sph.sph_continuity_drift(feat, ref_v, cells, c, out)
    a, cd = f"{what} sph_adami", f"{what} sph_continuity_drift"
    errs = {
        "sph_adami": {
            "p": sph_p_close(adami[0], ref_a[0], c, f"{a} p"),
            "v_bc": sph_vel_close(adami[1:4], ref_a[1:4], f"{a} v_bc"),
            "rho": check_close(adami[4], ref_a[4], **SPH_RHO_TOL,
                                what=f"{a} rho"),
            "p/rho2": sph_p_close(adami[5], ref_a[5], c, f"{a} p/rho2",
                                  per_rho2=True),
            "1/rho": check_close(adami[6], ref_a[6], **SPH_RHO_TOL,
                                  what=f"{a} 1/rho")},
        "sph_momentum": {"v": sph_vel_close(vel, ref_v,
                                            f"{what} sph_momentum v")},
        "sph_continuity_drift": {
            "x": check_close(out[0:3], ref_o[0:3], **SPH_POS_TOL,
                              what=f"{cd} x"),
            "v": check_close(out[3:6], ref_o[3:6], 0, 0, what=f"{cd} v"),
            "rho": check_close(out[6], ref_o[6], **SPH_RHO_TOL,
                                what=f"{cd} rho"),
            "fluid": check_close(out[7], ref_o[7], 0, 0,
                                  what=f"{cd} fluid"),
            "p": sph_p_close(out[8], ref_o[8], c, f"{cd} p"),
            "1/rho": check_close(out[9], ref_o[9], **SPH_RHO_TOL,
                                  what=f"{cd} 1/rho")}}
    fluid = feat[sph.FLU] > 0.5
    require(torch.equal(out[0:3, ~fluid], feat[0:3, ~fluid]),
            f"{what}: sph_continuity_drift moved a boundary marker")
    return errs, (ref_a, ref_v, ref_o)


def format_errs(errs):
    """Each plane's max abs error and, in brackets, its ratio to the
    tolerance."""
    return "; ".join(f"{k}: " + ", ".join(f"{p} {e:.3e} [{r:.3f}]" for p, (
        e, r) in v.items()) for k, v in errs.items())


def sph_one_substep(viscosity):
    """The three sweeps vs their twins on the mini dam, with random fluid
    velocities (σ = 0.1 m/s) and densities (±1 %) so that pressure, both
    viscosities, δ-SPH and XSPH all act."""
    params, grid, state = mini_dam(viscosity)
    rng = np.random.default_rng(17)
    fluid = state.kind == FLUID
    n_f = int(fluid.sum())
    vel = state.vel.clone()
    vel[fluid] = torch.as_tensor(rng.normal(0.0, 0.1, (n_f, 3)),
                                 dtype=torch.float32, device=DEV)
    rho = state.rho.clone()
    rho[fluid] *= torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, n_f),
                                  dtype=torch.float32, device=DEV)
    c = sph.sph_static_params(params)
    feat, _, cells, ovf = state_to_cells(grid, 32, state.replace(
        vel=vel, rho=rho), c)
    require(int(ovf) == 0, "the mini dam overflows its cells")
    return sph_sweeps_vs_twins(feat, cells, c, f"mini dam {viscosity}")[0]


def sph_three_cycles(viscosity):
    """The whole path for 3 cycles of 4 substeps on the card vs on the CPU
    (twins); returns the max abs error over x, v and ρ."""
    params, grid, state = mini_dam(viscosity)
    (card, ovf_c), (plain, ovf_p) = (
        make_sph_advance_pencil(params, grid, 32, device=dev)(state, 3)
        for dev in (DEV, torch.device("cpu")))
    require(int(ovf_c) == 0 and int(ovf_p) == 0, "mini dam overflow")
    return max(assert_close(card.pos, plain.pos, **SPH_POS_TOL,
                            what="3 cycles x"),
               sph_vel_close(card.vel, plain.vel, "3 cycles v")[0],
               assert_close(card.rho, plain.rho, **SPH_RHO_TOL,
                            what="3 cycles rho"))


# ---------------------------------------------------------------- phase 4


def dam_scene(n_target=1_000_000):
    """bench_suite.py's config #4 (bench_sph, bench_suite.py:449-586) with
    its TPU-only knobs off (SUITE_SPH_C8=0, SUITE_SPH_ROT=0): d0 = 0.01,
    W = H = (2 n)^(1/3) d0, L = 2 W, a (W/2, W, H) column with 5 % jitter
    (seed 3), 3 floor layers, artificial viscosity, c_s = 10 sqrt(2 g H),
    dt = suggest_sph_dt, 8 substeps per cycle, cells of 1.25·2h over
    (L + 8 d0, W + 8 d0, 1.6 H + 8 d0) from −4 d0, C = 32."""
    d0 = 0.01
    W = (n_target * 2.0) ** (1 / 3) * d0
    H, L = W, 2.0 * W
    params = SPHParams(d0=d0, h=1.2 * d0, rho0=1000.0, mu=1e-3,
                       c_s=10.0 * np.sqrt(2 * G * H), gravity=(0.0, 0.0, -G),
                       dt=1e-4, rebuild_every=8, integrator="symplectic",
                       viscosity_model="artificial")
    params = params.replace(dt=suggest_sph_dt(params))
    fluid = grid_sample_box((0, 0, 0), (W / 2, W, H), d0, jitter=0.05,
                            seed=3)[:n_target]
    floor = np.concatenate([grid_sample_box(
        (-3 * d0, -3 * d0, -(k + 1) * d0), (L + 3 * d0, W + 3 * d0,
                                            -(k + 1) * d0), d0)
        for k in range(3)])
    cell = 1.25 * 2.0 * params.h
    ext = (L + 8 * d0, W + 8 * d0, 1.6 * H + 8 * d0)
    grid = GridSpec(origin=(-4 * d0,) * 3, cell_size=cell,
                    dims=tuple(int(np.ceil(e / cell)) for e in ext))
    state = make_sph_state(params, fluid, boundary_pts=floor, device=DEV)
    return params, grid, state, 32


# the sweep of sph_substep_sym (sph_sym_kernel.py:317) each kernel ports;
# each runs on _sym_sweep (:230), which reaches pl.pallas_call
REPLACES = {"sph_adami": "chrono_tpu/ops/pallas/sph_sym_kernel.py:421",
            "sph_momentum": "chrono_tpu/ops/pallas/sph_sym_kernel.py:490",
            "sph_continuity_drift":
                "chrono_tpu/ops/pallas/sph_sym_kernel.py:549"}
# float32 operations per pair inside the support 2h that the function
# needs.  A: per solid–fluid pair, one side (counted from
# csrc/sph_substep.cu; sqrt and division count as one).  B and CD: per
# unordered pair with a fluid side, both sides at once, as the TPU's
# symmetric form evaluates them (sph_sym_kernel.py:491, :550,
# flops_per_pair): the geometry, W and ∇W of a pair are needed once.
SPH_OPS_PER_PAIR = {"sph_adami": 35, "sph_momentum": 80,
                    "sph_continuity_drift": 70}


def sph_pair_counts(feat, cells, h):
    """The pairs inside the support 2h that each sweep's function needs:
    A the ordered solid–fluid pairs (solid i, fluid j); B and CD the
    unordered pairs with at least one fluid marker.  Also the number of
    fluid markers inside the support of a live solid (A needs their
    positions)."""
    n = feat.shape[1]
    fluid = feat[sph.FLU] > 0.5
    near_solid = torch.zeros(n, dtype=torch.bool, device=feat.device)
    solid_fluid = fluid_fluid = 0
    step = max(1, (1 << 24) // (27 * cells.capacity))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        j, ok, live = sph.neighbour_candidates(cells, lo, hi)
        d = feat[0:3, lo:hi, None] - feat[0:3][:, j]
        r = torch.sqrt((d * d).sum(0) + 1e-12)
        inside = ok & (r / h < 2.0) & live[:, None]
        fi = fluid[lo:hi, None]
        sf = inside & ~fi & fluid[j]
        solid_fluid += int(sf.sum())
        fluid_fluid += int((inside & fi & fluid[j]).sum())
        near_solid[j[sf]] = True
    unordered = fluid_fluid // 2 + solid_fluid
    return {"sph_adami": solid_fluid, "sph_momentum": unordered,
            "sph_continuity_drift": unordered}, int(near_solid.sum())


def sph_adami_bytes(feat, cells, fluid_near_solid):
    """The bytes that A's function must move: every marker's kind, v and
    7 output planes; p of all but the live solids (theirs is summed); ρ of
    the fluid; the cell of every solid (is it live?) and the (start,
    count) of the cells around a solid's cell; the positions of the live
    solids and of the fluid inside their support."""
    n = feat.shape[1]
    fluid = feat[sph.FLU] > 0.5
    start = cells.start.long()[cells.cell.long()]
    live = torch.arange(n, device=feat.device) - start < cells.capacity
    n_fluid = int(fluid.sum())
    n_live_solid = int((~fluid & live).sum())
    held = torch.zeros(cells.start.numel(), device=feat.device)
    held[cells.cell.long()[~fluid]] = 1.0
    around = torch.nn.functional.max_pool3d(
        held.view(1, 1, *cells.dims), 3, stride=1, padding=1)
    n_cells = int((around > 0).sum())
    return 4 * ((1 + 3 + sph.N_ADAMI) * n + (n - n_live_solid) + n_fluid
                + (n - n_fluid) + 2 * n_cells
                + 3 * (n_live_solid + fluid_near_solid))


def sph_main_path(card, profile):
    params, grid, state, C = dam_scene()
    n = state.n
    fluid = state.kind == FLUID
    top = int(bin_to_cells(grid, C, state.pos)[1].count.max())
    print(f"SPH main path: {n} markers ({int(fluid.sum())} fluid), grid "
          f"{grid.dims} ({grid.n_cells} cells, cell {grid.cell_size:.6f} m), "
          f"C={C}, largest cell {top}, rebuild_every "
          f"{params.rebuild_every}, dt {params.dt:.6e}, c_s {params.c_s:.4f}")
    adv = make_sph_advance_pencil(params, grid, capacity=C, device=DEV)
    names = ("sph_adami", "sph_momentum", "sph_continuity_drift")
    for name in names:
        getattr(sph, name).launches = 0
    st, ovf = adv(state, 1)                                 # warm-up cycle
    require(int(ovf) == 0, f"warm-up overflow {int(ovf)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, ovf = adv(st, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(sph, name).launches for name in names}
    require(int(ovf) == 0, f"overflow {int(ovf)}")
    require(all(bool(torch.isfinite(a).all()) for a in
                (st.pos, st.vel, st.rho)), "non-finite state")
    require(torch.equal(st.pos[~fluid], state.pos[~fluid]),
            "a boundary marker moved")
    rho = st.rho[fluid]
    rho_lo, rho_hi = float(rho.min()), float(rho.max())
    require(0.7 * params.rho0 <= rho_lo and rho_hi <= 1.5 * params.rho0,
            f"fluid density out of bounds: [{rho_lo}, {rho_hi}]")
    require(launches == {name: 3 * params.rebuild_every for name in names},
            f"launch counts {launches}")
    steps = 2 * params.rebuild_every
    vmax = float(st.vel[fluid].norm(dim=1).max())
    print(f"SPH main path: ovf 0, launches {launches}, fluid rho "
          f"[{rho_lo:.4f}, {rho_hi:.4f}], max |v| {vmax:.6e} m/s, boundary "
          f"markers unmoved")
    print(f"SPH main path: {steps} substeps of {n} markers in {wall:.4f} s "
          f"= {n * steps / wall:.6e} marker-steps/s (bin, 16 substeps of 3 "
          f"sweeps, unbin; host clock) on {card}")
    RATES["dam"] = n * steps / wall

    # each sweep against its twin at the main path's shapes
    c = sph.sph_static_params(params)
    feat, _, cells, _ = state_to_cells(grid, C, st, c)
    errs, (ref_a, ref_v, _) = sph_sweeps_vs_twins(feat, cells, c,
                                                  "dam at 1M")
    print(f"SPH sweeps vs twins at 1M, max abs err per plane: "
          f"{format_errs(errs)}")
    out = {k: feat.new_empty((r, n)) for k, r in
           (("a", sph.N_ADAMI), ("b", 3), ("cd", 10))}
    order = sph.adami_walk_order(feat, cells)
    calls = {
        "sph_adami": (lambda: sph.sph_adami(feat, cells, c, out["a"], order),
                      lambda: sph.sph_adami_plain(feat, cells, c)),
        "sph_momentum": (
            lambda: sph.sph_momentum(feat, ref_a, cells, c, out["b"]),
            lambda: sph.sph_momentum_plain(feat, ref_a, cells, c)),
        "sph_continuity_drift": (
            lambda: sph.sph_continuity_drift(feat, ref_v, cells, c,
                                             out["cd"]),
            lambda: sph.sph_continuity_drift_plain(feat, ref_v, cells, c)),
    }
    # the body-issue share of the three sweeps on the compacted walk
    start = cells.start.long()[cells.cell.long()]
    live = torch.arange(n, device=DEV) - start < C
    walkers = int(((feat[sph.FLU] > 0.5) & live).sum())
    solids = int(((feat[sph.FLU] < 0.5) & live).sum())
    for name, what, k in (
            ("sph_adami", "for_pairs_compact over the solids (A)", solids),
            ("sph_momentum", "for_pairs_compact (B)", walkers),
            ("sph_continuity_drift", "for_pairs_compact (CD)", walkers)):
        print(f"{name} at 1M, {what}: " + format_tally(tally_walks(
            ["sph_substep"], n, calls[name][0]), k))
    pairs, near_solid = sph_pair_counts(feat, cells, params.h)
    table = n * 4 + 2 * grid.n_cells * 4               # cell, start, count
    n_bytes = {"sph_adami": sph_adami_bytes(feat, cells, near_solid),
               "sph_momentum": (10 + sph.N_ADAMI + 3) * n * 4 + table,
               "sph_continuity_drift": (10 + 3 + 10) * n * 4 + table}
    rows = []
    for name in names:
        ms = cuda_ms(calls[name][0], 20)
        plain_ms = cuda_ms(calls[name][1], 3)
        bms, by = bound(n_bytes[name], pairs[name] * SPH_OPS_PER_PAIR[name])
        plane = max(errs[name], key=lambda p: errs[name][p][0])
        err = errs[name][plane][0]
        over_tol = max(r for _, r in errs[name].values())
        print(f"{name} at 1M: max abs err {err:.3e} ({plane} plane), "
              f"{over_tol:.3f} of its tolerance, {ms:.4f} ms (plain twin "
              f"{plain_ms:.4f} ms), {pairs[name]} pairs, {n_bytes[name]} "
              f"bytes, bound {bms:.4f} ms by {by}")
        rows.append({
            "name": name, "route": "cuda",
            "source": "chrono_tpu_torch/csrc/sph_substep.cu"
                      " (+ cell_pairs.cuh)",
            "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err,
            "max_abs_err_plane": plane, "err_over_tol": over_tol,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None})
    if profile:
        profile_cycle(adv, st)
    return rows


def profile_cycle(adv, state):
    """Trace one 1-cycle advance call of the dam break."""
    profile_call("one SPH cycle", lambda: adv(state, 1))


def device_events(fn):
    """Run ``fn`` under ``torch.profiler``: ``(wall seconds, device
    events)``.  The window opens with a spin kernel (``torch.cuda._sleep``)
    and a pause before ``fn``, and the spin's events are left out: a kernel
    launched as the window opens may be missing from its trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        time.sleep(0.01)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name]


def profile_call(what, fn):
    """Trace ``fn``: wall time, device time per kernel name, and the
    device's idle share of the wall (with the profiler on).  Returns the
    device ms and the launches seen by kernel name, and the device ms in
    all."""
    wall, events = device_events(fn)
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_name, seen = {}, {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
        seen[e.name] = seen.get(e.name, 0) + 1
    print(f"profile, {what}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms over {len(events)} device events, idle "
          f"{1 - busy / (wall * 1e3):.4f} of the wall (profiler on)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} ms  {name[:90]}")
    return by_name, seen, busy


def per_call_events(fn, reps):
    """Device time per call of ``fn`` by kernel name, from ``reps``
    back-to-back calls (after a warm-up call) under the profiler: ``{name:
    (mean µs per launch, launches per call)}``.  A launch count is the
    events seen over ``reps``, rounded: the profiler loses a few events at
    the start of some windows (up to 2 of 20 seen), and a mean over the
    rest does not depend on them."""
    fn()
    _, events = device_events(lambda: [fn() for _ in range(reps)])
    times = {}
    for e in events:
        times.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return {k: (sum(t) / len(t), round(len(t) / reps))
            for k, t in times.items()}


def kernel_launches(per_call, kernel):
    return sum(n for k, (_, n) in per_call.items() if kernel in k)


def kernel_device_ms(fn, kernel, reps):
    """A kernel's mean device time per launch over ``reps`` calls of
    ``fn``, each launching it once, from the profiler's device events named
    ``kernel``: for a kernel shorter than its host-side launch, CUDA events
    around a run of launches time the host, not the kernel."""
    per_call = per_call_events(fn, reps)
    n = kernel_launches(per_call, kernel)
    require(n == 1, f"the profiler saw {n} launches of {kernel} per call, "
            "not 1")
    return sum(us for k, (us, _) in per_call.items() if kernel in k) / 1e3


def tally_walks(libs, n, fn):
    """Run ``fn`` on the counter builds of ``libs``: the sums over the
    launches' threads of (warp candidate iterations, warp pair-body
    issues, lane candidates, lane pair-body runs), each warp count taken
    once per converged group of lanes (csrc/cell_pairs.cuh)."""
    buf = torch.zeros((-(-n // 256) * 256, 4), dtype=torch.int64,
                      device=DEV)
    with _build.variant("PAIR_COUNTERS"):
        for lib in libs:
            err = _build.load(lib).pair_tally_bind(
                ctypes.c_void_p(buf.data_ptr()))
            require(err == 0, f"pair_tally_bind({lib}): cudaError {err}")
        fn()
        torch.cuda.synchronize()
    return [int(x) for x in buf.sum(0).tolist()]


def format_tally(t, walkers):
    """The body-issue share of a tally: warp body issues per warp
    candidate iteration, lanes busy per body issue, and both per walking
    marker."""
    cand, body, lane_cand, lane_body = t
    return (f"{cand / walkers:.2f} warp candidate iterations and "
            f"{body / walkers:.2f} body issues a walking marker; the warp ran "
            f"the body in {body / max(cand, 1):.4f} of its candidate "
            f"iterations, {lane_body / max(body, 1):.2f} of 32 lanes busy "
            f"({lane_body / walkers:.2f} pairs, hit rate "
            f"{lane_body / max(lane_cand, 1):.4f})")


# ---------------------------------------------------------------- phase 5


# CRM: the tolerances tests/test_crm.py holds the JAX TPU engines to against
# the gather backend after one substep (x rtol 1e-6 / atol 1e-7; v rtol 1e-4
# / atol 3e-5·max|v|; ρ rtol 2e-5 / atol 1e-2; σ rtol 1e-4 / atol
# 2e-4·max|σ|, σ_o at its own scale as tests/test_torch_crm.py holds it;
# the reaction rtol 1e-4 / atol 5e-5·max|a|); 1/ρ and 1/ρ² at ρ's rtol
CRM_POS_TOL = dict(rtol=1e-6, atol=1e-7)
CRM_RHO_TOL = dict(rtol=2e-5, atol=1e-2)
CRM_INV_TOL = dict(rtol=4e-5, atol=0.0)


def crm_scaled_close(got, ref, rtol, atol_rel, what):
    """``check_close`` with atol = atol_rel · max |ref|."""
    scale = max(float(ref.abs().max()), 1e-6)
    return check_close(got, ref, rtol, atol_rel * scale, what)


def crm_soil(d0):
    """The firm cohesive loam of demos/demo_vehicle_crm.py:70-81 at spacing
    d0: ρ0 = 1700, c_s = 40, α = 0.3, dt = 1e-4, E = 4e6, ν = 0.3,
    tan φ = 0.9, c = 2000 Pa, h = 1.2 d0, cubic kernel, 4 substeps per
    cycle, and the gather backend's 96 neighbours and 64 markers a
    cell."""
    params = SPHParams(d0=d0, h=1.2 * d0, rho0=1700.0, mu=0.0, c_s=40.0,
                       gravity=(0.0, 0.0, -G), dt=1e-4, alpha_visc=0.3,
                       max_neighbors=96, max_per_cell=64, rebuild_every=4)
    soil = CRMParams(youngs=4e6, poisson=0.3, friction_angle=0.9,
                     cohesion=2000.0)
    return params, soil


def crm_bed(size, depth, d0, device=None):
    """A terrain bed of the demo's loam from ``make_crm_terrain_state``
    (air = 12 d0, margin = 6 d0), on ``device`` (the card by default)."""
    params, soil = crm_soil(d0)
    state, grid = make_crm_terrain_state(params, soil, size, depth, air=12.0,
                                         margin=6.0, device=device or DEV)
    return params, soil, grid, state


def crm_stirred_mini():
    """The mini bed after 2 cycles on the card, then granular velocities
    perturbed by N(0, 0.05 m/s) and stresses by ±5 % (seed 23), as
    tests/test_torch_crm.py stirs it: at rest the viscosity and spin terms
    are zero and nothing yields."""
    params, soil, grid, state = crm_bed((0.4, 0.2), 0.1, 0.02)
    state, ovf = make_crm_advance_pencil(params, soil, grid, 32,
                                         device=DEV)(state, 2)
    require(int(ovf) == 0, "the mini bed overflows its cells")
    rng = np.random.default_rng(23)
    gran = (state.kind == FLUID).cpu().numpy()
    n_g = int(gran.sum())
    vel, tau_d, tau_o = (a.cpu().numpy().copy() for a in
                         (state.vel, state.tau_d, state.tau_o))
    vel[gran] += rng.normal(0.0, 0.05, (n_g, 3))
    tau_d[gran] *= 1.0 + rng.uniform(-0.05, 0.05, (n_g, 3))
    tau_o[gran] *= 1.0 + rng.uniform(-0.05, 0.05, (n_g, 3))

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=DEV)

    return params, soil, grid, state.replace(vel=t(vel), tau_d=t(tau_d),
                                             tau_o=t(tau_o))


def crm_state_errs(got, ref, what):
    """(max abs error, its ratio to the tolerance) of each plane group of
    two (17, N) CRM states."""
    return {
        "x": check_close(got[crm.PX:crm.PZ + 1], ref[crm.PX:crm.PZ + 1],
                         **CRM_POS_TOL, what=f"{what} x"),
        "v": crm_scaled_close(got[crm.VX:crm.VZ + 1], ref[crm.VX:crm.VZ + 1],
                              1e-4, 3e-5, f"{what} v"),
        "rho": check_close(got[crm.RHO], ref[crm.RHO], **CRM_RHO_TOL,
                           what=f"{what} rho"),
        "sigma_d": crm_scaled_close(got[crm.SXX:crm.SZZ + 1],
                                    ref[crm.SXX:crm.SZZ + 1], 1e-4, 2e-4,
                                    f"{what} sigma_d"),
        "sigma_o": crm_scaled_close(got[crm.SXY:crm.SYZ + 1],
                                    ref[crm.SXY:crm.SYZ + 1], 1e-4, 2e-4,
                                    f"{what} sigma_o"),
        "flags": check_close(got[crm.GRN:crm.VAL + 1],
                             ref[crm.GRN:crm.VAL + 1], 0, 0,
                             what=f"{what} flags"),
        "1/rho2": check_close(got[crm.DER], ref[crm.DER], **CRM_INV_TOL,
                              what=f"{what} 1/rho2")}


def crm_sweeps_vs_twins(feat, cells, c, what):
    """Each sweep by its kernel and by its twin from the same inputs (G from
    the twin's M output and the kernel M's neighbour list); M in its three
    modes, which must agree bit for bit on what they share.  M's list must
    hold each kicked marker's in-support neighbours in the twin's walk
    order, and their number, exactly.  Returns the errors by kernel and
    plane, the twins' outputs and the number of markers past the list's
    slots (their G walks again)."""
    n = feat.shape[1]
    mv, mv2, acc, acc2, out = (feat.new_empty((r, n)) for r in (
        crm.N_MV, crm.N_MV, 3, 3, crm.N_STATE))
    lists, lists2 = (crm.NeighbourList.empty(n, feat.device)
                     for _ in range(2))
    ref_mv, ref_acc = crm.crm_momentum_plain(feat, cells, c, with_acc=True)
    crm.crm_momentum(feat, cells, c, mv=mv, lists=lists)    # the substep
    crm.crm_momentum(feat, cells, c, mv=mv2, acc=acc,       # with_acc
                     lists=lists2)
    crm.crm_momentum(feat, cells, c, acc=acc2)              # forces_only
    require(torch.equal(mv, mv2) and torch.equal(acc, acc2),
            f"{what}: crm_momentum's modes disagree")
    kick = (feat[crm.VAL] > 0.5) & (feat[crm.INT] > 0.5)
    slot = torch.arange(crm.LIST_SLOTS, device=feat.device)[:, None]
    held = (slot < lists.n_listed[None, :]) & kick[None, :]
    require(torch.equal(lists.n_listed[kick], lists2.n_listed[kick])
            and torch.equal(lists.nbrs[held], lists2.nbrs[held]),
            f"{what}: crm_momentum's lists disagree between its modes")
    ref_nbrs, ref_count = crm.crm_neighbour_list_plain(feat, cells, c)
    bad = int((lists.n_listed[kick] != ref_count[kick]).sum())
    require(bad == 0, f"{what}: {bad} of M's list lengths differ from "
            f"crm_neighbour_counts_plain")
    require(torch.equal(lists.nbrs[held], ref_nbrs[held]),
            f"{what}: M's list differs from the twin's walk order")
    ref_out = crm.crm_gradv_stress_plain(feat, ref_mv, cells, c)
    crm.crm_gradv_stress(feat, ref_mv, cells, c, out, lists)
    m, g = f"{what} crm_momentum", f"{what} crm_gradv_stress"
    errs = {
        "crm_momentum": {
            "v": crm_scaled_close(mv[0:3], ref_mv[0:3], 1e-4, 3e-5,
                                  f"{m} v"),
            "1/rho": check_close(mv[3], ref_mv[3], **CRM_INV_TOL,
                                 what=f"{m} 1/rho"),
            "acc": crm_scaled_close(acc, ref_acc, 1e-4, 5e-5, f"{m} acc")},
        "crm_gradv_stress": crm_state_errs(out, ref_out, g)}
    still = (feat[crm.INT] < 0.5) | (feat[crm.VAL] < 0.5)
    require(torch.equal(out[crm.PX:crm.VZ + 1, still],
                        feat[crm.PX:crm.VZ + 1, still])
            and torch.equal(out[crm.SXX:crm.SYZ + 1, still],
                            feat[crm.SXX:crm.SYZ + 1, still]),
            f"{what}: a marker that is not integrated moved")
    past = int((lists.n_listed[kick] > crm.LIST_SLOTS).sum())
    return errs, (ref_mv, ref_acc, ref_out), past


def crm_outer_vs_sweeps(feat, cells, c, n_sub, what, twin=True,
                        slots=crm.LIST_SLOTS):
    """``crm_outer`` (n_sub substeps in one launch, a neighbour list of
    ``slots``) against n_sub substeps of the per-sweep kernels (with_acc on
    the last) and, with ``twin``, against its twin.  Returns the errors by
    reference and plane, the list overflow (with ``twin``, checked against
    the twin's) and the twin's most in-support neighbours of a marker
    (None without ``twin``)."""
    n = feat.shape[1]
    out, acc = feat.new_empty((crm.N_STATE, n)), feat.new_empty((3, n))
    nbrs = torch.empty((slots, n), dtype=torch.int32, device=feat.device)
    list_ovf = int(crm.crm_outer_substeps(feat, cells, c, n_sub, out, acc,
                                          nbrs))
    mv, ref_acc = feat.new_empty((crm.N_MV, n)), feat.new_empty((3, n))
    lists = crm.NeighbourList.empty(n, feat.device)
    cur = feat
    for s in range(n_sub):
        nxt = torch.empty_like(feat)
        crm.crm_substep(cur, cells, c, mv, nxt,
                        ref_acc if s == n_sub - 1 else None, lists)
        cur = nxt
    refs = {"per-sweep kernels": (cur, ref_acc)}
    most = None
    if twin:
        most = torch.zeros((), dtype=torch.int32, device=feat.device)
        refs["twin"] = crm.crm_outer_substeps_plain(feat, cells, c, n_sub,
                                                    most)
        most = int(most)
        twin_ovf = max(0, most - slots)
        # within one: a neighbour at r = 2h may round to either side
        require((list_ovf > 0) == (twin_ovf > 0)
                and abs(list_ovf - twin_ovf) <= 1,
                f"{what}: crm_outer's list overflow {list_ovf}, the twin's "
                f"{twin_ovf}")
    errs = {}
    for name, (ref, r_acc) in refs.items():
        w = f"{what} crm_outer vs {name}"
        errs[name] = crm_state_errs(out, ref, w)
        errs[name]["acc"] = crm_scaled_close(acc, r_acc, 1e-4, 5e-5,
                                             f"{w} acc")
    return errs, list_ovf, most


def crm_one_substep():
    """The sweeps against their twins, and the whole-outer kernel (4
    substeps) against the per-sweep kernels and its twin, on the stirred
    mini bed."""
    params, soil, grid, state = crm_stirred_mini()
    c = crm.crm_static_params(params, soil)
    eng = make_crm_engine(params, soil, grid, 32, device=DEV)
    feat, _, cells, ovf = eng["bin"](state)
    require(int(ovf) == 0, "the mini bed overflows its cells")
    errs, _, past = crm_sweeps_vs_twins(feat, cells, c, "mini bed")
    require(past == 0, f"mini bed: {past} markers past the list")
    outer_errs, list_ovf, _ = crm_outer_vs_sweeps(feat, cells, c, 4,
                                                  "mini bed")
    require(list_ovf == 0, f"mini bed: list overflow {list_ovf}")
    return errs, outer_errs


def crm_outer_short_list(slots=16):
    """``crm_outer`` on the stirred mini bed with a list of ``slots``, too
    short for its markers: it reports the overflow (as its twin counts it)
    and its state still matches the per-sweep kernels and the twin, since
    a marker past the list walks again.  Returns (errors, overflow)."""
    params, soil, grid, state = crm_stirred_mini()
    c = crm.crm_static_params(params, soil)
    feat, _, cells, ovf = make_crm_engine(params, soil, grid, 32,
                                          device=DEV)["bin"](state)
    require(int(ovf) == 0, "the mini bed overflows its cells")
    errs, list_ovf, _ = crm_outer_vs_sweeps(feat, cells, c, 4,
                                            f"mini bed, {slots} slots",
                                            slots=slots)
    require(list_ovf > 0, f"{slots} slots: no list overflow reported")
    return errs, list_ovf


def crm_three_cycles():
    """The whole path for 3 cycles of 4 substeps from the lithostatic mini
    bed, on the card vs on the CPU (twins).  The edge markers start inside
    the wall penalty range and are kicked to ~3 m/s, so sum-order
    differences grow over the 12 substeps: held at the tolerances
    tests/test_torch_crm.py holds 3 cycles to (x atol 1e-6 m, v
    1e-3·max|v|, ρ 0.05, σ 1e-3·max|σ|).  Returns the max abs error over
    x, v, ρ and σ."""
    params, soil, grid, state = crm_bed((0.4, 0.2), 0.1, 0.02)
    (card, ovf_c), (plain, ovf_p) = (
        make_crm_advance_pencil(params, soil, grid, 32, device=dev)(state, 3)
        for dev in (DEV, torch.device("cpu")))
    require(int(ovf_c) == 0 and int(ovf_p) == 0, "mini bed overflow")
    return max(
        assert_close(card.pos, plain.pos, 1e-6, 1e-6, "3 cycles x"),
        crm_scaled_close(card.vel, plain.vel, 1e-4, 1e-3, "3 cycles v")[0],
        assert_close(card.rho, plain.rho, 2e-5, 0.05, "3 cycles rho"),
        *(crm_scaled_close(getattr(card, f), getattr(plain, f), 1e-4, 1e-3,
                           f"3 cycles {f}")[0] for f in ("tau_d", "tau_o")))


# ---------------------------------------------------------------- phase 6


def dp_cone_excess(tau_d, tau_o, soil):
    """Per marker, how far √J₂ lies beyond the Drucker–Prager limit
    α·max(p, apex) + k, less an fp32 rounding slack of 1e-5·(|p| + √J₂ + k)
    (≤ 0 inside), and the share of markers on the cone (√J₂ within 0.1 % of
    the limit)."""
    s = torch.cat([tau_d, tau_o], dim=1).double()
    den = np.sqrt(9.0 + 3.0 * soil.friction_angle ** 2)
    alpha, k_c = soil.friction_angle / den, 3.0 * soil.cohesion / den
    p = -(s[:, 0] + s[:, 1] + s[:, 2]) / 3.0
    e = s[:, 0:3] + p[:, None]
    sqrt_j2 = torch.sqrt(0.5 * (e * e).sum(1) + (s[:, 3:] ** 2).sum(1))
    limit = alpha * torch.clamp(p, min=-k_c / alpha) + k_c
    excess = sqrt_j2 - limit - 1e-5 * (p.abs() + sqrt_j2 + k_c)
    return excess, float((sqrt_j2 >= 0.999 * limit).double().mean())


def crm_pair_counts(feat, cells, h):
    """The unordered pairs inside the support 2h with at least one
    integrated marker: the pairs whose terms the sweeps' function needs,
    each evaluated once for both sides by the TPU's symmetric form."""
    n = feat.shape[1]
    integ = feat[crm.INT] > 0.5
    both = mixed = 0
    step = max(1, (1 << 24) // (27 * cells.capacity))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        j, ok, live = sph.neighbour_candidates(cells, lo, hi)
        d = feat[0:3, lo:hi, None] - feat[0:3][:, j]
        r = torch.sqrt((d * d).sum(0) + 1e-12)
        inside = ok & (r / h < 2.0) & live[:, None]
        fi = integ[lo:hi, None]
        both += int((inside & fi & integ[j]).sum())
        mixed += int((inside & fi & ~integ[j]).sum())
    return both // 2 + mixed


# the TPU kernels each port replaces: sweeps M and G of crm_substep_sym
# (crm_sym_kernel.py:237; the SWEEP calls reach pl.pallas_call through
# _sym_sweep or sym_sweep_flat), and crm_outer_substeps
CRM_REPLACES = {
    "crm_momentum": "chrono_tpu/ops/pallas/crm_sym_kernel.py:280",
    "crm_gradv_stress": "chrono_tpu/ops/pallas/crm_sym_kernel.py:286",
    "crm_outer": "chrono_tpu/ops/pallas/crm_outer_kernel.py:173"}
CRM_SOURCES = {"crm_momentum": "chrono_tpu_torch/csrc/crm_substep.cu",
               "crm_gradv_stress": "chrono_tpu_torch/csrc/crm_substep.cu",
               "crm_outer": "chrono_tpu_torch/csrc/crm_outer.cu"}
# float32 operations per unordered in-support pair, at the TPU symmetric
# form's count (crm_sym_kernel.py:278, :287 flops_per_pair)
CRM_OPS_PER_PAIR = {"crm_momentum": 90, "crm_gradv_stress": 60}
CRM_SWEEPS = ("crm_momentum", "crm_gradv_stress")


def crm_cycles(run, state, n_cycles):
    """``run(state, n) → (state, overflow)`` for 1 warm-up cycle and then
    ``n_cycles`` timed ones: ``(state, overflow, wall seconds)``."""
    st, ovf = run(state, 1)
    require(int(ovf) == 0, f"warm-up overflow {int(ovf)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, ovf = run(st, n_cycles)
    torch.cuda.synchronize()
    return st, ovf, time.perf_counter() - t0


def crm_check_run(st, state, soil, ovf, what):
    """Overflow 0, finite, walls unmoved bit for bit, every granular stress
    inside the cone.  Returns the share of granular markers on the cone."""
    gran = state.kind == FLUID
    require(int(ovf) == 0, f"{what}: overflow {int(ovf)}")
    require(all(bool(torch.isfinite(a).all()) for a in
                (st.pos, st.vel, st.rho, st.tau_d, st.tau_o)),
            f"{what}: non-finite state")
    require(torch.equal(st.pos[~gran], state.pos[~gran])
            and torch.equal(st.vel[~gran], state.vel[~gran]),
            f"{what}: a wall marker moved")
    excess, on_cone = dp_cone_excess(st.tau_d[gran], st.tau_o[gran], soil)
    require(float(excess.max()) <= 0.0,
            f"{what}: {int((excess > 0).sum())} granular stresses outside "
            f"the Drucker-Prager cone (max excess {float(excess.max())} Pa)")
    return on_cone


def crm_main_path(card, size=(10.0, 4.0), depth=0.2, d0=0.02, C=32):
    params, soil, grid, state = crm_bed(size, depth, d0)
    n = state.n
    gran = state.kind == FLUID
    n_g = int(gran.sum())
    steps = params.rebuild_every
    top = int(bin_to_cells(grid, C, state.pos)[1].count.max())
    print(f"CRM main path: {size[0]} x {size[1]} x {depth} m bed at d0 "
          f"{d0}: {n} markers ({n_g} granular, {n - n_g} wall), grid "
          f"{grid.dims} ({grid.n_cells} cells of {grid.cell_size:.6f} m), "
          f"C={C}, largest cell {top}, rebuild_every {steps}, dt {params.dt}")

    # the main path: make_crm_advance_pencil, two sweep launches a substep
    adv = make_crm_advance_pencil(params, soil, grid, capacity=C, device=DEV)
    for name in CRM_SWEEPS:
        getattr(crm, name).launches = 0
    crm.crm_outer_substeps.launches = 0
    st, ovf, wall = crm_cycles(adv, state, 2)
    launches = {name: getattr(crm, name).launches for name in CRM_SWEEPS}
    launches["crm_outer"] = crm.crm_outer_substeps.launches
    require(launches == {"crm_momentum": 3 * steps,
                         "crm_gradv_stress": 3 * steps, "crm_outer": 0},
            f"launch counts {launches}")
    on_cone = crm_check_run(st, state, soil, ovf, "CRM main path")
    vmax = float(st.vel[gran].norm(dim=1).max())
    print(f"CRM main path: ovf 0, launches {launches}, finite, walls "
          f"unmoved, every granular stress inside the cone ({on_cone:.4f} "
          f"on it), max |v| {vmax:.6e} m/s")
    print(f"CRM main path: {2 * steps} substeps of {n_g} granular markers "
          f"in {wall:.4f} s = {n_g * 2 * steps / wall:.6e} marker-steps/s "
          f"(bin, {2 * steps} substeps of 2 sweeps, unbin; host clock) on "
          f"{card}")

    # the whole-outer path: bin, one crm_outer launch per cycle, unbin
    eng = make_crm_engine(params, soil, grid, C, device=DEV)

    def outer_advance(s, n_cycles):
        ovf = torch.zeros((), dtype=torch.int32, device=DEV)
        for _ in range(n_cycles):
            feat, order, cells, o = eng["bin"](s)
            out, _, list_ovf = eng["outer"](feat, cells, steps)
            s = cells_to_crm_state(out, order, s)
            s = s.replace(time=s.time + params.dt * steps)
            ovf = torch.maximum(ovf, torch.maximum(o, list_ovf))
        return s, ovf

    for name in CRM_SWEEPS:
        getattr(crm, name).launches = 0
    crm.crm_outer_substeps.launches = 0
    so, ovf, wall_o = crm_cycles(outer_advance, state, 2)
    launches_o = {name: getattr(crm, name).launches for name in CRM_SWEEPS}
    launches_o["crm_outer"] = crm.crm_outer_substeps.launches
    require(launches_o == {"crm_momentum": 0, "crm_gradv_stress": 0,
                           "crm_outer": 3}, f"launch counts {launches_o}")
    crm_check_run(so, state, soil, ovf, "CRM whole-outer path")
    outer_vs_sweeps = max(
        assert_close(so.pos, st.pos, 1e-6, 1e-7, "outer path x"),
        crm_scaled_close(so.vel, st.vel, 1e-4, 3e-5, "outer path v")[0],
        assert_close(so.rho, st.rho, **CRM_RHO_TOL, what="outer path rho"),
        *(crm_scaled_close(getattr(so, f), getattr(st, f), 1e-4, 2e-4,
                           f"outer path {f}")[0] for f in ("tau_d", "tau_o")))
    print(f"CRM whole-outer path: launches {launches_o}, cell and "
          f"neighbour-list ({crm.LIST_SLOTS} slots) overflow 0, {2 * steps} "
          f"substeps in {wall_o:.4f} s = {n_g * 2 * steps / wall_o:.6e} "
          f"marker-steps/s; against the per-sweep path after 3 cycles max "
          f"abs err {outer_vs_sweeps:.3e}")

    # each kernel against its twin at the main path's shapes: M and G on
    # the state 3 substeps after binning, as the cycle's last substep
    # finds it; crm_outer from the binned state
    c = eng["consts"]
    feat, _, cells, _ = eng["bin"](st)
    lists = crm.NeighbourList.empty(n, DEV)
    mv = feat.new_empty((crm.N_MV, n))
    drifted = feat
    for _ in range(steps - 1):
        nxt = torch.empty_like(feat)
        crm.crm_substep(drifted, cells, c, mv, nxt, None, lists)
        drifted = nxt
    errs, (ref_mv, _, _), past = crm_sweeps_vs_twins(
        drifted, cells, c, f"bed at 1M, {steps - 1} substeps after binning")
    kick = (drifted[crm.VAL] > 0.5) & (drifted[crm.INT] > 0.5)
    crm.crm_momentum(drifted, cells, c, mv=mv, lists=lists)
    listed = lists.n_listed[kick].long()
    print(f"crm_momentum at 1M, {steps - 1} substeps after binning: list "
          f"lengths equal crm_neighbour_counts_plain for all "
          f"{int(kick.sum())} kicked markers, and the list is the twin's "
          f"walk order; {past} markers past the list's {crm.LIST_SLOTS} "
          f"slots (G walks again for them); mean "
          f"{float(listed.float().mean()):.4f} and most {int(listed.max())} "
          f"neighbours a marker")
    outer_errs, list_ovf, most = crm_outer_vs_sweeps(feat, cells, c, steps,
                                                     "bed at 1M")
    require(list_ovf == 0, f"bed at 1M: list overflow {list_ovf}")
    print(f"crm_outer at 1M: neighbour list of {crm.LIST_SLOTS} slots, "
          f"overflow 0; the most in-support neighbours of a marker over the "
          f"{steps} substeps {most} (twin)")
    errs["crm_outer"] = outer_errs["twin"]
    print(f"CRM sweeps vs twins at 1M, max abs err per plane: "
          f"{format_errs(errs)}")
    print(f"crm_outer vs {steps} x (M, G) per-sweep kernels at 1M: "
          f"{format_errs({'crm_outer': outer_errs['per-sweep kernels']})}")
    bufs = {k: feat.new_empty((r, n)) for k, r in
            (("mv", crm.N_MV), ("g", crm.N_STATE), ("o", crm.N_STATE),
             ("a", 3))}
    # lists holds M's list of the drifted state, which G replays
    calls = {
        "crm_momentum": (
            lambda: crm.crm_momentum(drifted, cells, c, mv=bufs["mv"],
                                     lists=lists),
            lambda: crm.crm_momentum_plain(drifted, cells, c), 2),
        "crm_gradv_stress": (
            lambda: crm.crm_gradv_stress(drifted, ref_mv, cells, c,
                                         bufs["g"], lists),
            lambda: crm.crm_gradv_stress_plain(drifted, ref_mv, cells, c),
            2),
        "crm_outer": (
            lambda: crm.crm_outer_substeps(feat, cells, c, steps, bufs["o"],
                                           bufs["a"]),
            lambda: crm.crm_outer_substeps_plain(feat, cells, c, steps), 1),
    }
    # crm_outer against the 8 per-sweep launches it replaces at 1M, in
    # turns, and the walks' tallies of the two
    sweep_bufs = [feat.new_empty((crm.N_STATE, n)) for _ in range(2)]
    sweep_lists = crm.NeighbourList.empty(n, DEV)

    def per_sweep_1m():
        cur = feat
        for s in range(steps):
            nxt = sweep_bufs[s % 2]
            crm.crm_substep(cur, cells, c, bufs["mv"], nxt,
                            bufs["a"] if s == steps - 1 else None,
                            sweep_lists)
            cur = nxt

    turns = [cuda_ms(f, 5) for f in (calls["crm_outer"][0], per_sweep_1m,
                                     per_sweep_1m, calls["crm_outer"][0])]
    print(f"crm_outer at 1M: {turns[0]:.4f} / {turns[3]:.4f} ms against "
          f"{2 * steps} per-sweep launches {turns[1]:.4f} / {turns[2]:.4f} "
          f"ms (in turns) on {card}")
    walkers = int(((feat[crm.VAL] > 0.5) & (feat[crm.INT] > 0.5)).sum())
    for what, fn in (("per-sweep M, G (M for_pairs_compact, G its list)",
                      per_sweep_1m),
                     ("crm_outer (M for_pairs_compact, G its list)",
                      calls["crm_outer"][0])):
        t = tally_walks(["crm_substep", "crm_outer"], n, fn)
        print(f"{steps} substeps at 1M, {what}: {t[2] / (walkers * steps):.2f}"
              f" candidates a walking marker a substep; "
              + format_tally(t, walkers * steps))
    pairs = crm_pair_counts(drifted, cells, params.h)
    table = n * 4 + 2 * grid.n_cells * 4               # cell, start, count
    # the bound counts what each function needs (its state, mv and out
    # planes and the cell table); the design's scratch is printed apart:
    # the list that M writes and G reads (each kicked marker's first K
    # neighbours and their number) and the records that each sweep's pack
    # pass writes and its pair body reads (at least once)
    list_bytes = 4 * (int(torch.clamp(listed, max=crm.LIST_SLOTS).sum())
                      + int(kick.sum()))
    scratch_bytes = {
        "crm_momentum": list_bytes + 2 * 4 * crm.N_RECORD * n,
        "crm_gradv_stress": list_bytes + 2 * 4 * crm.N_GRADV_RECORD * n}
    n_bytes = {"crm_momentum": (crm.N_STATE + crm.N_MV) * n * 4 + table,
               "crm_gradv_stress": (2 * crm.N_STATE + crm.N_MV) * n * 4
               + table,
               "crm_outer": (2 * crm.N_STATE + 3) * n * 4 + table}
    n_ops = {"crm_momentum": pairs * CRM_OPS_PER_PAIR["crm_momentum"],
             "crm_gradv_stress": pairs * CRM_OPS_PER_PAIR["crm_gradv_stress"],
             "crm_outer": steps * pairs * sum(CRM_OPS_PER_PAIR.values())}
    all_launches = dict(launches, crm_outer=launches_o["crm_outer"])
    rows = []
    for name in ("crm_momentum", "crm_gradv_stress", "crm_outer"):
        kernel, plain, plain_reps = calls[name]
        ms = cuda_ms(kernel, 20 if name != "crm_outer" else 5)
        plain_ms = cuda_ms(plain, plain_reps)
        bms, by = bound(n_bytes[name], n_ops[name])
        plane = max(errs[name], key=lambda p: errs[name][p][0])
        err = errs[name][plane][0]
        over_tol = max(r for _, r in errs[name].values())
        print(f"{name} at 1M: max abs err {err:.3e} ({plane} plane), "
              f"{over_tol:.3f} of its tolerance, {ms:.4f} ms (plain twin "
              f"{plain_ms:.4f} ms), {pairs} pairs, {n_bytes[name]} bytes, "
              f"bound {bms:.4f} ms by {by}"
              + (f"; list and record scratch {scratch_bytes[name]} bytes"
                 if name in scratch_bytes else ""))
        rows.append({
            "name": name, "route": "cuda", "source": CRM_SOURCES[name],
            **({"per_sweep_ms": [turns[1], turns[2]]}
               if name == "crm_outer" else {}),
            **({"scratch_bytes": scratch_bytes[name]}
               if name in scratch_bytes else {}),
            **({"past_list": past} if name == "crm_gradv_stress" else {}),
            "replaces": CRM_REPLACES[name],
            "launches": all_launches[name], "max_abs_err": err,
            "max_abs_err_plane": plane, "err_over_tol": over_tol,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None})

    # launch overhead: one crm_outer against 8 per-sweep launches on the
    # demo-sized bed (demos/demo_vehicle_crm.py:83-84 at its d0 = 0.05)
    params, soil, grid, state = crm_bed((2.0, 1.2), 0.15, 0.05)
    eng = make_crm_engine(params, soil, grid, C, device=DEV)
    feat, _, cells, ovf = eng["bin"](state)
    require(int(ovf) == 0, "the demo bed overflows its cells")
    c = eng["consts"]
    demo_errs, list_ovf, _ = crm_outer_vs_sweeps(feat, cells, c, steps,
                                                 "demo bed", twin=False)
    require(list_ovf == 0, f"demo bed: list overflow {list_ovf}")
    out, acc = torch.empty_like(feat), feat.new_empty((3, feat.shape[1]))
    spare, mv = torch.empty_like(feat), feat.new_empty((crm.N_MV,
                                                        feat.shape[1]))
    lists = crm.NeighbourList.empty(feat.shape[1], DEV)

    def per_sweep():
        cur, nxt = feat, out
        for s in range(steps):
            crm.crm_substep(cur, cells, c, mv, nxt,
                            acc if s == steps - 1 else None, lists)
            cur, nxt = nxt, (spare if nxt is out else out)

    outer_ms = cuda_ms(lambda: crm.crm_outer_substeps(
        feat, cells, c, steps, out, acc), 50)
    sweeps_ms = cuda_ms(per_sweep, 50)
    outer_ms2 = cuda_ms(lambda: crm.crm_outer_substeps(
        feat, cells, c, steps, out, acc), 50)
    print(f"demo bed (2.0 x 1.2 x 0.15 m, d0 0.05, {state.n} markers, "
          f"{int((state.kind == FLUID).sum())} granular): crm_outer "
          f"{outer_ms:.4f} / {outer_ms2:.4f} ms vs {2 * steps} per-sweep "
          f"launches {sweeps_ms:.4f} ms; outer vs per-sweep: "
          f"{format_errs(demo_errs)}")
    return rows


# ---------------------------------------------------------------- phase 7


NSC_R = 0.05
# the blade scene of tests/test_nsc_pencil.py:352 (a floor and a rotbox)
NSC_BLADE_WALLS = (("plane", (0.0, 0.0, 1.0), 0.0, (0.0, 0.0, 0.0), 0.4),
                   ("rotbox", 2, (0.3, 0.3, 0.1), (0.25, 0.04, 0.1),
                    np.pi / 3, 0.4))
# the tolerances the JAX package holds its NSC backends to: one sweep (u,
# γ⁺) rtol 1e-5 / atol 1e-6, the whole path x 2e-5, v 2e-4, ω 2e-3 (atol),
# the dynamic blade's spin rtol 2e-4 / atol 1e-6, x rtol 1e-4 / atol 2e-6,
# v rtol 2e-3 / atol 2e-5 (tests/test_nsc_pencil.py, test_nsc_dynamic_blade)
NSC_SWEEP_TOL = dict(rtol=1e-5, atol=1e-6)
NSC_REPLACES = {
    "nsc_detect": "chrono_tpu/ops/pallas/nsc_half_kernel.py:58",
    "nsc_sweep_u": "chrono_tpu/ops/pallas/nsc_half_kernel.py:492",
    "nsc_sweep_g": "chrono_tpu/ops/pallas/nsc_half_kernel.py:500"}
NSC_SOURCES = {"nsc_detect": "chrono_tpu_torch/csrc/nsc_detect.cu",
               "nsc_sweep_u": "chrono_tpu_torch/csrc/nsc_sweep.cu",
               "nsc_sweep_g": "chrono_tpu_torch/csrc/nsc_sweep.cu"}
NSC_KERNELS = ("nsc_detect", "nsc_sweep_u", "nsc_sweep_g")


def nsc_launches():
    return {"nsc_detect": nd.nsc_detect.launches,
            "nsc_sweep_u": ns.nsc_sweep_u.launches,
            "nsc_sweep_g": ns.nsc_sweep_g.launches}


def nsc_reset_launches():
    nd.nsc_detect.launches = 0
    ns.nsc_sweep_u.launches = ns.nsc_sweep_g.launches = 0


def nsc_bin(grid, pos, vel, omega, p, capacity=8, device=None):
    """``(pos_s (3, N), u_free (6, N), cells, overflow)``: the bodies sorted
    by cell as one DVI step sorts them, on ``device`` (the card by
    default)."""
    dev = device or DEV
    pos, vel, omega = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                       for a in (pos, vel, omega))
    order, cells, ovf = bin_to_cells(grid, capacity, pos)
    g = torch.tensor(p.gravity, dtype=torch.float32, device=dev)
    ufree = torch.cat([(vel + p.dt * g)[order].T, omega[order].T])
    return pos[order].T.contiguous(), ufree.contiguous(), cells, int(ovf)


def nsc_blade_cs(walls, theta, device=None):
    """(R, 3) (cos θ, sin θ, ω) of the rotbox walls at pose θ."""
    rows = [(np.cos(theta), np.sin(theta), w[4]) for w in walls
            if w[0] == "rotbox"]
    return torch.tensor(rows, dtype=torch.float32,
                        device=device or DEV).reshape(-1, 3)


def nsc_u_close(got, ref, what):
    """A u plane at the sweep tolerance, its atol taken at the plane's
    scale (1e-6·max(1, max|ref|)): u sums contact terms much larger than
    itself (one 0.01 N·s tangential impulse turns a 3 cm sphere by ~4
    rad/s), so its rounding scales with them, not with u."""
    scale = max(1.0, float(ref.abs().max()))
    return check_close(got, ref, NSC_SWEEP_TOL["rtol"],
                       NSC_SWEEP_TOL["atol"] * scale, what)


def nsc_kernels_vs_twins(pos_s, ufree, cells, c, cs, P, what, seed=5,
                         beta=0.3):
    """Each NSC kernel against its twin from the same inputs: ``nsc_detect``
    bit for bit; U from random multipliers (impulses of 0.005–0.01 N·s, a
    step's contact impulses) on the detected contacts and every wall row;
    G from U's twin output.  Returns the errors by kernel and plane, and the
    inputs of each kernel for timing."""
    dc = nd.DetectConsts.of(c.radius, c.envelope)
    part, count = nd.nsc_detect(pos_s, cells, P, dc)
    rp, rc = nd.nsc_detect_plain(pos_s, cells, P, dc)
    require(torch.equal(part, rp) and torch.equal(count, rc),
            f"{what}: nsc_detect differs from its twin")
    rev = nd.reverse_table(part)
    n, W = pos_s.shape[1], len(c.walls)
    rng = np.random.default_rng(seed)
    valid = (part >= 0).cpu().numpy()

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=DEV)

    gam, gprev = (t(np.where(valid, rng.uniform(-0.005, 0.01, (3, n, P)),
                             0.0)) for _ in range(2))
    wgam, wgprev = (t(rng.uniform(-0.005, 0.01, (3, n, W)))
                    for _ in range(2))
    # U writing the wall masks, as a step's first launch does, then U
    # reading them: the same u, bit for bit
    u, u_written = torch.empty_like(ufree), torch.empty_like(ufree)
    masks = torch.empty(n, dtype=torch.int32, device=DEV)
    ns.nsc_sweep_u(pos_s, ufree, gam, gprev, wgam, wgprev, beta, part, rev,
                   cs, c, u_written, masks, write=True)
    nsc_masks_check(masks, pos_s, cs, c, what)
    ns.nsc_sweep_u(pos_s, ufree, gam, gprev, wgam, wgprev, beta, part, rev,
                   cs, c, u, masks)
    require(torch.equal(u_written, u),
            f"{what}: U reading the wall masks differs from U writing them")
    ref_u = ns.nsc_sweep_u_plain(pos_s, ufree, gam, gprev, wgam, wgprev,
                                 beta, part, cs, c)
    gout, wout = torch.empty_like(gam), torch.empty_like(wgam)
    ns.nsc_sweep_g(pos_s, ref_u, gam, gprev, wgam, wgprev, beta, part, cs, c,
                   gout, wout)
    ref_g, ref_w = ns.nsc_sweep_g_plain(pos_s, ref_u, gam, gprev, wgam,
                                        wgprev, beta, part, cs, c)
    errs = {
        "nsc_detect": {"partners": (0.0, 0.0)},
        "nsc_sweep_u": {
            "v": nsc_u_close(u[0:3], ref_u[0:3], f"{what} nsc_sweep_u v"),
            "w": nsc_u_close(u[3:6], ref_u[3:6], f"{what} nsc_sweep_u w")},
        "nsc_sweep_g": {
            "gamma": check_close(gout, ref_g, **NSC_SWEEP_TOL,
                                 what=f"{what} nsc_sweep_g gamma"),
            "wall gamma": check_close(wout, ref_w, **NSC_SWEEP_TOL,
                                      what=f"{what} nsc_sweep_g wall gamma")}}
    require(float((u - ufree).abs().max()) > 1e-4
            and bool((ref_g != 0).any()), f"{what}: no contact acted")
    inputs = dict(part=part, count=count, rev=rev, gam=gam, gprev=gprev,
                  wgam=wgam, wgprev=wgprev, u=ref_u, beta=beta, dc=dc,
                  masks=masks)
    return errs, inputs


def nsc_u_modes(by_name, seen, n):
    """U's device time per launch by mode (the step's first launch writes
    the wall masks, the others read them) from a profiled run's ``(device
    ms, launches)`` by kernel name; printed and returned by mode.  Fails
    unless both modes ran."""
    modes = {"<false>": "reading", "<true>": "writing"}
    out = {}
    for name in by_name:
        if "nsc_sweep_u_kernel" in name:
            mode = next((v for k, v in modes.items() if k in name),
                        name[:60])
            out[mode] = by_name[name] / seen[name]
            print(f"nsc_sweep_u at {n}, {mode} the wall masks: "
                  f"{out[mode]:.4f} ms of device time per launch over "
                  f"{seen[name]} launches in the profiled steps")
    require(set(out) == set(modes.values()),
            f"U's modes in the profiled steps at {n}: {sorted(out)}")
    return out


def nsc_profile(what, run):
    """Profile ``run`` (mixer steps): ``(device ms, launches) by kernel
    name, device ms in all``.  Fails unless the profiler saw every launch
    of the three NSC kernels that their wrappers counted in the run."""
    nsc_reset_launches()
    by_name, seen, busy = profile_call(what, run)
    for k, counted in nsc_launches().items():
        got = sum(v for name, v in seen.items() if f"{k}_kernel" in name)
        require(got == counted, f"{what}: the profiler saw {got} of "
                f"{counted} {k} launches")
    return by_name, seen, busy


def nsc_masks_check(masks, pos_s, cs, c, what):
    """U's wall masks against their twin's: equal, except for a body whose
    gap to a wall lies within 1e-6 m of the envelope (rounding may put it
    either side).  Prints the bodies within a wall's reach."""
    twin = ns.wall_masks_plain(pos_s, cs, c)
    near = torch.zeros_like(masks, dtype=torch.bool)
    for wall, pose in zip(c.walls, ns.wall_poses(c, cs)):
        gap = wall_geometry(wall, pos_s[0], pos_s[1], pos_s[2], c.radius,
                            pose)[1]
        near |= (gap - c.envelope).abs() < 1e-6
    off = int(((masks != twin) & ~near).sum())
    require(off == 0, f"{what}: {off} wall masks differ from the twin's")
    print(f"{what}: wall masks equal the twin's ({int(near.sum())} bodies "
          f"at an envelope's edge), {int(masks.bool().sum())} of "
          f"{masks.numel()} bodies within a wall's reach")


def nsc_sweep_scene():
    """The 24-sphere detection scene of tests/test_nsc_pencil.py:327 (seed
    11) under the blade walls at θ = 0.3, random velocities (seed 5)."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(0.12, 0.42, (24, 3)).astype(np.float32)
    rng = np.random.default_rng(5)
    vel = rng.normal(0.0, 0.2, pos.shape)
    om = rng.normal(0.0, 2.0, pos.shape)
    p = NSCPencilParams(radius=NSC_R, mass=0.5, mu=0.3, dt=1e-3,
                        envelope=0.05 * NSC_R)
    grid = GridSpec(cell_size=2.1 * NSC_R, dims=(5, 5, 5))
    return p, grid, pos, vel, om


def nsc_one_sweep():
    """Phase 7's kernel checks on the sweep scene, with P = 12 and with
    P = 2 (which overflows: only the first two partners are kept)."""
    p, grid, pos, vel, om = nsc_sweep_scene()
    pos_s, ufree, cells, ovf = nsc_bin(grid, pos, vel, om, p)
    require(ovf == 0, "the sweep scene overflows its cells")
    c = nsc_static_params(p, NSC_BLADE_WALLS)
    cs = nsc_blade_cs(NSC_BLADE_WALLS, 0.3)
    out = {}
    for P in (12, 2):
        errs, inp = nsc_kernels_vs_twins(pos_s, ufree, cells, c, cs, P,
                                         f"sweep scene P={P}")
        over = max(int(inp["count"].max()) - P, 0)
        require((over > 0) == (P == 2), f"P={P}: partner overflow {over}")
        out[P] = errs
    return out


def nsc_blade_scene(dynamic):
    """The blade scene of tests/test_nsc_pencil.py:361 (14 spheres, seed
    11, θ0 = 0.3) or the dynamic blade of tests/test_nsc_dynamic_blade.py
    (its spin a solver variable, driven by 0.05 N·m)."""
    if not dynamic:
        rng = np.random.default_rng(11)
        p = NSCPencilParams(radius=NSC_R, mass=0.5, mu=0.3, dt=1e-3,
                            n_iter=10, envelope=0.002 * NSC_R)
        pos = rng.uniform(0.12, 0.45, (14, 3))
        vel = rng.normal(0.0, 0.2, (14, 3))
        grid = GridSpec(cell_size=2.1 * NSC_R, dims=(5, 5, 5))
        return p, grid, NSC_BLADE_WALLS, pos, vel, dict(theta0=[0.3])
    cell = 2.1 * NSC_R
    c = (3 * cell, 3 * cell, NSC_R)
    walls = (NSC_BLADE_WALLS[0],
             ("rotbox", 2, c, (2.2 * NSC_R, 0.8 * NSC_R, 1.2 * NSC_R), 0.0,
              0.3))
    p = NSCPencilParams(radius=NSC_R, mass=0.2, mu=0.3, dt=1e-3, n_iter=30,
                        envelope=0.1 * NSC_R, omega=0.3, blade_inertia=0.05,
                        blade_torque=0.05)
    du, dv = 1.6 * NSC_R, 1.801 * NSC_R
    pos = np.asarray([[c[0] + du, c[1] + dv, NSC_R],
                      [c[0] - du, c[1] - dv, NSC_R]])
    grid = GridSpec(cell_size=cell, dims=(6, 6, 4))
    return p, grid, walls, pos, np.zeros((2, 3)), dict(wspin0=[0.0])


def nsc_two_steps(dynamic):
    """Two steps of the whole path on the card against the twins on the
    CPU; returns the max abs error over x, v, ω (and the spin)."""
    p, grid, walls, pos, vel, kw = nsc_blade_scene(dynamic)
    z = np.zeros_like(pos)
    card, plain = (make_nsc_pencil_advance(p, grid, walls, device=dev)(
        pos, vel, z, 2, **kw) for dev in (DEV, torch.device("cpu")))
    require(int(card[3]) == 0 and int(plain[3]) == 0, "NSC scene overflow")
    if dynamic:
        errs = [assert_close(card[0], plain[0], 1e-4, 2e-6, "dyn blade x"),
                assert_close(card[1], plain[1], 2e-3, 2e-5, "dyn blade v"),
                assert_close(card[4], plain[4], 2e-4, 1e-6, "dyn blade spin")]
        require(float(card[4][0]) > 0.0, "the dynamic blade did not spin up")
    else:
        errs = [assert_close(g, r, 0.0, atol, f"blade {name}") for g, r, atol,
                name in zip(card[:3], plain[:3], (2e-5, 2e-4, 2e-3),
                            ("x", "v", "w"))]
    require(float(plain[1].abs().max()) > (1e-6 if dynamic else 0.01),
            "no NSC contact acted")
    return max(errs)


# ---------------------------------------------------------------- phase 8


def mixer_scene(n_target=40_000):
    """bench_suite.py:296-407 bench_mixer_blade's scene (config #2, the
    reference's bladed mixer with gravity along −x): spheres of r = 3 cm,
    0.2 kg, μ 0.4, dt 2e-3 s, 50 APGD iterations, envelope 0.1 r, ω 0.3; a
    box tank of aspect 4 filled to a 0.58 packing by volume, cells of
    3.5 r with C = 8, five planes and a rotbox blade (0.45 Ly × 2r × 0.7
    depth half extents) spinning at π/3 rad/s about x; the lattice fill of
    2.02 r spacing skips the blade's footprint, jitter ±0.005 r (seed 4)."""
    radius = 0.03
    aspect = 4.0
    vol = n_target * (4.0 / 3.0) * np.pi * radius ** 3 / 0.58
    Ly = (4.0 * vol / aspect) ** (1 / 3)
    Lz = aspect * Ly
    depth = vol / (Ly * Lz)
    cell = 3.5 * radius
    dims = (int(np.ceil(3.0 * depth / cell)), int(np.ceil(Ly / cell)) + 2,
            int(np.ceil(Lz / cell)) + 2)
    grid = GridSpec(origin=(0.0, -cell, -cell), cell_size=cell, dims=dims)
    cy, cz = Ly / 2, Lz / 2
    spin = np.pi / 3
    blade = ("rotbox", 0, (0.6 * depth, cy, cz),
             (0.45 * Ly, 2.0 * radius, 0.7 * depth), spin, 0.4)
    walls = (("plane", (1.0, 0.0, 0.0), 0.0, (0.0, 0.0, 0.0), 0.4),
             ("plane", (0.0, 1.0, 0.0), 0.0, (0.0, 0.0, 0.0), 0.3),
             ("plane", (0.0, -1.0, 0.0), -Ly, (0.0, 0.0, 0.0), 0.3),
             ("plane", (0.0, 0.0, 1.0), 0.0, (0.0, 0.0, 0.0), 0.3),
             ("plane", (0.0, 0.0, -1.0), -Lz, (0.0, 0.0, 0.0), 0.3),
             blade)
    p = NSCPencilParams(radius=radius, mass=0.2, mu=0.4,
                        gravity=(-9.81, 0.0, 0.0), dt=2e-3, n_iter=50,
                        envelope=0.1 * radius, omega=0.3,
                        track_wall_reactions=True)
    rng = np.random.default_rng(4)
    s = 2.02 * radius
    ix, iy, iz = np.meshgrid(np.arange(radius * 1.2, 2.0 * depth, s),
                             np.arange(radius * 1.2, Ly - radius, s),
                             np.arange(radius * 1.2, Lz - radius, s),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    footprint = ((np.abs(iy - cy) < 0.45 * Ly + 3 * radius)
                 & (np.abs(iz - cz) < 5 * radius)
                 & (ix < 1.4 * depth + radius))
    pts = np.stack([ix, iy, iz], 1)[~footprint][:n_target]
    pts = pts + rng.uniform(-0.005, 0.005, pts.shape) * radius
    return p, grid, walls, pts, spin


def count_pairs(pos_s, cells, radius, envelope):
    """``bench_suite.py:410`` ``_count_pairs`` on cell-sorted bodies: the
    pairs closer than 2r + envelope, each once, and the deepest pair
    overlap 2r − |d|."""
    n = pos_s.shape[1]
    total, deepest = 0, 0.0
    step = max(1, (1 << 24) // (27 * cells.capacity))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        j, ok, _ = sph.neighbour_candidates(cells, lo, hi)
        d = pos_s[:, lo:hi, None] - pos_s[:, j]
        dist = torch.sqrt((d * d).sum(0) + 1e-18)
        total += int((ok & (dist < 2 * radius + envelope)).sum())
        deepest = max(deepest, float(torch.where(
            ok, 2 * radius - dist, torch.zeros_like(dist)).max()))
    return total // 2, deepest


def nsc_penetration(pos_s, cells, p, walls, theta):
    """The deepest overlap of a pair or of a body with a wall (m)."""
    _, deepest = count_pairs(pos_s, cells, p.radius, p.envelope)
    cs = nsc_blade_cs(walls, theta)
    for wall, pose in zip(walls, ns.wall_poses(
            nsc_static_params(p, walls), cs)):
        gap = wall_geometry(wall, pos_s[0], pos_s[1], pos_s[2], p.radius,
                            pose)[1]
        deepest = max(deepest, float((-gap).max()))
    return deepest


# bounds of the NSC kernels: float32 operations counted from
# csrc/nsc_pair.cuh and csrc/nsc_sweep.cu.  A detection candidate: the
# distance test (3 sub, 5 mul/add, add, sqrt, sub, compare).  A pair
# contact in U: its frame (~46), y (9), both sides' force and torque (~39);
# in G: the frame, the constraint velocity (~36), b, s, y and the cone
# projection (~79 more).  Every body tests every wall (a plane ~8, a rotbox
# ~60); a wall contact adds its tangents and, in U, its impulse (~67), in
# G its velocity, step and projection (~104).
NSC_OPS = {"detect_candidate": 12, "u_contact": 95, "g_contact": 125,
           "u_wall_contact": 67, "g_wall_contact": 104}
NSC_WALL_TEST_OPS = {"plane": 8, "cyl": 20, "rotbox": 60}


def detect_candidates(cells):
    """The candidate pairs of the forward half stencil: per body, the
    bodies of its 13 forward cells and those after it in its own cell."""
    nx, ny, nz = cells.dims
    cnt = cells.count.long().reshape(nx, ny, nz)
    pad = torch.nn.functional.pad(cnt, (1, 1, 1, 1, 1, 1))
    fwd = torch.zeros_like(cnt)
    for k in range(13):
        dx, dy, dz = nd.class_offset(k)
        fwd += pad[1 + dx:1 + dx + nx, 1 + dy:1 + dy + ny, 1 + dz:1 + dz + nz]
    return int((cnt * fwd + cnt * (cnt - 1) // 2).sum())


def nsc_bounds(n, P, walls, cells, inp, pos_s, c, cs):
    """(bound_ms, bound_by) of each kernel from this run's inputs: each
    input the function needs read once (the multipliers of the contacts
    there are, not of the empty slots), each output written once; the
    operations the function needs on these inputs."""
    W = len(walls)
    contacts = int((inp["part"] >= 0).sum())
    gaps = [wall_geometry(w, pos_s[0], pos_s[1], pos_s[2], c.radius, pose)[1]
            for w, pose in zip(walls, ns.wall_poses(c, cs))]
    wall_contacts = sum(int((g < c.envelope).sum()) for g in gaps)
    wall_tests = n * sum(NSC_WALL_TEST_OPS[w[0]] for w in walls)
    table = (n + 2 * cells.start.numel()) * 4
    # both sweeps read x, their u, the partner table, the pose rows and
    # (γ, γ_prev) of every contact; U also the reverse table
    common = 12 * n + 24 * n + 4 * n * P + 4 * cs.numel() \
        + 24 * (contacts + wall_contacts)
    return contacts, wall_contacts, {
        "nsc_detect": bound(12 * n + table + 4 * (n * P + n),
                            detect_candidates(cells)
                            * NSC_OPS["detect_candidate"]),
        "nsc_sweep_u": bound(common + 8 * n + 4 * contacts + 24 * n,
                             contacts * NSC_OPS["u_contact"] + wall_tests
                             + wall_contacts * NSC_OPS["u_wall_contact"]),
        "nsc_sweep_g": bound(common + 12 * n * (P + W),
                             contacts * NSC_OPS["g_contact"] + wall_tests
                             + wall_contacts * NSC_OPS["g_wall_contact"])}


def nsc_run(adv, pts, warm, steps, theta0):
    """From rest at ``pts``, ``warm`` steps (the bench's settle), then
    ``steps`` timed ones from pose ``theta0``: ``(advance's outputs, wall
    seconds)``; the last output is the last step's (force, torque) of each
    wall."""
    z = np.zeros_like(pts)
    out = adv(pts, z, z, warm)
    require(int(out[3]) == 0, f"warm-up overflow {int(out[3])}")
    pos, vel, om = out[:3]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = adv(pos, vel, om, steps, theta0=[theta0])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# the blow-up guard: the deepest overlap after the run, in radii.  A CPU
# rehearsal of the 40,000-sphere run (the twins, the same 50 steps) ended
# at 0.0121 r; 0.25 r is a blow-up, not a difference of sum order.
NSC_MAX_OVERLAP_R = 0.25


def mixer_main_path(card, n_target=40_000, warm=25, steps=25):
    p, grid, walls, pts, spin = mixer_scene(n_target)
    n = len(pts)
    P = 6
    print(f"NSC mixer: {n} spheres r {p.radius}, grid {grid.dims} "
          f"({grid.n_cells} cells of {grid.cell_size:.4f} m, C=8), P={P}, "
          f"{p.n_iter} APGD iterations, dt {p.dt}, {len(walls)} walls "
          f"(rotbox at {spin:.6f} rad/s)")
    adv = make_nsc_pencil_advance(p, grid, walls, partners=P, device=DEV)
    nsc_reset_launches()
    out, wall = nsc_run(adv, pts, warm, steps, warm * p.dt * spin)
    launches = nsc_launches()
    pos, vel, om, ovf, (wforce, wtorque) = out
    require(int(ovf) == 0, f"overflow {int(ovf)}")
    require(all(bool(torch.isfinite(a).all()) for a in (pos, vel, om)),
            "non-finite state")
    total = warm + steps
    require(launches == {"nsc_detect": total,
                         "nsc_sweep_u": total * (p.n_iter + 1),
                         "nsc_sweep_g": total * p.n_iter},
            f"launch counts {launches}")
    theta = total * p.dt * spin
    pos_s, _, cells, _ = nsc_bin(grid, pos, vel, om, p)
    contacts, _ = count_pairs(pos_s, cells, p.radius, p.envelope)
    deepest = nsc_penetration(pos_s, cells, p, walls, theta)
    torque_x = float(wtorque[5, 0])
    require(torque_x < 0.0, f"blade torque about x {torque_x} >= 0: it "
            "does not resist the spin")
    require(deepest < NSC_MAX_OVERLAP_R * p.radius,
            f"deepest overlap {deepest} m beyond "
            f"{NSC_MAX_OVERLAP_R} r: blow-up")
    rate = p.n_iter * steps / wall
    print(f"NSC mixer {n}: ovf 0, finite, launches {launches}, {contacts} "
          f"contacts, blade torque about x {torque_x:.6f} N·m, deepest "
          f"overlap {deepest / p.radius:.6f} r")
    print(f"NSC mixer {n}: {steps} steps in {wall:.4f} s = {rate:.6e} DVI "
          f"iterations/s, {wall / steps * 1e3:.4f} ms/step, RTF "
          f"{wall / (steps * p.dt):.4f} (host clock after synchronize) on "
          f"{card}; state after them sha256 {state_digest(pos, vel, om)}")
    by_name, seen, _ = nsc_profile(f"one mixer step at {n}", lambda: adv(
        pos, vel, om, 1, theta0=[theta]))
    u_modes = nsc_u_modes(by_name, seen, n)

    # each kernel against its twin at the main path's shapes
    pos_s, ufree, cells, _ = nsc_bin(grid, pos, vel, om, p)
    c = nsc_static_params(p, walls)
    cs = nsc_blade_cs(walls, theta)
    errs, inp = nsc_kernels_vs_twins(pos_s, ufree, cells, c, cs, P,
                                     f"mixer {n}")
    print(f"NSC kernels vs twins at {n}: {format_errs(errs)}")
    g2, w2 = torch.empty_like(inp["gam"]), torch.empty_like(inp["wgam"])
    u2 = torch.empty_like(ufree)
    a = (inp["gam"], inp["gprev"], inp["wgam"], inp["wgprev"], inp["beta"])
    calls = {
        "nsc_detect": (lambda: nd.nsc_detect(pos_s, cells, P, inp["dc"]),
                       lambda: nd.nsc_detect_plain(pos_s, cells, P,
                                                   inp["dc"])),
        "nsc_sweep_u": (
            lambda: ns.nsc_sweep_u(pos_s, ufree, *a, inp["part"], inp["rev"],
                                   cs, c, u2, inp["masks"]),
            lambda: ns.nsc_sweep_u_plain(pos_s, ufree, *a, inp["part"], cs,
                                         c)),
        "nsc_sweep_g": (
            lambda: ns.nsc_sweep_g(pos_s, inp["u"], *a, inp["part"], cs, c,
                                   g2, w2),
            lambda: ns.nsc_sweep_g_plain(pos_s, inp["u"], *a, inp["part"],
                                         cs, c))}
    contacts_p, wall_contacts, bounds = nsc_bounds(n, P, walls, cells, inp,
                                                  pos_s, c, cs)
    rows = []
    for name in NSC_KERNELS:
        ms = kernel_device_ms(calls[name][0], f"{name}_kernel", 50)
        issue_ms = cuda_ms(calls[name][0], 50)
        plain_ms = cuda_ms(calls[name][1], 3)
        bms, by = bounds[name]
        plane = max(errs[name], key=lambda q: errs[name][q][0])
        err = errs[name][plane][0]
        over_tol = max(r for _, r in errs[name].values())
        print(f"{name} at {n}: max abs err {err:.3e} ({plane}), "
              f"{over_tol:.3f} of its tolerance, {ms:.4f} ms of device time "
              f"per launch ({issue_ms:.4f} ms per wrapper call back to "
              f"back; plain twin {plain_ms:.4f} ms), {contacts_p} pair and "
              f"{wall_contacts} wall contacts, bound {bms:.6f} ms by {by}")
        rows.append({
            "name": name, "route": "cuda", "source": NSC_SOURCES[name],
            "replaces": NSC_REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "max_abs_err_plane": plane,
            "err_over_tol": over_tol, "ms": ms, "wrapper_ms": issue_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})
    rows[NSC_KERNELS.index("nsc_sweep_u")]["first_launch_ms"] = u_modes[
        "writing"]
    return rows


def mixer_large(card, n_target=400_000, warm=2, steps=20):
    """The same scene at 400,000 spheres, 2 warm-up and 20 timed steps,
    then profiled runs of one and of two steps from the same state (each
    kernel's device time per launch; the device time of a call's last step,
    which adds the wall reactions, and of a step before it), and each
    kernel against its twin there: where the kernels, not the launches, set
    the pace."""
    p, grid, walls, pts, spin = mixer_scene(n_target)
    n = len(pts)
    adv = make_nsc_pencil_advance(p, grid, walls, partners=6, device=DEV)
    out, wall = nsc_run(adv, pts, warm, steps, warm * p.dt * spin)
    pos, vel, om, ovf, (_, wtorque) = out
    require(int(ovf) == 0 and all(bool(torch.isfinite(a).all()) for a in
                                  (pos, vel, om)),
            f"{n} spheres: overflow {int(ovf)} or non-finite state")
    theta = (warm + steps) * p.dt * spin
    _, _, last = nsc_profile(f"one mixer step at {n}", lambda: adv(
        pos, vel, om, 1, theta0=[theta]))
    by_name, seen, both = nsc_profile(f"two mixer steps at {n}", lambda: adv(
        pos, vel, om, 2, theta0=[theta]))
    print(f"NSC mixer {n}: device time of a step {both - last:.4f} ms, of "
          f"a call's last step (with the wall reactions) {last:.4f} ms "
          "(profiler on)")
    ms = {}
    for k in NSC_KERNELS:
        names = [name for name in by_name if f"{k}_kernel" in name]
        ms[k] = (sum(by_name[name] for name in names)
                 / sum(seen[name] for name in names))
    pos_s, ufree, cells, _ = nsc_bin(grid, pos, vel, om, p)
    contacts, _ = count_pairs(pos_s, cells, p.radius, p.envelope)
    c = nsc_static_params(p, walls)
    cs = nsc_blade_cs(walls, theta)
    # each kernel against its twin here too, as at 40,000
    errs, inp = nsc_kernels_vs_twins(pos_s, ufree, cells, c, cs, 6,
                                     f"mixer {n}")
    print(f"NSC kernels vs twins at {n}: {format_errs(errs)}")
    bounds = nsc_bounds(n, 6, walls, cells, inp, pos_s, c, cs)[2]
    nsc_u_modes(by_name, seen, n)
    for k in NSC_KERNELS:
        bms, by = bounds[k]
        print(f"{k} at {n}: {ms[k]:.4f} ms per launch over the profiled "
              f"steps' launches, bound {bms:.6f} ms by {by}")
    rate = p.n_iter * steps / wall
    print(f"NSC mixer {n}: state after the timed steps sha256 "
          f"{state_digest(pos, vel, om)}")
    print(f"NSC mixer {n}: grid {grid.dims}, ovf 0, {contacts} contacts, "
          f"blade torque about x {float(wtorque[5, 0]):.6f} N·m; {steps} "
          f"steps in {wall:.4f} s = {rate:.6e} DVI iterations/s, "
          f"{wall / steps * 1e3:.4f} ms/step, RTF "
          f"{wall / (steps * p.dt):.4f}; device time per launch in the "
          "profiled steps: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f" on {card}")


# ---------------------------------------------------------------- phase 9


def forces_one_launch(params, grid, feat, what):
    """One ``dem_forces`` launch against its twin on the same planes, at
    test_pallas_kernel's bounds (rtol 1e-4, atol 1e-5 of the largest force,
    and for torques of the larger of the largest torque and r·F): ``(max
    abs err, ratio to the tolerance)``."""
    pair = pair_coefs(params, grid, feat.shape[2])
    got = feat.new_empty((6,) + tuple(feat.shape[1:]))
    dem_forces(feat, got, pair)
    ref = dem_forces_plain(feat, pair)
    empty = feat[9] < 0.5
    require(not bool(got[:, empty].any()), f"{what}: empty slots not zero")
    f_scale = float(ref[0:3].abs().max())
    t_atol = 1e-5 * max(float(ref[3:6].abs().max()), params.radius * f_scale)
    ef, rf = check_close(got[0:3], ref[0:3], 1e-4, 1e-5 * f_scale,
                         f"{what} force")
    et, rt = check_close(got[3:6], ref[3:6], 1e-4, t_atol, f"{what} torque")
    return max(ef, et), max(rf, rt)


def forces_small(friction_mode):
    """``dem_forces`` vs its twin on the 120-particle box with random
    velocities and spins."""
    params, _, grid, pos, C = small_scene(7, friction_mode)
    rng = np.random.default_rng(3)
    vel = rng.normal(0.0, 0.1, pos.shape).astype(np.float32)
    omega = rng.normal(0.0, 0.5, pos.shape).astype(np.float32)
    field = to_cells(grid, C, *(torch.as_tensor(a, device=DEV)
                                for a in (pos, vel, omega)))
    return forces_one_launch(params, grid, field.feat,
                             f"dem_forces 120 particles {friction_mode}")


def forces_path_three_cycles():
    """The forces path (``backend="pallas"``) for 3 cycles on the card vs
    on the CPU (twins) on the five-kind scene."""
    params, bcs, grid, pos, C = five_kind_scene()
    z = np.zeros_like(pos)
    card, plain = (make_cell_dense_advance(params, bcs, grid, capacity=C,
                                           backend="pallas",
                                           device=dev)(pos, z, z, 3)
                   for dev in (DEV, torch.device("cpu")))
    require(int(card[3]) == 0 and int(plain[3]) == 0,
            "overflow in the five-kind scene")
    require(float(plain[2].abs().max()) > 1.0, "no wall turned a particle")
    return max(assert_close(card[0], plain[0], **POS_TOL,
                            what="five kinds, 3 cycles, pos"),
               *(assert_close(g, r, **VEL_TOL,
                              what="five kinds, 3 cycles, vel/omega")
                 for g, r in zip(card[1:3], plain[1:3])))


# ---------------------------------------------------------------- phase 10


def bench_engine_scene(engine, n_target=1_000_000):
    """bench.py's pinned scene as it builds it for ``BENCH_ENGINE`` sym or
    pencil (cells of 1.45 d, C = 8) and pallas or xla (cells of two lattice
    spacings, C = 16), origin 0, the grid over the whole box
    (bench.py:83-158)."""
    params, bcs, _, pts, _ = bench_scene(n_target)
    radius = params.radius
    n_side = int(np.ceil(n_target ** (1 / 3)))
    box_w = n_side * 2.1 * radius * 1.02
    box_h = box_w * 1.6
    if engine in ("sym", "pencil"):
        cell, C = 1.45 * 2.0 * radius, 8
    else:
        cell, C = 2.0 * 2.1 * radius, 16
    dims = (int(np.ceil(box_w / cell)), int(np.ceil(box_w / cell)),
            int(np.ceil(box_h / cell)))
    return params, bcs, GridSpec(cell_size=cell, dims=dims), pts, C


def silo_walls():
    """Numpy leaves of the silo: a z-cylinder of R = 0.5 m about (0.5,
    0.5), a cone with its apex at (0.5, 0.5, 0) and slope 1 opening +z,
    and a spherical obstacle of R = 0.1 m at (0.5, 0.5, 0.7)."""
    f32 = np.float32
    return {"cylinders": {"center": np.array([[0.5, 0.5]], f32),
                          "radius": np.array([0.5], f32),
                          "vel": np.zeros((1, 3), f32)},
            "spheres": {"center": np.array([[0.5, 0.5, 0.7]], f32),
                        "radius": np.array([0.1], f32),
                        "vel": np.zeros((1, 3), f32)},
            "cones": {"apex": np.array([[0.5, 0.5, 0.0]], f32),
                      "slope": np.array([1.0], f32),
                      "vel": np.zeros((1, 3), f32)}}


def silo_scene(n_target=1_000_000):
    """bench.py's spheres and material (r = 5 mm, E = 1e7, μ 0.5, dt =
    2e-6, 100 substeps a cycle) on a 2.1 r lattice with 3 % jitter (seed
    0) filling the silo from the apex up, every sphere at least 0.1 r clear
    of every wall, capped at ``n_target``; cells of 4.2 r (two lattice
    spacings, commensurate with the lattice) over the bounding box, C =
    16."""
    params = bench_params()
    radius = params.radius
    spacing = 2.1 * radius
    bcs = convert.dem_boundaries_from_numpy(silo_walls())
    pts = grid_sample_box((0.0, 0.0, 0.0), (1.0, 1.0, 2.2), spacing,
                          jitter=0.03, seed=0)
    gap = wall_gaps(bcs, torch.as_tensor(pts, dtype=torch.float32,
                                         device=DEV), radius)
    inside = (gap > 0.1 * radius).all(1).cpu().numpy()
    pts = pts[inside]
    pts = pts[np.argsort(pts[:, 2], kind="stable")[:n_target]]
    cell = 2.0 * spacing
    z_hi = float(pts[:, 2].max()) + radius
    dims = (int(np.ceil(1.0 / cell)),) * 2 + (int(np.ceil(z_hi / cell)),)
    return (params, bcs, GridSpec(cell_size=cell, dims=dims),
            pts.astype(np.float32), 16)


def check_full_width(params, bcs, pos0, p, v, o, ovf, t_sim, what):
    """ovf 0, finite, no wall touched at the start or the end and no
    particle more than 0.25 r outside any wall, and then momentum: the
    pair forces cancel, so the mean velocity is free fall."""
    require(int(ovf) == 0, f"{what}: overflow {int(ovf)}")
    require(all(bool(torch.isfinite(a).all()) for a in (p, v, o)),
            f"{what}: non-finite state")
    r = params.radius
    gaps = [wall_gaps(bcs, torch.as_tensor(x, device=DEV), r).min()
            for x in (pos0, p)]
    require(float(gaps[1]) > -0.25 * r,
            f"{what}: a particle {float(-gaps[1]) / r} r into a wall")
    require(min(float(g) for g in gaps) > 0.0,
            f"{what}: particles touch a wall (gap {gaps}), so momentum is "
            "not free fall")
    mean_v = v.double().mean(0).cpu()
    require(abs(float(mean_v[2]) / (-G * t_sim) - 1) < 1e-3
            and float(mean_v[:2].abs().max()) < 1e-3 * G * t_sim,
            f"{what}: momentum off: mean v {mean_v.tolist()} vs -g t "
            f"{-G * t_sim}")
    return [float(g) / r for g in gaps], mean_v


def run_full_width(params, bcs, grid, pos, C, backend, what, card):
    """1 warm-up and 2 timed cycles through ``make_cell_dense_advance``
    with the kernel counts set to 0 just before: ``(state, wall seconds,
    launches)``."""
    adv = make_cell_dense_advance(params, bcs, grid, capacity=C,
                                  backend=backend, device=DEV)
    z = np.zeros_like(pos)
    dem_substep_rows.launches = dem_forces_rows.launches = 0
    p, v, o, ovf = adv(pos, z, z, 1)
    require(int(ovf) == 0, f"{what}: warm-up overflow {int(ovf)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, v, o, ovf2 = adv(p, v, o, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dem_substep": dem_substep_rows.launches,
                "dem_forces": dem_forces_rows.launches}
    t_sim = 3 * params.rebuild_every * params.dt
    gaps, mean_v = check_full_width(params, bcs, pos, p, v, o, ovf2, t_sim,
                                    what)
    n = len(pos)
    steps = 2 * params.rebuild_every
    print(f"{what}: ovf 0, launches {launches}, wall gap min "
          f"{gaps[0]:.4f} r at the start and {gaps[1]:.4f} r at the end, "
          f"mean v {mean_v.tolist()} (free fall {-G * t_sim:.6e})")
    print(f"{what}: {steps} substeps of {n} particles in {wall:.4f} s = "
          f"{n * steps / wall:.6e} particle-steps/s (2 cycles, each a sort "
          f"rebin; host clock) on {card}")
    return (p, v, o), wall, launches


def rebin_ms(grid, C, state):
    """One sort rebin: bin into rows by ``to_rows`` and unbin through each
    particle's row."""
    def rebin():
        rows, prow, _ = to_rows(grid, C, *state)
        return [rows.state[k, prow, :3] for k in range(3)]

    return cuda_ms(rebin, 5)


def forces_at(params, grid, field, what):
    """``dem_forces`` on a binned field against the float64 pair reference
    at the tolerance float32 supports, two planted faults that must fail
    it, its time on the field's rows, its twin's and
    its bound."""
    feat = field.feat
    C = feat.shape[2]
    pair = pair_coefs(params, grid, C)
    ref, tol, overlaps = pair_reference(feat, pair)
    out = feat.new_empty((6,) + tuple(feat.shape[1:]))
    dem_forces(feat, out, pair)
    require(not bool(out[:, feat[9] < 0.5].any()),
            f"dem_forces, {what}: empty slots not zero")
    err, ratio = tol_ratio(out, ref, tol)
    planes = {k: tol_ratio(out[sl], ref[sl], tol[sl])[1] for k, sl in
              (("F", slice(0, 3)), ("T", slice(3, 6)))}
    require(ratio <= 1.0, f"dem_forces, {what}: {planes} of its tolerance")
    faults = {}
    for name, bad in planted_faults(pair, overlaps).items():
        dem_forces(feat, out, bad)
        faults[name] = tol_ratio(out, ref, tol)[1]
        require(faults[name] > 1.0, f"dem_forces, {what}: the planted fault "
                f"{name} passes ({faults[name]:.3f} of the tolerance)")
    del ref, tol, out
    rows, _ = rows_from_slots(feat)
    f = rows.state.new_empty((2, rows.n_rows, 4))
    ms = cuda_ms(lambda: dem_forces_rows(rows, f, pair), 20)
    plain_ms = cuda_ms(lambda: dem_forces_rows_plain(rows, pair), 2)
    st = row_stats(rows, grid.dims, grid.n_cells)
    n_slots = feat.shape[1] * C
    contacts = len(overlaps)
    # the occupied particles' 9 floats in and 6 out, and the per-cell table
    b = bound((9 + 6) * 4 * st["M"] + st["table_bytes"],
              contacts * DEM_OPS_PER_CONTACT)
    print(f"dem_forces, {what}: max abs err {err:.3e} N or N·m against the "
          "float64 pair reference (of its tolerance: "
          + ", ".join(f"{k} {v:.4f}" for k, v in planes.items())
          + "; planted faults "
          + ", ".join(f"{k} {v:.2f}" for k, v in faults.items())
          + f" of it), {ms:.4f} ms per launch (plain twin {plain_ms:.4f} "
          f"ms, {contacts} contacts, "
          f"median overlap {float(overlaps.median()):.3e} m, M = {st['M']} "
          f"particles in {n_slots} slots, grid {st['grid']}, "
          f"{st['candidates_per_particle']:.2f} occupied candidates a "
          f"particle), bound {b[0]:.4f} ms by {b[1]}")
    return {"max_abs_err": err, "err_over_tol": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "M": st["M"]}


def device_ms(fn, reps=20, kernel=None, launches=0):
    """Device ms per call of ``fn``: over the kernels of ``reps``
    back-to-back calls under ``torch.profiler``, each kernel's mean time
    times its launches per call.  With ``kernel``, the profiler must have
    seen ``launches`` launches of it per call."""
    per_call = per_call_events(fn, reps)
    if kernel is not None:
        n = kernel_launches(per_call, kernel)
        require(n == launches, f"the profiler saw {n} launches of {kernel} "
                f"per call, not {launches}")
    return sum(us * n for us, n in per_call.values()) / 1e3


def forces_path_pieces(params, bcs, grid, C, state, what):
    """Device ms of one forces-path substep and of its parts on the rows of
    ``state`` (profiler device time over 20 calls of each): the pair
    kernel, the wall pass, the Euler step, and the whole
    ``forces_substep``; beside it the whole substep's time by CUDA events
    around 10 back-to-back calls.  The substep and the Euler step run on a
    copy of the rows, in place."""
    rows = to_rows(grid, C, *state)[0]
    pair = pair_coefs(params, grid, C)
    bcs_dev = bcs.to(DEV)
    out = rows.state.new_empty((2, rows.n_rows, 4))
    dem_forces_rows(rows, out, pair)
    work = replace(rows, state=rows.state.clone())
    f, t = out[0, :, :3], out[1, :, :3]

    def substep():
        forces_substep(params, bcs_dev, pair, work, out)

    k = ("dem_forces_kernel", 1)
    ms = {"dem_forces": device_ms(lambda: dem_forces_rows(rows, out, pair),
                                  20, *k),
          "wall pass": device_ms(lambda: wall_rows(params, bcs_dev,
                                                   rows.state)),
          "integration": device_ms(lambda: integrate_rows(params, work.state,
                                                          f, t)),
          "substep": device_ms(substep, 20, *k)}
    events = cuda_ms(substep, 10)
    rest = ms["substep"] - ms["dem_forces"] - ms["wall pass"] \
        - ms["integration"]
    print(f"forces path, {what}: per substep {ms['substep']:.4f} ms of "
          f"device time ({events:.4f} ms by CUDA events) = dem_forces "
          f"{ms['dem_forces']:.4f} + wall pass {ms['wall pass']:.4f} "
          f"({n_walls(bcs)} walls x {rows.n_rows} rows) + integration "
          f"{ms['integration']:.4f} + sums of forces {rest:.4f}; wall "
          f"pass {ms['wall pass'] / ms['substep']:.3f} and integration "
          f"{ms['integration'] / ms['substep']:.3f} of the substep's "
          "device time")
    return ms


def dem_full_width(card, n_target=1_000_000):
    """Phase 10: the sym / pencil scene through K1, the pallas / xla scene
    and the silo through the forces path, each at 1,000,000 spheres:
    ``(K1's numbers at the sym scene, dem_forces's row)``."""
    # sym and pencil: one run serves both names (the same K1 path)
    params, bcs, grid, pos, C = bench_engine_scene("sym", n_target)
    what = f"sym/pencil {len(pos)} (grid {grid.dims}, C={C})"
    state, wall, launches = run_full_width(params, bcs, grid, pos, C, "sym",
                                           what, card)
    require(launches == {"dem_substep": 300, "dem_forces": 0},
            f"{what}: launch counts {launches}")
    field, _, k1 = k1_at(params, bcs, grid, C, state, what)
    sym_row = {"launches_sym": launches["dem_substep"],
               **{f"{k}_sym": v for k, v in k1.items()}}
    del field
    print(f"{what}: rebin {rebin_ms(grid, C, state):.4f} ms")

    params, bcs, grid, pos, C = bench_engine_scene("pallas", n_target)
    what = f"pallas/xla {len(pos)} (grid {grid.dims}, C={C})"
    state, wall, launches = run_full_width(params, bcs, grid, pos, C,
                                           "pallas", what, card)
    require(launches == {"dem_substep": 0, "dem_forces": 300},
            f"{what}: launch counts {launches}")
    row = forces_at(params, grid, to_cells(grid, C, *state), what)
    row["launches"] = launches["dem_forces"]
    forces_path_pieces(params, bcs, grid, C, state, what)
    print(f"{what}: rebin {rebin_ms(grid, C, state):.4f} ms")
    adv = make_cell_dense_advance(params, bcs, grid, capacity=C,
                                  backend="pallas", device=DEV)
    profile_call(f"one forces-path cycle, {what}",
                 lambda: adv(*state, 1))

    params, bcs, grid, pos, C = silo_scene(n_target)
    what = (f"silo {len(pos)} (z to {float(pos[:, 2].max()):.4f} m, grid "
            f"{grid.dims}, C={C})")
    state, wall, launches = run_full_width(params, bcs, grid, pos, C,
                                           "pallas", what, card)
    require(launches == {"dem_substep": 0, "dem_forces": 300},
            f"{what}: launch counts {launches}")
    forces_at(params, grid, to_cells(grid, C, *state), what)
    forces_path_pieces(params, bcs, grid, C, state, what)
    print(f"{what}: rebin {rebin_ms(grid, C, state):.4f} ms")
    return sym_row, row


# ---------------------------------------------------------------- phase 11


MBS_H = 1e-3
MBS_STEPS = 2000
# the eager loops: bench_mbs's against the graph, and the double pendulum
# on the float32 precision stack (an eager step is 22–38 ms on the card;
# cut from 2,000 and 1,000 steps when phase 18 came, to keep chip_smoke.py
# within 1,000 s)
MBS_EAGER_STEPS = 300
FP_STACK_STEPS = 300
# the JAX package's direct-vs-Krylov bound (tests/test_mbs.py:246), and its
# closed-joint bound (tests/test_mbs.py:54)
MBS_X_ATOL = 2e-4
MBS_VIOLATION = 1e-3
# the graph replay against the eager loop when not bit for bit
MBS_REPLAY_RTOL = 1e-6
SLIDER_R, SLIDER_L, CRANK_SPEED = 0.5, 2.0, 2.0


def mbs_bench_scene(device):
    """``bench_suite.py:37-80`` ``bench_mbs`` (config #1): a double pendulum
    and a slider-crank, through the port's builder."""
    bld = SystemBuilder(device=device)
    g = bld.add_ground()
    p1 = bld.add_body(mass=1.0, pos=(0.5, 0, 0))
    p2 = bld.add_body(mass=1.0, pos=(1.0, 0, 0))
    bld.add_joint("revolute", g, p1, world_pos=(0, 0, 0),
                  world_axis=(0, 1, 0))
    bld.add_joint("revolute", p1, p2, world_pos=(0.5, 0, 0),
                  world_axis=(0, 1, 0))
    crank = bld.add_body(mass=2.0, inertia=(0.1, 0.1, 0.1), pos=(0, 2, 0))
    rod = bld.add_body(mass=1.0, pos=(0.3, 2, 0))
    slider = bld.add_body(mass=0.5, pos=(0.6, 2, 0))
    bld.add_joint("revolute", g, crank, world_pos=(0, 2, 0),
                  world_axis=(0, 1, 0))
    bld.add_joint("spherical", crank, rod, world_pos=(0.15, 2, 0))
    bld.add_joint("spherical", rod, slider, world_pos=(0.6, 2, 0))
    bld.add_joint("prismatic", g, slider, world_pos=(0.6, 2, 0),
                  world_axis=(1, 0, 0))
    return bld.finalize()


def mbs_slider_crank(device):
    """``demos/demo_mbs_slider_crank.py:18-36``: the crank driven at
    2 rad/s by a speed motor."""
    r, l = SLIDER_R, SLIDER_L
    bld = SystemBuilder(device=device)
    ground = bld.add_ground()
    crank = bld.add_body(mass=1.0, inertia=(0.1,) * 3, pos=(r / 2, 0, 0))
    rod = bld.add_body(mass=1.0, inertia=(0.1,) * 3, pos=(r + l / 2, 0, 0))
    slider = bld.add_body(mass=1.0, inertia=(0.1,) * 3, pos=(r + l, 0, 0))
    bld.add_motor_rotation_speed(ground, crank, world_pos=(0, 0, 0),
                                 world_axis=(0, 1, 0),
                                 profile=FConst(c=torch.tensor(CRANK_SPEED)))
    bld.add_joint("spherical", crank, rod, world_pos=(r, 0, 0))
    bld.add_joint("universal", rod, slider, world_pos=(r + l, 0, 0),
                  world_axis=(1, 0, 0))
    bld.add_joint("prismatic", ground, slider, world_pos=(r + l, 0, 0),
                  world_axis=(1, 0, 0))
    return bld.finalize()


def mbs_double_pendulum(device):
    """``bench_mbs``'s double pendulum alone."""
    bld = SystemBuilder(device=device)
    g = bld.add_ground()
    p1 = bld.add_body(mass=1.0, pos=(0.5, 0, 0))
    p2 = bld.add_body(mass=1.0, pos=(1.0, 0, 0))
    bld.add_joint("revolute", g, p1, world_pos=(0, 0, 0),
                  world_axis=(0, 1, 0))
    bld.add_joint("revolute", p1, p2, world_pos=(0.5, 0, 0),
                  world_axis=(0, 1, 0))
    return bld.finalize()


def mbs_eager(model, state, n, settings, **carry):
    """``n`` steps of ``step_euler_implicit_linearized`` in a Python loop,
    ``t`` a float32 device scalar advanced by h as ``simulate`` advances
    it; ``carry`` holds ``position_comp`` / ``stab_state`` when given."""
    t = torch.zeros((), dtype=state.x.dtype, device=state.x.device)
    for _ in range(n):
        out = step_euler_implicit_linearized(model, state, t, MBS_H,
                                             settings, **carry)
        state = out[0]
        if "position_comp" in carry:
            carry["position_comp"] = out[1]
        if "stab_state" in carry:
            carry["stab_state"] = out[-2]
        t = t + MBS_H
    return state


def mbs_violation(model, state):
    return max((float(joint_violation(k, d, state.x, state.q).abs().max())
                for k, d in model.joints.items()), default=0.0)


def mbs_state_err(got, ref):
    """max |got − ref| over x, q, v, w, and that over max |ref|."""
    err = max(float((getattr(got, f) - getattr(ref, f)).abs().max())
              for f in "xqvw")
    scale = max(float(getattr(ref, f).abs().max()) for f in "xqvw")
    return err, err / scale


def mbs_timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mbs_launches_per_step(model, state, settings):
    """Kernels one eager step launches, from the profiler (the graph
    replays the same step: these kernels and the state copies)."""
    mbs_eager(model, state, 1, settings)
    _, events = device_events(lambda: mbs_eager(model, state, 1, settings))
    names = {}
    for e in events:
        names[e.name] = names.get(e.name, 0) + 1
    return len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3,\
        names


def mbs_main_path(card):
    """Config #1 on the card: ``bench_mbs`` through ``simulate`` (one
    captured CUDA graph of the step, replayed) and through an eager loop of
    the step, held to each other and to the port's own CPU run; the
    slider-crank demo; a double pendulum on the float32 precision stack
    (filtered Baumgarte + the Kahan position carry)."""
    # N = D M⁻¹ Dᵀ must be full float32 (solver/direct.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    settings = SolverSettings(solver="direct")
    model, state = mbs_bench_scene(DEV)
    n_rows = sum(data.n * JOINT_TYPES[k][1]
                 for k, data in model.joints.items())
    print(f"bench_mbs: {model.n_bodies} bodies, {n_rows} joint rows, "
          f"h = {MBS_H}, solver direct")

    # one step: the graph replay against the eager step, from one state
    one_g, _ = simulate(model, state, MBS_H, 1, settings, save_every=0)
    one_e = mbs_eager(model, state, 1, settings)
    err1, rel1 = mbs_state_err(one_g, one_e)
    require(rel1 <= MBS_REPLAY_RTOL, f"one step, graph vs eager: {err1}")
    print(f"bench_mbs, one step, graph replay vs eager step: max abs err "
          f"{err1:.3e} ({'bit for bit' if err1 == 0 else f'{rel1:.3e} rel'})")

    # warm-ups, then the timed runs: simulate() whole (warm-up step,
    # capture, replays) and with no step, so the replays' share is the
    # difference; the eager loop
    simulate(model, state, MBS_H, 10, settings, save_every=0)
    mbs_eager(model, state, 10, settings)
    (_, _), t_setup = mbs_timed(lambda: simulate(model, state, MBS_H, 0,
                                                 settings, save_every=0))
    (graph_state, _), t_graph = mbs_timed(lambda: simulate(
        model, state, MBS_H, MBS_STEPS, settings, save_every=0))
    graph_short, _ = simulate(model, state, MBS_H, MBS_EAGER_STEPS,
                              settings, save_every=0)
    eager_state, t_eager = mbs_timed(lambda: mbs_eager(
        model, state, MBS_EAGER_STEPS, settings))
    sim_s = MBS_STEPS * MBS_H
    replay_ms = (t_graph - t_setup) / MBS_STEPS * 1e3
    print(f"bench_mbs, {MBS_STEPS} steps, simulate (graph replay): "
          f"{t_graph / MBS_STEPS * 1e3:.4f} ms/step, RTF "
          f"{t_graph / sim_s:.4f} (the call: warm-up step and capture "
          f"{t_setup * 1e3:.2f} ms, replays {replay_ms:.4f} ms/step) "
          f"[{card}]")
    print(f"bench_mbs, {MBS_EAGER_STEPS} steps, eager loop: "
          f"{t_eager / MBS_EAGER_STEPS * 1e3:.4f} ms/step, RTF "
          f"{t_eager / (MBS_EAGER_STEPS * MBS_H):.4f} [{card}]")
    err, rel = mbs_state_err(graph_short, eager_state)
    require(rel <= MBS_REPLAY_RTOL,
            f"{MBS_EAGER_STEPS} steps, graph vs eager: max abs err {err}")
    print(f"bench_mbs, {MBS_EAGER_STEPS} steps, graph replay vs eager "
          f"loop: max abs err {err:.3e} "
          f"({'bit for bit' if err == 0 else f'{rel:.3e} rel'})")
    require(all(bool(torch.isfinite(getattr(graph_state, f)).all())
                for f in "xqvw"), "bench_mbs: non-finite state")
    viol = mbs_violation(model, graph_state)
    require(viol < MBS_VIOLATION, f"bench_mbs: joint violation {viol}")
    print(f"bench_mbs after {MBS_STEPS} steps: finite, joint violation "
          f"{viol:.3e} (< {MBS_VIOLATION})")

    # the card against the port's own CPU run (the double pendulum is
    # chaotic: 200 steps)
    cpu_model, cpu_state = mbs_bench_scene("cpu")
    card_200, _ = simulate(model, state, MBS_H, 200, settings, save_every=0)
    cpu_200, _ = simulate(cpu_model, cpu_state, MBS_H, 200, settings,
                          save_every=0)
    err = float((card_200.x.cpu() - cpu_200.x).abs().max())
    require(err <= MBS_X_ATOL, f"bench_mbs, card vs CPU, 200 steps: {err}")
    print(f"bench_mbs, 200 steps, card vs the port on the CPU: max |Δx| "
          f"{err:.3e} (≤ {MBS_X_ATOL})")

    n, busy, names = mbs_launches_per_step(model, state, settings)
    top = ", ".join(f"{k[:40]} {v}" for k, v in sorted(
        names.items(), key=lambda kv: -kv[1])[:6])
    print(f"bench_mbs, one eager step under the profiler: {n} kernel "
          f"launches, {busy:.4f} ms of device time ({top})")

    # the slider-crank demo, 3,000 steps through simulate
    sc_model, sc_state = mbs_slider_crank(DEV)
    steps = 3000
    (sc_final, (xs, qs)), t_sc = mbs_timed(lambda: simulate(
        sc_model, sc_state, MBS_H, steps, settings))
    sx = xs[:, 3, 0]
    lo, hi = float(sx.min()), float(sx.max())
    require(SLIDER_L - SLIDER_R - 0.01 <= lo and hi <= SLIDER_L + SLIDER_R
            + 0.01, f"slider-crank: slider x in [{lo}, {hi}]")
    # the crank turns about world y: its angle atan2(R02, R00) from its
    # orientation, unwrapped step by step
    w, x, y, z = qs[:, 1].unbind(-1)
    angle = torch.atan2(2 * (x * z + w * y), 1 - 2 * (y * y + z * z))
    turned = float(((torch.diff(angle) + np.pi).remainder(2 * np.pi)
                    - np.pi).sum())
    mean_speed = turned / ((steps - 1) * MBS_H)
    w_end = float(sc_final.w[1, 1])
    require(abs(mean_speed - CRANK_SPEED) < 0.01
            and abs(w_end - CRANK_SPEED) < 0.01,
            f"slider-crank: crank speed {mean_speed}, {w_end} at the end")
    print(f"slider-crank, {steps} steps (simulate, {t_sc / steps * 1e3:.4f} "
          f"ms/step): slider x in [{lo:.4f}, {hi:.4f}] (stroke "
          f"[{SLIDER_L - SLIDER_R}, {SLIDER_L + SLIDER_R}] ± 0.01), crank "
          f"{mean_speed:.5f} rad/s on average, {w_end:.5f} at the end "
          f"(motor {CRANK_SPEED})")

    # the float32 precision stack: filtered Baumgarte + Kahan carry
    fp_settings = SolverSettings(solver="direct", stab_mode="filtered",
                                 stab_deadband=1e-6)

    def stack_run(dev, n):
        m, st = mbs_double_pendulum(dev)
        return m, mbs_eager(
            m, st, n, fp_settings,
            position_comp=(torch.zeros_like(st.x), torch.zeros_like(st.q)),
            stab_state=init_stab_state(m, st, 0.0, MBS_H, fp_settings))

    _, card_stack = stack_run(DEV, 200)
    _, cpu_stack = stack_run("cpu", 200)
    err = float((card_stack.x.cpu() - cpu_stack.x).abs().max())
    require(err <= MBS_X_ATOL, f"filtered + Kahan, card vs CPU: {err}")
    steps = FP_STACK_STEPS
    (fp_model, fp_state), t_fp = mbs_timed(lambda: stack_run(DEV, steps))
    viol = mbs_violation(fp_model, fp_state)
    require(all(bool(torch.isfinite(getattr(fp_state, f)).all())
                for f in "xqvw") and viol < MBS_VIOLATION,
            f"filtered + Kahan: joint violation {viol}")
    print(f"double pendulum, filtered Baumgarte + Kahan carry: 200 steps "
          f"card vs CPU max |Δx| {err:.3e}; {steps} eager steps "
          f"({t_fp / steps * 1e3:.4f} ms/step): finite, joint violation "
          f"{viol:.3e}")



# ---------------------------------------------------------------- phase 12


MIXER_H = 2e-3
MIXER_R = 0.03
MIXER_SPEED = 2.0
# the JAX package's valence bound for the mixer (bench_suite.py:150-154)
MIXER_VALENCE = 32
# card against the port on the CPU, 5 steps of the 512-sphere mixer: the
# North star's state tolerances (positions rtol 1e-4 / atol 1e-5, velocities
# rtol 1e-3 / atol 1e-4); APGD's iteration counts within 1
MIXER_X_TOL = (1e-4, 1e-5)
MIXER_V_TOL = (1e-3, 1e-4)


def general_mixer_scene(n_target, device, dtype=torch.float32):
    """``bench_suite.py:83-199`` ``bench_mixer`` (config #2 as the
    reference's ``btest_CH_mixerNSC``): spheres of r = 3 cm, 0.2 kg, μ 0.4
    on a jittered grid (seed 2) in a box of five wall boxes on the ground,
    and a paddle box on a 20 kg stirrer driven at 2 rad/s by a speed motor;
    cells of 2.2·2r, 16 a cell, 12 contacts a sphere; APGD, 50 iterations,
    tol 1e-4, stab 0.2, recovery 0.5 m/s.  Built by the port's builder.
    Returns ``(model, coll, state, settings, stirrer, box)``."""
    radius = MIXER_R
    spacing = 2.2 * radius
    box = 0.08 + spacing * int(np.ceil(n_target ** (1 / 3)) + 1)
    bld = SystemBuilder(dtype=dtype, device=device)
    ground = bld.add_ground()
    pts = grid_sample_box((0.07, 0.07, 0.07),
                          (box - 0.07, box - 0.07, 4 * box),
                          spacing, jitter=0.05, seed=2)[:n_target]
    first = None
    for pt in pts:
        b = bld.add_body(mass=0.2, inertia=(2e-4,) * 3, pos=pt)
        first = b if first is None else first
    centre = (box / 2, box / 2, 1.5 * radius)
    stirrer = bld.add_body(mass=20.0, inertia=(0.5, 0.5, 0.5), pos=centre)
    bld.add_motor_rotation_speed(ground, stirrer, centre, (0, 0, 1),
                                 FConst(c=torch.tensor(MIXER_SPEED)))
    model, state = bld.finalize()
    n = len(pts)
    dev = state.x.device

    def t(a, dtype=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    spheres = SphereShapes(
        body=torch.arange(first, first + n, dtype=torch.int32, device=dev),
        offset=t(np.zeros((n, 3))), radius=t(np.full(n, radius)),
        mu=t(np.full(n, 0.4)))
    t_w, half = 0.05, box / 2
    walls = [
        ((half, half, -t_w / 2), (half, half, t_w / 2)),            # floor
        ((-t_w / 2, half, 2 * box), (t_w / 2, half + t_w, 2 * box)),
        ((box + t_w / 2, half, 2 * box), (t_w / 2, half + t_w, 2 * box)),
        ((half, -t_w / 2, 2 * box), (half + t_w, t_w / 2, 2 * box)),
        ((half, box + t_w / 2, 2 * box), (half + t_w, t_w / 2, 2 * box)),
    ]
    boxes = BoxShapes(
        body=t([0] * 5 + [stirrer], torch.int32),
        pos=t([w[0] for w in walls] + [(0.3 * half, 0.0, 0.0)]),
        rot=t(np.tile([1.0, 0, 0, 0], (6, 1))),
        half=t([w[1] for w in walls] + [(0.3 * half, 0.02, 2 * radius)]),
        mu=t(np.full(6, 0.4)))
    cell = 2.2 * 2 * radius
    grid = GridSpec(origin=(-t_w, -t_w, -t_w), cell_size=cell,
                    dims=(int(np.ceil((box + 2 * t_w) / cell)),) * 2
                    + (int(np.ceil(5 * box / cell)),))
    coll = CollisionModel(spheres=spheres, boxes=boxes, grid=grid,
                          max_per_cell=16, max_contacts=int(12 * n))
    settings = SolverSettings(solver="apgd", max_iter=50, tol=1e-4,
                              stab_factor=0.2, max_recovery_speed=0.5,
                              valence_bound=MIXER_VALENCE)
    return model, coll, state, settings, stirrer, box


def mixer_stats(model, coll, state, contacts, info, stirrer, box):
    """One step's figures as device tensors (read once at the end): the
    true contact count, APGD's iterations, the fullest cell, the most rows
    on a movable body as the JAX package's gather plan counts them (every
    row, active or not) and of the active rows alone, and the checks'
    flags: a finite state, every sphere inside the box, the stirrer's
    spin."""
    sp = coll.spheres
    movable = model.props.inv_mass > 0
    bilateral = bilateral_valence(model)

    def valence(keep):
        # three rows a contact on each of its two bodies (integer counts:
        # the order of the adds does not matter)
        sides = torch.cat([contacts.body_a, contacts.body_b]).long()
        count = bilateral.clone()
        count.scatter_add_(0, sides, torch.cat([keep, keep]).long() * 3)
        return torch.where(movable, count, torch.zeros_like(count)).max()

    x = state.x[sp.body.long()]
    inside = ((x[:, 0] >= 0) & (x[:, 0] <= box) & (x[:, 1] >= 0)
              & (x[:, 1] <= box) & (x[:, 2] > -MIXER_R)).all()
    finite = torch.stack([torch.isfinite(getattr(state, f)).all()
                          for f in "xqvw"]).all()
    return torch.stack([
        contacts.count.long(), info.iterations.long(),
        cell_occupancy_max(coll.grid, x).long(),
        valence(torch.ones_like(contacts.active)),
        valence(contacts.active), finite.long(), inside.long(),
        ]), state.w[stirrer, 2]


def bilateral_valence(model):
    """Bilateral rows on each body (a joint kind's rows, a motor's one row,
    on both of its bodies): the mixer's speed motor puts its guiding
    revolute's 5 rows and its speed row on the stirrer."""
    count = torch.zeros(model.n_bodies, dtype=torch.int64,
                        device=model.props.inv_mass.device)
    for rows, group in ((None, model.joints), (1, model.motors)):
        for kind, d in group.items():
            w = JOINT_TYPES[kind][1] if rows is None else rows
            for body in (d.body_a, d.body_b):
                count.scatter_add_(0, body.long(),
                                   torch.full_like(body.long(), w))
    return count


def mixer_steps(model, coll, state, settings, n, gamma, t, stirrer, box,
                stats=None):
    """``n`` steps of ``nsc_step``, the warm start carried as the bench
    carries it (``info.joint_reactions * h``); ``stats`` collects each
    step's ``mixer_stats``."""
    for _ in range(n):
        state, contacts, info = nsc_step(model, coll, state, t, MIXER_H,
                                         settings, gamma_warm=gamma)
        gamma = info.joint_reactions * MIXER_H
        t = t + MIXER_H
        if stats is not None:
            stats.append(mixer_stats(model, coll, state, contacts, info,
                                     stirrer, box))
    return state, gamma, t


def mixer_check(stats, coll, what):
    """Raise unless every step held: returns the per-step table (numpy)
    and the stirrer's spins."""
    table = torch.stack([s for s, _ in stats]).cpu().numpy()
    spin = torch.stack([w for _, w in stats]).cpu().numpy()
    count, _, occ, _, _, finite, inside = table.T
    require(finite.all(), f"{what}: a non-finite state")
    require((count <= coll.max_contacts).all(),
            f"{what}: {int(count.max())} contacts past the capacity "
            f"{coll.max_contacts}")
    require((occ <= coll.max_per_cell).all(),
            f"{what}: {int(occ.max())} spheres in a cell "
            f"(max_per_cell {coll.max_per_cell})")
    require(inside.all(), f"{what}: a sphere left the box")
    return table, spin


def mixer_bilateral_rows(model):
    return sum(JOINT_TYPES[k][1] * d.n for k, d in model.joints.items()) + \
        sum(d.n for d in model.motors.values())


def mixer_start(model, coll, state):
    m = coll.max_contacts * 3 + mixer_bilateral_rows(model)
    return (state.x.new_zeros((m,)),
            torch.zeros((), dtype=torch.float32, device=state.x.device))


def general_mixer_main_path(card, n_target=10_000, settle=150, timed=50):
    """Config #2 as ``bench_mixer`` builds it, through ``nsc_step``: 150
    settling and 50 timed steps at full width, the checks at every step,
    the bit-for-bit repeat, a profiled step; then the 512-sphere scene
    against the port on the CPU, every solver on ``drop_scene``, the Krylov
    solvers through ``simulate`` and an SMC scene."""
    model, coll, state, settings, stirrer, box = general_mixer_scene(
        n_target, DEV)
    n = coll.spheres.n
    print(f"general mixer: {n} spheres, box {box:.4f} m, grid "
          f"{coll.grid.dims} of {coll.grid.cell_size:.3f} m, max_per_cell "
          f"{coll.max_per_cell}, max_contacts {coll.max_contacts}, "
          f"{mixer_bilateral_rows(model)} bilateral rows, APGD "
          f"{settings.max_iter} iterations, tol {settings.tol}")
    gamma, t = mixer_start(model, coll, state)
    stats = []
    t0 = time.perf_counter()
    state, gamma, t = mixer_steps(model, coll, state, settings, settle,
                                  gamma, t, stirrer, box, stats)
    torch.cuda.synchronize()
    t_settle = time.perf_counter() - t0
    table, spin = mixer_check(stats, coll, "settling")
    print(f"general mixer, {settle} settling steps: {t_settle:.2f} s; "
          f"contacts {int(table[0, 0])} → {int(table[-1, 0])}, fullest "
          f"cell {int(table[:, 2].max())}, stirrer {spin[-1]:.6f} rad/s")
    require(abs(spin[-1] - MIXER_SPEED) <= 0.01 * MIXER_SPEED,
            f"the stirrer at {spin[-1]} rad/s after settling")

    # the timed steps, their figures read once at the end
    stats = []
    tvi.reset_host_reads()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    after, g_after, t_after = mixer_steps(model, coll, state, settings,
                                          timed, gamma, t, stirrer, box,
                                          stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    reads = tvi.host_reads() / timed
    table, spin = mixer_check(stats, coll, "timed steps")
    require((np.abs(spin - MIXER_SPEED) <= 0.01 * MIXER_SPEED).all(),
            f"the stirrer between {spin.min()} and {spin.max()} rad/s")
    iters = table[:, 1]
    over = int((table[:, 3] > MIXER_VALENCE).sum())
    over_active = int((table[:, 4] > MIXER_VALENCE).sum())
    print(f"general mixer, {timed} timed steps [{card}]: "
          f"{iters.sum() / dt:.1f} DVI iterations/s, "
          f"{dt / timed * 1e3:.3f} ms a step, RTF "
          f"{dt / (timed * MIXER_H):.3f}; {table[:, 0].mean():.1f} contacts "
          f"and {iters.mean():.2f} APGD iterations a step on average, "
          f"{reads:.1f} host reads a step; stirrer {spin.min():.6f}–"
          f"{spin.max():.6f} rad/s")
    print(f"general mixer, the JAX package's gather plan at valence "
          f"{MIXER_VALENCE}: it would have overflowed in {over} of {timed} "
          f"steps (most rows on a movable body, every row: "
          f"{int(table[:, 3].max())}; the inactive rows all point at one "
          f"sphere and the stirrer), in {over_active} counting active rows "
          f"alone (most {int(table[:, 4].max())}, on average "
          f"{table[:, 4].mean():.1f})")
    print(f"general mixer state digest after {settle + timed} steps: "
          f"{state_digest(after.x, after.q, after.v, after.w)}")

    # no atomics: two runs of 20 steps from the same state, bit for bit
    runs = [mixer_steps(model, coll, state, settings, 20, gamma, t,
                        stirrer, box) for _ in range(2)]
    same = all(torch.equal(getattr(runs[0][0], f), getattr(runs[1][0], f))
               for f in "xqvw") and torch.equal(runs[0][1], runs[1][1])
    require(same, "two runs of 20 mixer steps from one state differ")
    print("general mixer, two runs of 20 steps from one state: equal bit "
          "for bit (x, q, v, w and the warm start)")

    # the solvers' D u fetches its rows' bodies by flat gathers: both forms
    # timed at the mixer's rows
    m = coll.max_contacts * 3 + mixer_bilateral_rows(model)
    u8 = torch.randn(model.n_bodies, 8, device=DEV)
    body = torch.randint(0, model.n_bodies, (m,), device=DEV)
    take = (body[:, None] * 8 + torch.arange(8, device=DEV)).reshape(-1)
    require(torch.equal(u8[body], torch.take(u8, take).view(-1, 8)),
            "the flat gather differs from the row gather")
    print(f"general mixer, a gather of {m} rows of ({model.n_bodies}, 8): "
          f"row gather u8[body] {cuda_ms(lambda: u8[body], 50):.4f} ms, "
          f"flat torch.take {cuda_ms(lambda: torch.take(u8, take), 50):.4f} "
          f"ms (CUDA events, back to back)")

    # one profiled step: kernels and device time
    wall, events = device_events(lambda: mixer_steps(
        model, coll, state, settings, 1, gamma, t, stirrer, box))
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    print(f"general mixer, one profiled step: {len(events)} kernels, "
          f"{busy:.3f} ms of device time in {wall * 1e3:.3f} ms of wall "
          f"(idle {1 - busy / (wall * 1e3):.4f}, profiler on)")

    mixer_card_vs_cpu()
    every_solver_on_the_card()
    krylov_through_simulate()
    smc_on_the_card()


def mixer_card_vs_cpu(n_target=512, settle=100, steps=5):
    """The mixer cut to 512 spheres, settled 100 steps on the card, then 5
    steps on the card and through the port on the CPU from that state, in
    float64 and in float32.

    The scene is chaotic under 50 APGD iterations: on the CPU a warm start
    changed by one part in 1e7 moves spheres by up to ~5e-4 m and 0.2 m/s
    in these 5 steps, so rounding alone parts card and CPU in float32.  In
    float64 they are held at the North star's tolerances; in float32
    within four times what that perturbation of the warm start does to
    the CPU's own run (its sensitivity, measured here), and at least the
    North star's.  The iteration counts within 1 in both."""
    model, coll, state, settings, stirrer, box = general_mixer_scene(
        n_target, DEV)
    gamma, t = mixer_start(model, coll, state)
    state, gamma, t = mixer_steps(model, coll, state, settings, settle,
                                  gamma, t, stirrer, box)
    for dtype in (torch.float64, torch.float32):
        runs = {}
        for where, eps in (("card", 0.0), ("cpu", 0.0), ("cpu+", 1e-7)):
            dev = DEV if where == "card" else torch.device("cpu")
            m, c, _, _, _, _ = general_mixer_scene(n_target, dev, dtype)
            st = BodyState(**{f: getattr(state, f).to(dev, dtype)
                              for f in "xqvw"})
            stats = []
            end = mixer_steps(m, c, st, settings, steps,
                              gamma.to(dev, dtype) * (1 + eps),
                              t.to(dev, dtype), stirrer, box, stats)[0]
            runs[where] = (BodyState(**{f: getattr(end, f).cpu().double()
                                        for f in "xqvw"}),
                           [int(s[0][1]) for s in stats],
                           [int(s[0][0]) for s in stats])
        card, cpu, nudged = runs["card"], runs["cpu"], runs["cpu+"]
        require(all(abs(a - b) <= 1 for a, b in zip(card[1], cpu[1])),
                f"{dtype}: APGD iterations, card {card[1]} vs CPU {cpu[1]}")
        out = []
        for f, (rtol, atol) in (("x", MIXER_X_TOL), ("v", MIXER_V_TOL)):
            got, ref = getattr(card[0], f), getattr(cpu[0], f)
            sens = float((getattr(nudged[0], f) - ref).abs().max())
            if dtype == torch.float32:
                atol = max(atol, 4 * sens)
            err = check_close(got, ref, rtol, atol,
                              f"mixer card vs CPU, {dtype}, {f}")
            out.append(f"max |Δ{f}| {err[0]:.3e} ({err[1]:.3f} of its "
                       f"tolerance; the CPU's sensitivity {sens:.3e})")
        print(f"general mixer, {n_target} spheres settled {settle} steps "
              f"on the card, then {steps} steps card vs the port on the "
              f"CPU in {str(dtype)[6:]}: {', '.join(out)}; iterations card "
              f"{card[1]}, CPU {cpu[1]}; contacts card {card[2]}, CPU "
              f"{cpu[2]}")


def drop_scene(device, mu=0.5, n_spheres=4, mu_roll=0.0, mu_spin=0.0):
    """``tests/test_contact.py:124`` ``drop_scene``: spheres dropped in a
    box on the ground, through the port's builder."""
    b = SystemBuilder(device=device)
    g = b.add_ground()
    ids = [b.add_body(mass=1.0, inertia=(0.4 * 0.5**2,) * 3,
                      pos=(0.1 * k, 0.07 * k, 1.0 + 1.2 * k))
           for k in range(n_spheres)]
    model, state = b.finalize()
    dev = state.x.device

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    spheres = SphereShapes(body=t(ids, torch.int32),
                           offset=t(np.zeros((n_spheres, 3))),
                           radius=t(np.full(n_spheres, 0.5)),
                           mu=t(np.full(n_spheres, mu)))
    boxes = BoxShapes(body=t([g], torch.int32), pos=t([[0.0, 0.0, -0.5]]),
                      rot=t([[1.0, 0, 0, 0]]), half=t([[10.0, 10.0, 0.5]]),
                      mu=t([mu]))
    coll = CollisionModel(
        spheres=spheres, boxes=boxes,
        grid=GridSpec(origin=(-12.0, -12.0, -2.0), cell_size=1.2,
                      dims=(20, 20, 8)),
        max_per_cell=8, max_contacts=64, mu_roll=mu_roll, mu_spin=mu_spin)
    return model, coll, state


def drop_run(device, solver, steps, **scene):
    """``steps`` steps of 5 ms of ``drop_scene`` with the spheres lowered
    into touch (the lowest 1 mm into the floor, each other 1 cm into the
    one below, as ``tests/test_torch_contact.py`` stacks them) and random
    speeds (seed 60)."""
    model, coll, state = drop_scene(device, **scene)
    x = state.x.clone()
    x[1:, 2] = torch.tensor(0.499 + 0.99 * np.arange(4), dtype=x.dtype)
    rng = np.random.default_rng(60)
    v = torch.tensor(rng.normal(size=(5, 3)) * 0.2, dtype=x.dtype)
    w = torch.tensor(rng.normal(size=(5, 3)), dtype=x.dtype)
    v[0], w[0] = 0.0, 0.0
    state = state.replace(x=x, v=v.to(x.device), w=w.to(x.device))
    settings = SolverSettings(solver=solver, max_iter=80, tol=1e-7,
                              stab_factor=0.2)
    t = torch.zeros((), device=state.x.device)
    iters = []
    for _ in range(steps):
        state, contacts, info = nsc_step(model, coll, state, t, 5e-3,
                                         settings)
        t = t + 5e-3
        iters.append(int(info.iterations))
    return state, iters, int(contacts.count)


def every_solver_on_the_card(steps=10):
    """``nsc_step`` on ``drop_scene(n_spheres=4)``, its spheres stacked in
    touch, with every VI solver and the direct solver's APGD fallback, and
    with rolling friction: 10 steps of 5 ms on the card and through the
    port on the CPU."""
    cases = [(s, {}) for s in ("apgd", "bb", "pjacobi", "admm", "direct")]
    cases.append(("apgd", {"mu_roll": 0.01, "mu_spin": 0.005}))
    for solver, scene in cases:
        card_st, card_it, nc = drop_run(DEV, solver, steps, **scene)
        cpu_st, cpu_it, _ = drop_run("cpu", solver, steps, **scene)
        require(all(bool(torch.isfinite(getattr(card_st, f)).all())
                    for f in "xqvw"), f"drop scene, {solver}: not finite")
        err = float((card_st.x.cpu() - cpu_st.x).abs().max())
        require(err <= 1e-3, f"drop scene, {solver}{scene}: card vs CPU "
                f"max |Δx| {err}")
        z = card_st.x[1:, 2].cpu().numpy()
        print(f"drop scene ({solver}{', rolling' if scene else ''}), "
              f"{steps} steps: {nc} contacts at the end, sphere heights "
              f"{np.array2string(z, precision=4)}, card vs the port on the "
              f"CPU max |Δx| {err:.3e}, iterations a step card "
              f"{np.mean(card_it):.1f}, CPU {np.mean(cpu_it):.1f}")


def krylov_through_simulate(steps=30):
    """``bench_mbs`` through ``simulate`` with CG, MINRES and GMRES (an
    eager loop on the card: their loop tests are host reads; GMRES is
    ~190–270 ms a step, so the run was cut from 100 steps to 30 when
    phase 18 came)."""
    for solver in ("cg", "minres", "gmres"):
        model, state = mbs_bench_scene(DEV)
        settings = SolverSettings(solver=solver, max_iter=60, tol=1e-6)
        tvi.reset_host_reads()
        (final, _), wall = mbs_timed(lambda: simulate(
            model, state, MBS_H, steps, settings, save_every=0))
        reads = tvi.host_reads() / steps
        viol = mbs_violation(model, final)
        require(all(bool(torch.isfinite(getattr(final, f)).all())
                    for f in "xqvw") and viol < MBS_VIOLATION,
                f"bench_mbs with {solver}: joint violation {viol}")
        print(f"bench_mbs through simulate with {solver}, {steps} steps: "
              f"{wall / steps * 1e3:.3f} ms a step (eager), {reads:.1f} "
              f"host reads a step, joint violation {viol:.3e}")


def smc_scene(device):
    """Four stacks of three spheres (r = 0.1 m, 1 kg; each on the one below
    by 1 mm, the lowest on a ground box), Hertz contact with one-step
    tangential friction (μ 0.4)."""
    bld = SystemBuilder(device=device)
    g = bld.add_ground()
    ids = [bld.add_body(mass=1.0, inertia=(0.004,) * 3,
                        pos=(0.21 * i, 0.21 * j, 0.0995 + 0.1995 * k))
           for i in range(2) for j in range(2) for k in range(3)]
    model, state = bld.finalize()
    dev = state.x.device
    n = len(ids)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    coll = CollisionModel(
        spheres=SphereShapes(body=t(ids, torch.int32),
                             offset=t(np.zeros((n, 3))),
                             radius=t(np.full(n, 0.1)),
                             mu=t(np.full(n, 0.4))),
        boxes=BoxShapes(body=t([g], torch.int32), pos=t([[0.0, 0.0, -0.5]]),
                        rot=t([[1.0, 0, 0, 0]]), half=t([[5.0, 5.0, 0.5]]),
                        mu=t([0.4])),
        grid=GridSpec(origin=(-1.0, -1.0, -1.0), cell_size=0.25,
                      dims=(8, 8, 12)),
        max_per_cell=8, max_contacts=128)
    return model, coll, state


def smc_on_the_card(steps=500, h=1e-4):
    params = SMCParams(youngs=1e7, poisson=0.3, restitution=0.5)
    out = {}
    for where in (DEV, "cpu"):
        model, coll, state = smc_scene(where)
        t = torch.zeros((), device=state.x.device)
        for _ in range(steps):
            state, contacts, _ = smc_step(model, coll, state, t, h, params)
            t = t + h
        out[str(where)] = (state, int(contacts.count))
    (card_st, nc), (cpu_st, _) = out[str(DEV)], out["cpu"]
    require(all(bool(torch.isfinite(getattr(card_st, f)).all())
                for f in "xqvw"), "SMC scene: not finite")
    err = float((card_st.x.cpu() - cpu_st.x).abs().max())
    require(err <= 1e-4, f"SMC scene, card vs CPU: max |Δx| {err}")
    print(f"smc_step, 12 stacked spheres on a floor, {steps} steps of "
          f"{h} s: {nc} contacts, lowest sphere at z = "
          f"{float(card_st.x[1:, 2].min()):.5f}, card vs the port on the "
          f"CPU max |Δx| {err:.3e}")


# ---------------------------------------------------------------- phase 13


# the North star's state tolerances (tests/test_pallas_kernel.py:261-266):
# positions rtol 1e-4 / atol 1e-5, velocities rtol 1e-3 / atol 1e-4
NS_X_TOL = dict(rtol=1e-4, atol=1e-5)
NS_V_TOL = dict(rtol=1e-3, atol=1e-4)
# the persistent advance against the per-outer step: at rebuild_outer 1 the
# bodies at tests/test_crm_terrain.py:234-239 (x rtol 1e-5 / atol 1e-6, v
# rtol 1e-4 / atol 1e-5), at rebuild_outer 3 with dv "last" |Δx| < 2e-3
# (:252-253)
FSI_X_TOL = dict(rtol=1e-5, atol=1e-6)
FSI_V_TOL = dict(rtol=1e-4, atol=1e-5)
FSI_STALE_DX = 2e-3
# the vehicle's velocities over tens of outer steps (card against CPU,
# or one engine against the other): the 17-body step's float32 solve alone
# moves ω by ~5e-4 rad/s and v by ~4e-5 m/s in 10–40 steps of 4e-4 s (the
# port's step on the CPU in float32 against float64, the vehicle falling
# freely: ω 5.1e-4 / 5.5e-4, v 3.7e-5 / 4.2e-5 after 10 / 40 steps), and
# the terrain's reaction summed in another order adds to it: ω held at ten
# times its floor, v at 1e-3 m/s (the lane's two engines differ by
# 3.8e-4 after 40 outer steps); positions stay at the North star's
VEHICLE_W_TOL = dict(rtol=1e-3, atol=5e-3)
VEHICLE_V_TOL = dict(rtol=1e-3, atol=1e-3)
# bench_suite.py:589-612 bench_crm: 6 intervals of 40 outer steps,
# capacity 32, rebuild_outer 5 (demos/demo_vehicle_crm.py:143-172)
CRM_VEHICLE_INTERVALS = 6
CRM_VEHICLE_OUTER = 40
CRM_VEHICLE_REBUILD = 5
CRM_VEHICLE_C = 32
# outer steps of the first interval held to the port's CPU run (the twins
# take ~3 s an outer step on the demo bed on 8 CPU cores: 40 take ~120 s)
CRM_VEHICLE_CPU_OUTER = 10
# intervals past bench_crm's 6 with the drive on (it starts at 0.15 s,
# after the bench's 0.096 s), up to the demo's own 25 (0.4 s): the
# vehicle rolls back ~1 cm while it settles, then the drive turns it
CRM_VEHICLE_DRIVEN = 19
# the demo's wheel and its start (demos/demo_vehicle_crm.py:86-89)
R_WHEEL, W_WHEEL, SINK0 = 0.16, 0.12, 0.02
EPS32 = float(np.finfo(np.float32).eps)


def as_float32(params, soil):
    """``params`` and ``soil`` with every float rounded to float32, as the
    JAX package holds them (its scenes read d0 back as float32(d0), which
    moves the bed's marker lattice)."""
    def f32(v):
        return float(np.float32(v))

    params = params.replace(**{k: f32(getattr(params, k)) for k in (
        "d0", "h", "rho0", "mu", "c_s", "dt", "eos_gamma", "alpha_visc",
        "delta_sph", "xsph_eps")},
        gravity=tuple(f32(g) for g in params.gravity))
    soil = soil.replace(**{k: f32(getattr(soil, k)) for k in (
        "youngs", "poisson", "friction_angle", "cohesion")})
    return params, soil


def crm_wheel_scene(device=None):
    """The single-wheel mini bed of tests/test_crm_terrain.py:171-205: a
    0.45 × 0.24 × 0.12 m bed at d0 = 0.03 (E = 2e6, ν = 0.3, tan φ = 0.7,
    no cohesion, α = 0.1, 96 neighbours and 64 markers a cell on the
    gather backend), a 10 kg wheel of r = 0.08, w = 0.09 pre-sunk by
    2 cm in a carved crater, a 3 N·m torque about y, on ``device`` (the
    card by default).  The drive records the bodies it is called with
    (``seen``), as :func:`crm_vehicle_scene`'s does."""
    dev = torch.device(device or DEV)
    params, soil = as_float32(
        SPHParams(d0=0.03, h=1.2 * 0.03, rho0=1700.0, mu=0.0, c_s=40.0,
                  gravity=(0.0, 0.0, -G), dt=1e-4, alpha_visc=0.1,
                  max_neighbors=96, max_per_cell=64, rebuild_every=4),
        CRMParams(youngs=2e6, poisson=0.3, friction_angle=0.7,
                  cohesion=0.0))
    d0 = params.d0
    bed, depth, r_wheel, w_wheel, sink0 = (0.45, 0.24), 0.12, 0.08, 0.09, 0.02
    local = wheel_bce_markers(r_wheel, w_wheel, d0)
    x0 = np.array([0.18, bed[1] / 2, depth + r_wheel + 0.5 * d0 - sink0])

    def carve(pts):
        dxz = pts[:, [0, 2]] - x0[[0, 2]]
        in_r = np.linalg.norm(dxz, axis=1) < (r_wheel + d0)
        in_y = np.abs(pts[:, 1] - x0[1]) < (w_wheel / 2 + d0)
        return ~(in_r & in_y)

    bld = SystemBuilder(device=dev)
    bld.set_gravity((0, 0, -G))
    wheel = bld.add_body(mass=10.0, inertia=(0.05, 0.08, 0.05), pos=x0)
    model, bodies = bld.finalize()
    terrain, grid = make_crm_terrain_state(
        params, soil, bed, depth, rigid_pts=local + x0,
        rigid_body_ids=[wheel] * len(local), rigid_local=local,
        carve_fn=carve, device=dev)
    f0 = torch.zeros((model.n_bodies, 3), device=dev)
    tau = torch.zeros((model.n_bodies, 3), device=dev)
    tau[wheel, 1] = 3.0
    seen = {}

    def drive(t, b):
        seen["bodies"] = b
        return f0, tau

    return dict(params=params, soil=soil, grid=grid, model=model,
                state=CRMFSIState(bodies=bodies, terrain=terrain,
                                  time=torch.zeros((), device=dev)),
                wheels=[wheel], drive=drive, seen=seen, n_rigid=len(local))


def crm_vehicle(bld, pos0, wheelbase=1.2, track=0.7, chassis_mass=60.0):
    """``demos/demo_vehicle_crm.py:42-66`` ``build_vehicle`` on the port's
    builder: a 60 kg chassis and four double-wishbone corners of
    ``vehicle.suspension``.  Returns (chassis, corners by name)."""
    chassis = bld.add_body(mass=chassis_mass, inertia=(20.0, 40.0, 50.0),
                           pos=pos0)
    hp = WishboneHardpoints(
        spindle=(0.0, 0.0, 0.0),
        uca_front=(0.10, -0.28, 0.16), uca_rear=(-0.10, -0.28, 0.16),
        uca_ball=(0.0, -0.06, 0.18),
        lca_front=(0.12, -0.30, -0.10), lca_rear=(-0.12, -0.30, -0.10),
        lca_ball=(0.0, -0.04, -0.12),
        spring_chassis=(0.0, -0.22, 0.30), spring_lca=(0.0, -0.12, -0.10),
        tierod_chassis=(0.15, -0.28, 0.0), tierod_upright=(0.14, -0.06, 0.0),
        masses=dict(uca=1.5, lca=2.0, upright=4.0, wheel=8.0),
        inertias=dict(uca=(0.01, 0.01, 0.02), lca=(0.01, 0.01, 0.02),
                      upright=(0.05, 0.05, 0.05), wheel=(0.10, 0.16, 0.10)),
        spring_k=120e3, spring_c=6e3)
    corners = {}
    for name, dx, side in (("FL", +wheelbase / 2, +1),
                           ("FR", +wheelbase / 2, -1),
                           ("RL", -wheelbase / 2, +1),
                           ("RR", -wheelbase / 2, -1)):
        origin = np.asarray(pos0) + np.array([dx, side * track / 2, -0.15])
        corners[name] = add_double_wishbone_corner(bld, chassis, origin, hp,
                                                   side=side)
    return chassis, corners


def crm_vehicle_scene(size=(2.0, 1.2), depth=0.15, d0=0.05, margin=3.5,
                      device=None):
    """Config #5 as ``bench_crm`` builds it (demos/demo_vehicle_crm.py:
    69-186): the demo's loam at ``d0``, a ``size`` bed ``depth`` deep, the
    vehicle of :func:`crm_vehicle` at x = 0.6 m, mid-bed, its wheels 2 cm
    into carved craters, each wheel's BCE cylinder of r = 0.16 m and w =
    0.12 m, air 12 d0, ``margin`` (3.5 d0: the demo's flat2 layout), and
    a 14 N·m drive torque on every wheel after 0.15 s.  The drive
    records the bodies it is called with (``seen``): the state the
    last outer step moved the wheels' markers to."""
    dev = torch.device(device or DEV)
    params, soil = as_float32(*crm_soil(d0))
    d0 = params.d0
    z_chassis = depth + R_WHEEL + 0.5 * d0 - SINK0 + 0.15
    pos0 = (0.6, size[1] / 2, z_chassis)
    bld = SystemBuilder(device=dev)
    bld.set_gravity((0, 0, -G))
    chassis, corners = crm_vehicle(bld, pos0)
    model, bodies = bld.finalize()
    wheels = [corners[k].wheel for k in ("FL", "FR", "RL", "RR")]
    local = wheel_bce_markers(R_WHEEL, W_WHEEL, d0)
    wheel_pos = bodies.x[wheels].cpu().numpy()
    rigid_pts = np.concatenate([local + xw for xw in wheel_pos])
    rigid_ids = np.repeat(wheels, len(local))

    def carve(pts):
        keep = np.ones(len(pts), bool)
        for xw in wheel_pos:
            dxz = pts[:, [0, 2]] - xw[[0, 2]]
            in_r = np.linalg.norm(dxz, axis=1) < (R_WHEEL + d0)
            in_y = np.abs(pts[:, 1] - xw[1]) < (W_WHEEL / 2 + d0)
            keep &= ~(in_r & in_y)
        return keep

    terrain, grid = make_crm_terrain_state(
        params, soil, size, depth, rigid_pts=rigid_pts,
        rigid_body_ids=rigid_ids, rigid_local=np.tile(local, (4, 1)),
        carve_fn=carve, air=12.0, margin=margin, device=dev)
    on_wheels = torch.zeros((model.n_bodies, 3), device=dev)
    on_wheels[wheels, 1] = 1.0
    seen = {}

    def drive(t, b):
        seen["bodies"] = b
        return None, on_wheels * torch.where(t > 0.15, 14.0, 0.0)

    return dict(params=params, soil=soil, grid=grid, model=model,
                state=CRMFSIState(bodies=bodies, terrain=terrain,
                                  time=torch.zeros((), device=dev)),
                wheels=wheels, drive=drive, seen=seen, chassis=chassis,
                corners=corners, n_rigid=len(rigid_ids), depth=depth, d0=d0,
                size=size)


def crm_launches():
    return {"crm_momentum": crm.crm_momentum.launches,
            "crm_gradv_stress": crm.crm_gradv_stress.launches,
            "crm_outer": crm.crm_outer_substeps.launches}


def crm_reset_launches():
    crm.crm_momentum.launches = crm.crm_gradv_stress.launches = 0
    crm.crm_outer_substeps.launches = 0


def fsi_persistent(sc, dev, rebuild_outer, dv_mode, whole_outer,
                   n_sub=None, C=CRM_VEHICLE_C):
    """``make_crm_fsi_advance_persistent`` of scene ``sc`` on ``dev``."""
    return make_crm_fsi_advance_persistent(
        sc["model"], sc["params"], sc["soil"], sc["grid"],
        n_substeps=n_sub or sc["params"].rebuild_every,
        wheel_bodies=sc["wheels"], f_ext_fn=sc["drive"], pencil_capacity=C,
        rebuild_outer=rebuild_outer, dv_mode=dv_mode,
        whole_outer=whole_outer, device=dev)


def fsi_per_outer(sc, dev, n_outer, n_sub):
    """``n_outer`` calls of ``crm_fsi_step`` on the pencil engine."""
    subs = make_crm_substeps_pencil(sc["params"], sc["soil"], sc["grid"],
                                    32, device=dev)
    st = sc["state"]
    for _ in range(n_outer):
        st, ov, _ = crm_fsi_step(sc["model"], sc["params"], sc["soil"],
                                 sc["grid"], st, n_sub, sc["wheels"],
                                 f_ext_fn=sc["drive"], substeps_fn=subs)
        require(int(ov) == 0, f"per-outer step: overflow {int(ov)}")
    return st


def fsi_active_spec(sc):
    """An active box around the wheel (half-extents 0.12 × 0.2 × 0.3 m, a
    0.08 m margin) whose buffer holds every extended-active marker with 64
    to spare, and the (N,) mask of the markers outside it."""
    box, margin = torch.tensor([0.12, 0.2, 0.3]), torch.tensor([0.08] * 3)
    t, b = sc["state"].terrain, sc["state"].bodies
    d = (t.pos - b.x[sc["wheels"][0]]).abs().cpu()
    ext = (d <= box + margin).all(1) | (t.kind == RIGID_BCE).cpu()
    return (ActiveDomainSpec(box=box, margin=margin,
                             capacity=int(ext.sum()) + 64), ~ext)


def fsi_advance_fn(sc, dev, n_outer, n_sub, active):
    """``make_crm_fsi_advance_fn`` on the pencil engine, with or without
    the active box of :func:`fsi_active_spec`."""
    spec = fsi_active_spec(sc)[0] if active else None
    st, ov = make_crm_fsi_advance_fn(
        sc["model"], sc["params"], sc["soil"], sc["grid"], n_sub,
        sc["wheels"], active=spec, f_ext_fn=sc["drive"], engine="pencil",
        pencil_capacity=32, device=dev)(sc["state"], n_outer)
    require(int(ov) == 0, f"advance_fn (active {active}): overflow")
    return st


def fsi_close(got, ref, what, x_tol=NS_X_TOL, v_tol=NS_V_TOL, terrain=True,
              long_run=False):
    """Bodies (x, q at the x tolerance; v, ω at the v tolerance) and, with
    ``terrain``, the terrain's x and v, ``got`` against ``ref`` (either
    device).  With ``long_run`` (the vehicle over tens of outer steps) the
    bodies' v and ω are held at ``VEHICLE_V_TOL`` and ``VEHICLE_W_TOL``
    and the terrain's v as phase 5 holds 3 cycles (rtol 1e-4, atol
    1e-3·max|v|: the edge markers kicked to ~3 m/s carry the sum-order
    differences).  Returns the largest error over its tolerance."""
    pairs = [(got.bodies.x, ref.bodies.x, x_tol, "bodies x"),
             (got.bodies.q, ref.bodies.q, x_tol, "bodies q"),
             (got.bodies.v, ref.bodies.v,
              VEHICLE_V_TOL if long_run else v_tol, "bodies v"),
             (got.bodies.w, ref.bodies.w,
              VEHICLE_W_TOL if long_run else v_tol, "bodies w")]
    if terrain:
        v_ref = ref.terrain.vel.cpu()
        tv = (dict(rtol=1e-4, atol=1e-3 * float(v_ref.abs().max()))
              if long_run else v_tol)
        pairs += [(got.terrain.pos, ref.terrain.pos, x_tol, "terrain x"),
                  (got.terrain.vel, v_ref, tv, "terrain v")]
    return max(check_close(g.cpu(), r.cpu(), what=f"{what} {w}", **tol)[1]
               for g, r, tol, w in pairs)


def fsi_equal(a, b):
    """Every field of two CRMFSIStates equal bit for bit."""
    fields = [(a.bodies, b.bodies, "xqvw"),
              (a.terrain, b.terrain, ("pos", "vel", "rho", "tau_d",
                                      "tau_o"))]
    return all(torch.equal(getattr(x, f), getattr(y, f))
               for x, y, names in fields for f in names) \
        and torch.equal(a.time, b.time)


def fsi_rigid_acc(sc):
    """On the scene's first binning (the wheels' markers moved to their
    bodies): sweep M's acceleration of the rigid markers against its twin
    on the same inputs, and the persistent path's reduction twice on the
    card (bit for bit) and against the CPU's.  Returns (acc errors, force
    and torque errors over their tolerance)."""
    out = {}
    for dev in (DEV, torch.device("cpu")):
        s = sc if dev == DEV else crm_wheel_scene("cpu")
        terrain, bodies = s["state"].terrain, s["state"].bodies
        pos, vel = fsi_bce.update_rigid_markers(
            terrain.pos, terrain.vel, terrain.kind, terrain.body_id,
            terrain.bce_local, bodies.x, bodies.q, bodies.v, bodies.w)
        terrain = terrain.replace(pos=pos, vel=vel)
        eng = make_crm_engine(s["params"], s["soil"], s["grid"], 32,
                              device=dev)
        feat, _, cells, ovf, aux = eng["bin"](terrain, bce_extras(terrain))
        require(int(ovf) == 0, "the wheel bed overflows its cells")
        is_wheel = torch.ones(bodies.n, dtype=torch.bool, device=dev)
        rs = rigid_slots(aux, is_wheel, s["n_rigid"])
        acc = eng["forces"](feat, cells)
        red = [fsi_body_forces(s["params"], feat, acc, rs, bodies)
               for _ in range(2)]
        out[dev.type] = (feat, cells, eng["consts"], acc, rs, red)
    feat, cells, c, acc, rs, red = out[DEV.type]
    _, twin = crm.crm_momentum_plain(feat, cells, c, with_acc=True)
    errs = {"acc on rigid markers": crm_scaled_close(
        acc[:, rs.slots], twin[:, rs.slots], 1e-4, 5e-5,
        "M's acceleration on the rigid markers")}
    (f1, t1), (f2, t2) = red
    require(torch.equal(f1, f2) and torch.equal(t1, t2),
            "the reduction differs between two calls on the card")
    fc, tc = out["cpu"][5][0]
    worst = 0.0
    for got, ref, what in ((f1, fc, "force"), (t1, tc, "torque")):
        require(float(ref.abs().max()) > 0, f"no {what} on the wheel")
        worst = max(worst, crm_scaled_close(got.cpu(), ref, 1e-4, 1e-4,
                                            f"reduction {what}")[1])
    return errs, worst, f1[sc["wheels"][0]].cpu().tolist()


def fsi_wheel_parity():
    """Phase 13 (a): the single-wheel mini bed, 4 outer steps of 2
    substeps, on the card against the port on the CPU."""
    sc, cpu = crm_wheel_scene(), crm_wheel_scene("cpu")
    n_sub, n_outer = 2, 4
    errs, red_ratio, f_wheel = fsi_rigid_acc(sc)
    print(f"wheel bed ({sc['state'].terrain.n} markers, {sc['n_rigid']} on "
          f"the wheel): {format_errs({'crm_momentum': errs})}; the "
          f"reduction twice on the card bit for bit, against the CPU "
          f"{red_ratio:.3f} of its tolerance (force {f_wheel} N)")
    runs = {"per-outer": lambda s, d: fsi_per_outer(s, d, n_outer, n_sub),
            "advance_fn": lambda s, d: fsi_advance_fn(s, d, n_outer, n_sub,
                                                      False),
            "advance_fn, active": lambda s, d: fsi_advance_fn(
                s, d, n_outer, n_sub, True)}
    for ro, dv, whole in ((1, "fresh", False), (1, "last", True),
                          (3, "last", False), (3, "last", True)):
        def run(s, d, ro=ro, dv=dv, whole=whole):
            st, ov = fsi_persistent(s, d, ro, dv, whole, n_sub)(
                s["state"], n_outer)
            require(int(ov) == 0, f"persistent {ro} {dv} {whole}: overflow")
            return st
        runs[(ro, dv, whole)] = run
    card = {k: f(sc, DEV) for k, f in runs.items()}
    # on the CPU the whole-outer twin is the per-sweep twins in "last"
    cpu_ref = {k: runs[k](cpu, torch.device("cpu")) for k in (
        "per-outer", "advance_fn", "advance_fn, active",
        (1, "fresh", False), (3, "last", False))}
    cpu_ref[(1, "last", False)] = fsi_persistent(
        cpu, torch.device("cpu"), 1, "last", False, n_sub)(cpu["state"],
                                                           n_outer)[0]
    lines = []
    for k, st in card.items():
        ref_key = (k[0], k[1], False) if isinstance(k, tuple) else k
        r = fsi_close(st, cpu_ref[ref_key], f"{k} card vs CPU")
        lines.append(f"{k}: {r:.3f}")
    print("wheel bed, 4 outer steps x 2 substeps, card vs the port on the "
          "CPU (largest error over the North star's tolerance): "
          + "; ".join(lines))
    base = card["per-outer"]
    far = fsi_active_spec(sc)[1].to(DEV)
    act = card["advance_fn, active"].terrain
    require(torch.equal(act.pos[far], sc["state"].terrain.pos[far])
            and torch.equal(act.vel[far], sc["state"].terrain.vel[far]),
            "the active-domain advance moved a marker outside its box")
    r_fn = fsi_close(card["advance_fn"], base, "advance_fn vs per-outer")
    r1 = fsi_close(card[(1, "fresh", False)], base,
                   "rebuild 1 vs per-outer", FSI_X_TOL, FSI_V_TOL, False)
    dx = float((card[(3, "last", False)].bodies.x
                - base.bodies.x).abs().max())
    require(dx < FSI_STALE_DX, f"rebuild 3 vs per-outer: |dx| {dx}")
    r_outer = fsi_close(card[(3, "last", True)], card[(3, "last", False)],
                        "crm_outer vs per-sweep")
    again = {k: runs[k](sc, DEV) for k in ((1, "fresh", False),
                                           (3, "last", True))}
    require(all(fsi_equal(again[k], card[k]) for k in again),
            "wheel bed: two runs on the card differ")
    print(f"wheel bed on the card: make_crm_fsi_advance_fn (the graph "
          f"replay of the multibody step) vs the per-outer steps (eager) "
          f"{r_fn:.3f} of the North star's tolerance; with the active box "
          f"{int(far.sum())} markers outside it unmoved bit for bit; "
          f"persistent at rebuild 1 vs per-outer "
          f"{r1:.3f} of tests/test_crm_terrain.py:234-239's tolerance; at "
          f"rebuild 3, dv last |dx| {dx:.3e} (< {FSI_STALE_DX}); crm_outer "
          f"vs per-sweep {r_outer:.3f} of the North star's; two runs bit "
          f"for bit")


def vehicle_line(sc, st, ovf):
    """The demo's interval line (demos/demo_vehicle_crm.py:196-205)."""
    ch, rl = sc["chassis"], sc["corners"]["RL"].wheel
    xc, vx = float(st.bodies.x[ch, 0]), float(st.bodies.v[ch, 0])
    wr = float(st.bodies.w[rl, 1])
    slip = 1.0 - vx / max(wr * R_WHEEL, 1e-6) if wr > 0.1 else 0.0
    zw = float(st.bodies.x[sc["wheels"], 2].mean())
    z0 = sc["depth"] + R_WHEEL + 0.5 * sc["d0"] - SINK0
    rut = (z0 - zw) * 1000 + SINK0 * 1000
    return (f"t={float(st.time):5.3f}s ovf={ovf} x={xc:.4f} v={vx:6.3f} m/s "
            f"rut={rut:5.2f} mm slip={slip:5.2f} ω_RL={wr:6.3f}"), rut


def vehicle_check(sc, st, what):
    """Finite; walls unmoved bit for bit; every rigid marker at x_b + R ξ
    of the bodies its last outer step moved it to (float32 rounding: 4 eps
    of the largest coordinate); every granular stress inside the cone;
    joint violation < 1e-3.  Returns (rigid error, share on the cone,
    violation)."""
    t0, t = sc["state"].terrain, st.terrain
    require(all(bool(torch.isfinite(a).all()) for a in
                (t.pos, t.vel, t.rho, t.tau_d, t.tau_o, st.bodies.x,
                 st.bodies.q, st.bodies.v, st.bodies.w)),
            f"{what}: non-finite state")
    walls = t0.kind == BOUNDARY
    require(torch.equal(t.pos[walls], t0.pos[walls])
            and torch.equal(t.vel[walls], t0.vel[walls]),
            f"{what}: a wall marker moved")
    b = sc["seen"]["bodies"]
    want, _ = fsi_bce.update_rigid_markers(
        t.pos, t.vel, t.kind, t.body_id, t.bce_local, b.x, b.q, b.v, b.w)
    rig = t.kind == RIGID_BCE
    rigid_err = float((t.pos[rig] - want[rig]).abs().max())
    scale = float(t.pos[rig].abs().max())
    require(rigid_err <= 4 * EPS32 * scale,
            f"{what}: a rigid marker is {rigid_err} m off x_b + R xi")
    gran = t.kind == FLUID
    excess, on_cone = dp_cone_excess(t.tau_d[gran], t.tau_o[gran],
                                     sc["soil"])
    require(float(excess.max()) <= 0.0,
            f"{what}: {int((excess > 0).sum())} granular stresses outside "
            "the Drucker-Prager cone")
    viol = mbs_violation(sc["model"], st.bodies)
    require(viol < MBS_VIOLATION, f"{what}: joint violation {viol}")
    return rigid_err, on_cone, viol


def vehicle_run(sc, adv, n_intervals, what, state=None, quiet=False):
    """``n_intervals`` of ``CRM_VEHICLE_OUTER`` outer steps, each checked
    for overflow and printed as the demo prints it.  Returns (states,
    wall seconds) by interval."""
    st = sc["state"] if state is None else state
    states, walls = [], []
    for _ in range(n_intervals):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ovf = adv(st, CRM_VEHICLE_OUTER)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ovf = int(ovf)
        require(ovf == 0, f"{what}: overflow {ovf}")
        states.append(st)
        if not quiet:
            print(f"  {what}: {vehicle_line(sc, st, ovf)[0]}")
    return states, walls


def vehicle_profile(sc, adv, st, what):
    """One chunk of ``CRM_VEHICLE_REBUILD`` outer steps (one binning)
    under the profiler, and the multibody step alone (the graph replay
    and the eager step): ms and kernels an outer step, and the
    multibody step's share."""
    n = CRM_VEHICLE_REBUILD
    wall, events = device_events(lambda: adv(st, n))
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    mbs = MBSStep(sc["model"], sc["params"].dt * sc["params"].rebuild_every,
                  SolverSettings(solver="direct"))
    b, t = st.bodies, st.time
    f = torch.zeros_like(b.x)
    mbs(b, t, f, f)
    _, m_events = device_events(lambda: mbs(b, t, f, f))
    m_busy = sum(e.time_range.elapsed_us() for e in m_events) / 1e3
    _, e_events = device_events(lambda: mbs.eager(b, t, f, f))
    out = dict(wall_ms=wall * 1e3 / n, device_ms=busy / n,
               kernels=len(events) / n, mbs_kernels=len(m_events),
               mbs_device_ms=m_busy, mbs_eager_kernels=len(e_events))
    print(f"{what}, one profiled chunk of {n} outer steps: "
          f"{out['wall_ms']:.4f} ms and {out['kernels']:.1f} kernels an "
          f"outer step ({out['device_ms']:.4f} ms of device time, idle "
          f"{1 - busy / (wall * 1e3):.4f} with the profiler on); the "
          f"multibody step (graph replay) {len(m_events)} kernels, "
          f"{m_busy:.4f} ms of device time = "
          f"{m_busy / out['device_ms']:.4f} of an outer step's device time "
          f"and {len(m_events) / out['kernels']:.4f} of its kernels (eager "
          f"step {len(e_events)} kernels)")
    return out


def vehicle_engines(card, sc, n_intervals, what, cpu_first=None,
                    extra=0):
    """Config #5's vehicle on ``sc`` through the persistent advance with
    ``whole_outer`` on, then off with dv "last": each engine for
    ``n_intervals`` intervals (checked at each; the first is the warm-up
    the RTF leaves out), a profiled chunk, a second run of the first
    interval bit for bit; the two engines held to each other after the
    first interval (``fsi_close`` with ``long_run``) and their bodies
    within 2e-3 after the last; with ``cpu_first``, the first
    ``CRM_VEHICLE_CPU_OUTER`` outer steps of each against the port's CPU
    run; ``extra`` more intervals on the first engine with the drive on
    (the chassis must turn forward).  Returns (launches by kernel,
    results by engine)."""
    sim = CRM_VEHICLE_OUTER * sc["params"].dt * sc["params"].rebuild_every
    launches, res = {}, {}
    for whole in (True, False):
        name = "whole_outer" if whole else "per-sweep, dv last"
        adv = fsi_persistent(sc, DEV, CRM_VEHICLE_REBUILD, "last", whole)
        crm_reset_launches()
        states, walls = vehicle_run(sc, adv, n_intervals, f"{what}, {name}")
        got = crm_launches()
        n_out = n_intervals * CRM_VEHICLE_OUTER
        sub = n_out * sc["params"].rebuild_every
        want = ({"crm_momentum": 0, "crm_gradv_stress": 0,
                 "crm_outer": n_out} if whole else
                {"crm_momentum": sub, "crm_gradv_stress": sub,
                 "crm_outer": 0})
        require(got == want, f"{what}, {name}: launch counts {got}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        rigid, on_cone, viol = vehicle_check(sc, states[-1],
                                             f"{what}, {name}")
        rtf = sum(walls[1:]) / (sim * (n_intervals - 1))
        ms = sum(walls[1:]) / ((n_intervals - 1) * CRM_VEHICLE_OUTER) * 1e3
        _, rut = vehicle_line(sc, states[-1], 0)
        require(rut < R_WHEEL * 1000, f"{what}: rut {rut} mm")
        print(f"{what}, {name}: steady-state RTF = {rtf:.4f} ({ms:.4f} ms "
              f"an outer step; first interval {walls[0]:.3f} s left out) on "
              f"{card}; launches {got}; finite, walls unmoved, rigid markers "
              f"at x_b + R xi within {rigid:.3e} m, every granular stress "
              f"inside the cone ({on_cone:.4f} on it), joint violation "
              f"{viol:.3e}, rut {rut:.2f} mm (< {R_WHEEL * 1000:.0f})")
        again, _ = vehicle_run(sc, adv, 1, f"{what}, {name}, again",
                               quiet=True)
        require(fsi_equal(again[0], states[0]),
                f"{what}, {name}: two runs differ")
        prof = vehicle_profile(sc, adv, states[-1], f"{what}, {name}")
        res[name] = dict(states=states, rtf=rtf, ms=ms, prof=prof,
                         adv=adv)
        if what == "config #5" and whole:
            RATES["config5_rtf"] = rtf
    a, b = (res[k]["states"] for k in res)
    r_eng = fsi_close(a[0], b[0], f"{what}: whole_outer vs per-sweep",
                      long_run=True)
    v_err = float((a[0].bodies.v - b[0].bodies.v).abs().max())
    dx = float((a[-1].bodies.x - b[-1].bodies.x).abs().max())
    require(dx < FSI_STALE_DX,
            f"{what}: whole_outer vs per-sweep, bodies |dx| {dx}")
    print(f"{what}: whole_outer vs per-sweep after the first interval "
          f"{r_eng:.3f} of the tolerance (as against the CPU; bodies' max "
          f"|Δv| {v_err:.3e} m/s), after {n_intervals} "
          f"intervals bodies |dx| {dx:.3e} (< {FSI_STALE_DX}); bit for bit "
          f"on a second run of the first interval, both engines")
    if cpu_first is not None:
        for name, r in res.items():
            got, ovf = r["adv"](sc["state"], CRM_VEHICLE_CPU_OUTER)
            require(int(ovf) == 0, f"{what}, {name}: overflow")
            ratio = fsi_close(got, cpu_first,
                              f"{what}, {name}, first interval vs CPU",
                              long_run=True)
            w_err = float((got.bodies.w.cpu() - cpu_first.bodies.w).abs()
                          .max())
            print(f"{what}, {name}: the first {CRM_VEHICLE_CPU_OUTER} outer "
                  f"steps against the port on the CPU, {ratio:.3f} of the "
                  f"tolerance (positions the North star's, velocities "
                  f"VEHICLE_V_TOL / VEHICLE_W_TOL, the terrain's v as "
                  f"phase 5 holds 3 cycles; max |Δω| {w_err:.3e} rad/s)")
    if extra:
        first = res["whole_outer"]
        x0 = float(sc["state"].bodies.x[sc["chassis"], 0])
        states, _ = vehicle_run(sc, first["adv"], extra,
                                f"{what}, whole_outer, driven",
                                state=first["states"][-1])
        rigid, on_cone, viol = vehicle_check(sc, states[-1],
                                             f"{what}, driven")
        xs = [float(st.bodies.x[sc["chassis"], 0]) for st in states]
        vx = float(states[-1].bodies.v[sc["chassis"], 0])
        _, rut = vehicle_line(sc, states[-1], 0)
        require(xs[-1] > min(xs) and vx > 0 and rut < R_WHEEL * 1000,
                f"{what}: chassis x {x0} -> min {min(xs)} -> {xs[-1]}, "
                f"v {vx}, rut {rut} mm")
        print(f"{what}, driven to t = {float(states[-1].time):.3f} s: the "
              f"chassis, rolled back to x = {min(xs):.4f} m while "
              f"settling (start {x0:.4f}), moved {xs[-1] - min(xs):.4e} m "
              f"forward to {xs[-1]:.4f} at {vx:.4f} m/s; rut {rut:.2f} mm, "
              f"joint violation {viol:.3e}, every check as above")
    return launches, res


def vehicle_main_path(card):
    """Phase 13: (a) the single-wheel mini bed, card against CPU; (b)
    config #5 as ``bench_crm`` builds it; (c) the same vehicle on phase 6's
    10 × 4 × 0.2 m lane at d0 = 0.02.  Returns the phase's launches by
    kernel."""
    t0 = time.perf_counter()
    fsi_wheel_parity()
    print(f"phase 13 (a) took {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    sc = crm_vehicle_scene()
    t = sc["state"].terrain
    print(f"config #5 (bench_crm): {t.n} markers ("
          f"{int((t.kind == FLUID).sum())} granular, "
          f"{int((t.kind == BOUNDARY).sum())} wall, {sc['n_rigid']} on the "
          f"wheels), {sc['model'].n_bodies} bodies, grid {sc['grid'].dims}, "
          f"dt {sc['params'].dt}, {sc['params'].rebuild_every} substeps an "
          f"outer step, rebuild_outer {CRM_VEHICLE_REBUILD}, C "
          f"{CRM_VEHICLE_C}")
    cpu = crm_vehicle_scene(device="cpu")
    t1 = time.perf_counter()
    cpu_first, ovf = fsi_persistent(cpu, torch.device("cpu"),
                                    CRM_VEHICLE_REBUILD, "last", False)(
        cpu["state"], CRM_VEHICLE_CPU_OUTER)
    require(int(ovf) == 0, "config #5 on the CPU: overflow")
    print(f"config #5, {CRM_VEHICLE_CPU_OUTER} outer steps on the CPU (the "
          f"twins): "
          f"{time.perf_counter() - t1:.2f} s")
    launches, _ = vehicle_engines(card, sc, CRM_VEHICLE_INTERVALS,
                                  "config #5", cpu_first=cpu_first,
                                  extra=CRM_VEHICLE_DRIVEN)
    print(f"phase 13 (b) took {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    lane = crm_vehicle_scene(size=(10.0, 4.0), depth=0.2, d0=0.02,
                             margin=6.0)
    t = lane["state"].terrain
    print(f"vehicle on the lane: {t.n} markers "
          f"({int((t.kind == FLUID).sum())} granular, "
          f"{int((t.kind == BOUNDARY).sum())} wall, {lane['n_rigid']} on the "
          f"wheels), grid {lane['grid'].dims}")
    more, _ = vehicle_engines(card, lane, 3, "lane")
    for k, v in more.items():
        launches[k] += v
    print(f"phase 13 (c) took {time.perf_counter() - t0:.2f} s")
    return launches


# ---------------------------------------------------------------- phase 14


DLC_H = 1e-3
DLC_STEPS = 15000
DLC_TARGET = 12.0
DLC_PARITY_STEPS = 200
# The JAX demo's own outcome: demos/demo_vehicle_dlc.py's scan, run on the
# CPU by `JAX_PLATFORMS=cpu python tools/dlc_reference.py --port` (the demo
# itself prints "travelled 81 m, max lateral 4.45 m"): the distance
# travelled, the largest lateral offset and the chassis speed after the last
# step.  The demo's vehicle does not reach its 12 m/s target: it holds the
# 6 m/s shift speed (gear 0 below it; above it the weaker gear 1 cannot beat
# the drag of the steering, which the path follower's derivative gain
# saturates and chatters), so the final speed is held to the demo's, not to
# 12 m/s.
JAX_DLC_TRAVELLED = 81.26022338867188
JAX_DLC_MAX_LATERAL = 4.445713520050049
JAX_DLC_FINAL_SPEED = 5.997819423675537
# the port on the CPU over the 15,000 steps (the same tool): float32
# 81.309 m / 4.4464 m / 6.0004 m/s, float64 81.280 m / 4.4496 m / 5.9959
# m/s; the tolerances are ten times the largest of those gaps to the JAX
# demo (0.049 m, 0.0039 m, 0.0025 m/s), rounded up
DLC_DIST_TOL = 0.5
DLC_LAT_TOL = 0.04
DLC_SPEED_TOL = 0.03
# the 200-step loop, card against the port on the CPU: twice the largest
# float32 floor tests/test_torch_vehicle.py::test_dlc_float32_floor
# bounds (2.5e-3 m); every chassis position of the track
DLC_X_ATOL = 5e-3
# graph replay against the eager loop when not bit for bit
DLC_REPLAY_RTOL = 1e-6
# The demo's joints do not stay within phase 11's 1e-3: its chattering
# steering loads them, and the JAX demo's own run (the same tool) exceeds
# 1e-3 in 63.5 % of its steps (median 2.17e-3, largest 5.29e-3, 5.9e-4
# after the last).  The final state is held below twice that largest.
DLC_VIOLATION = 1e-2
ROVER_H = 2e-3
ROVER_STEPS = 1500
# the first 50 Curiosity steps, card against CPU: positions to float32
# rounding, speeds as tests/test_torch_models.py holds them to JAX
ROVER_X_ATOL = 1e-5
ROVER_V_ATOL = 1e-3
DBP_RIG = dict(wheel_radius=0.3, wheel_width=0.2, mass=60.0, load=1200.0,
               v=0.5, h=1e-3, n_steps=900, settle_steps=400,
               start_xy=(0.6, 0.75))
DBP_TOL = dict(rtol=1e-3, atol=1e-2)
# (d): 300 steps of a straight-path follower (no derivative term), card
# against CPU at ten times the larger float32 floor of the two vehicles
# (the port on the CPU, float32 against float64, `python
# tools/dlc_reference.py --drive`: the sedan's chassis track 1.9e-5 m, the
# Polaris wishbone build's 5.6e-7 m)
DRIVE_STEPS = 300
DRIVE_X_ATOL = 2e-4


def dlc_controllers(device, dtype=torch.float32):
    """The demo's controllers: SpeedController(kp=0.6, ki=0.2) and
    PathFollower(look_ahead=8, kp=0.25, kd=0.15) on its DLC path."""
    return (SpeedController(kp=0.6, ki=0.2),
            PathFollower(path_xy=double_lane_change_path(dtype, device),
                         look_ahead=8.0, kp=0.25, kd=0.15))


def dlc_graph(device, n):
    vehicle, state = create_hmmwv(device=device)
    sc, pc = dlc_controllers(device)
    return vehicle, run_closed_loop(vehicle, state, sc, pc, flat_terrain(0.0),
                                    DLC_TARGET, DLC_H, n)


def dlc_eager(device, n):
    """The same loop as an eager Python loop of ``closed_loop_step``."""
    vehicle, state = create_hmmwv(device=device)
    sc, pc = dlc_controllers(device)
    t = torch.zeros((), device=state.x.device)
    xs = []
    for _ in range(n):
        xs.append(state.x[vehicle.chassis])
        state, sc, pc = closed_loop_step(vehicle, state, sc, pc,
                                         flat_terrain(0.0), DLC_TARGET, t,
                                         DLC_H)
        t = t + DLC_H
    return state, torch.stack(xs)


def state_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in "xqvw")


def dlc_parity(card):
    """(a): 200 steps eagerly on the card, through the graph on the card,
    and in the port on the CPU."""
    _, g1 = dlc_graph(DEV, DLC_PARITY_STEPS)
    _, g2 = dlc_graph(DEV, DLC_PARITY_STEPS)
    (eager_state, eager_xs), t_eager = mbs_timed(
        lambda: dlc_eager(DEV, DLC_PARITY_STEPS))
    _, cpu = dlc_graph("cpu", DLC_PARITY_STEPS)
    require(state_equal(g1.state, g2.state)
            and torch.equal(g1.chassis_x, g2.chassis_x),
            "DLC: two graph runs differ")
    err, rel = mbs_state_err(g1.state, eager_state)
    xerr = float((g1.chassis_x - eager_xs).abs().max())
    require(rel <= DLC_REPLAY_RTOL and xerr <= DLC_REPLAY_RTOL
            * float(eager_xs.abs().max()), f"DLC graph vs eager: {err}")
    print(f"HMMWV DLC, {DLC_PARITY_STEPS} steps: two graph runs bit for bit;"
          f" graph vs eager loop max abs err {err:.3e} "
          f"({'bit for bit' if err == 0 and xerr == 0 else f'{rel:.3e} rel'})"
          f", chassis track {xerr:.3e}; the lateral offset through the graph "
          f"{float(g1.chassis_x[:, 1].abs().max()):.6e} m, eager "
          f"{float(eager_xs[:, 1].abs().max()):.6e} m [{card}]")
    print(f"HMMWV DLC, {DLC_PARITY_STEPS} steps, eager loop: "
          f"{t_eager / DLC_PARITY_STEPS * 1e3:.4f} ms/step, RTF "
          f"{t_eager / (DLC_PARITY_STEPS * DLC_H):.4f} [{card}]")
    dx = float((g1.chassis_x.cpu() - cpu.chassis_x).abs().max())
    require(dx <= DLC_X_ATOL, f"DLC card vs CPU: chassis track {dx}")
    print(f"HMMWV DLC, {DLC_PARITY_STEPS} steps, card vs the port on the "
          f"CPU: chassis track max |Δx| {dx:.3e} m (≤ {DLC_X_ATOL}, twice "
          f"the float32 floor's bound) [{card}]")


def dlc_full(card):
    """(b): the full 15,000-step DLC through the graph, its timing, one
    step's kernels eager and replayed, and the demo's checks."""
    dlc_graph(DEV, 10)
    (_, _), t_setup = mbs_timed(lambda: dlc_graph(DEV, 0))
    (vehicle, out), t_graph = mbs_timed(lambda: dlc_graph(DEV, DLC_STEPS))
    sim_s = DLC_STEPS * DLC_H
    replay_ms = (t_graph - t_setup) / DLC_STEPS * 1e3
    print(f"HMMWV DLC, {DLC_STEPS} steps through the graph: "
          f"{t_graph / DLC_STEPS * 1e3:.4f} ms/step, RTF "
          f"{t_graph / sim_s:.4f} (the call: build, warm-up step and capture "
          f"{t_setup * 1e3:.2f} ms, replays {replay_ms:.4f} ms/step) "
          f"[{card}]")

    st = out.state
    require(all(bool(torch.isfinite(getattr(st, f)).all()) for f in "xqvw"),
            "DLC: non-finite state")
    viol = mbs_violation(vehicle.model, st)
    require(viol < DLC_VIOLATION, f"DLC: joint violation {viol}")
    speed = float(torch.linalg.norm(st.v[vehicle.chassis, :2]))
    xs = out.chassis_x.cpu()
    travelled = float(xs[-1, 0])
    lateral = float(xs[:, 1].max())
    print(f"HMMWV DLC: travelled {travelled:.4f} m, max lateral "
          f"{lateral:.4f} m (lane offset 3.5), final speed {speed:.4f} m/s "
          f"(target {DLC_TARGET}); the JAX demo: {JAX_DLC_TRAVELLED:.4f} m, "
          f"{JAX_DLC_MAX_LATERAL:.4f} m, {JAX_DLC_FINAL_SPEED:.4f} m/s; "
          f"finite, joint violation {viol:.3e} (< {DLC_VIOLATION}) "
          f"[{card}]")
    require(abs(travelled - JAX_DLC_TRAVELLED) <= DLC_DIST_TOL,
            f"DLC travelled {travelled}")
    require(abs(lateral - JAX_DLC_MAX_LATERAL) <= DLC_LAT_TOL,
            f"DLC max lateral {lateral}")
    require(abs(speed - JAX_DLC_FINAL_SPEED) <= DLC_SPEED_TOL,
            f"DLC final speed {speed}")

    # one step's kernels: an eager step, and 50 graph replays (the events
    # of a call of 50 replays less those of a call of none: both build,
    # warm up and capture)
    vehicle, state = create_hmmwv(device=DEV)
    sc, pc = dlc_controllers(DEV)
    t = torch.zeros((), device=DEV)

    def eager_step():
        closed_loop_step(vehicle, state, sc, pc, flat_terrain(0.0),
                         DLC_TARGET, t, DLC_H)

    eager_step()
    _, events = device_events(eager_step)
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    names = {}
    for e in events:
        names[e.name] = names.get(e.name, 0) + 1
    top = ", ".join(f"{k[:40]} {v}" for k, v in sorted(
        names.items(), key=lambda kv: -kv[1])[:6])
    print(f"HMMWV DLC, one eager step under the profiler: {len(events)} "
          f"kernel launches, {busy:.4f} ms of device time ({top}) [{card}]")
    counts = {}
    for n in (0, 50):
        wall, events = device_events(lambda: dlc_graph(DEV, n))
        counts[n] = (len(events), sum(e.time_range.elapsed_us()
                                      for e in events) / 1e3, wall * 1e3)
    kernels, busy, wall = ((counts[50][i] - counts[0][i]) / 50
                           for i in range(3))
    print(f"HMMWV DLC, graph replays under the profiler: {kernels:.1f} "
          f"kernels and {busy:.4f} ms of device time a step in {wall:.4f} "
          f"ms of wall, idle {1 - busy / wall:.4f} of a replay with the "
          f"profiler on ({replay_ms:.4f} ms a replay with it off) [{card}]")


def curiosity(device):
    """tests/test_models_modal.py:110-140's scene: wheel speeds of 3 rad/s
    and an 8.5 × 5 m patch at 0.06 m (143 × 85 = 12,155 nodes)."""
    rover, state = create_curiosity(device=device)
    rover = set_wheel_speeds(rover, [3.0] * 6)
    params = fields_as_tensors(SCMParams(Kphi=2e6, n_exp=1.0,
                                         friction_angle=0.8, janosi_k=0.01),
                               state.x)
    return rover, state, params, make_scm_state((-2.5, -2.5), (6, 2.5), 0.06,
                                                device=device)


def curiosity_eager(device, n):
    rover, state, params, scm = curiosity(device)
    t = torch.zeros((), device=state.x.device)
    for _ in range(n):
        state, scm, _ = rover_step_scm(rover, state, params, scm, t, ROVER_H)
        t = t + ROVER_H
    return rover, state, scm


def curiosity_graph(n, timed=False):
    """``rover_step_scm`` captured into a CUDA graph and replayed ``n``
    times: the body state, the sinkage and ``t`` are static buffers the
    step updates.  With ``timed``, CUDA events around the replays give
    the ms a step."""
    rover, state, params, scm = curiosity(DEV)
    cur = BodyState(**{f: getattr(state, f).clone() for f in "xqvw"})
    sink = scm.sinkage.clone()
    t = torch.zeros((), device=DEV)

    def compute():
        return rover_step_scm(rover, cur, params, scm.replace(sinkage=sink),
                              t, ROVER_H)

    def one_step():
        new, new_scm, _ = compute()
        for f in "xqvw":
            getattr(cur, f).copy_(getattr(new, f))
        sink.copy_(new_scm.sinkage)
        t.add_(ROVER_H)

    graph = capture(one_step, compute, DEV)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / max(n, 1)
    return rover, cur, scm.replace(sinkage=sink), (ms if timed else None)


def rover_and_rig(card):
    """(c): Curiosity on SCM and the DBP rig."""
    rover, st, scm, ms = curiosity_graph(ROVER_STEPS, timed=True)
    _, st2, scm2, _ = curiosity_graph(ROVER_STEPS)
    require(state_equal(st, st2) and torch.equal(scm.sinkage, scm2.sinkage),
            "Curiosity: two graph runs differ")
    x = float(st.x[rover.chassis, 0])
    sink = float(scm.sinkage.max())
    wz = st.x[rover.wheel_index, 2]
    r = float(rover.wheel_radius)
    up = Q.qrotate(st.q[rover.chassis],
                   torch.eye(3, device=DEV)[2])
    viol = mbs_violation(rover.model, st)
    require(x > 0.4 and sink > 0.002 and bool((wz > 0.5 * r).all())
            and bool((wz < 1.6 * r).all()) and float(up[2]) > 0.97
            and viol < MBS_VIOLATION,
            f"Curiosity: x {x}, sinkage {sink}, wheel z {wz.tolist()}, up "
            f"{up.tolist()}, joint violation {viol}")
    print(f"Curiosity on SCM, {ROVER_STEPS} steps of {ROVER_H} s through a "
          f"graph of rover_step_scm ({scm.sinkage.numel()} nodes): "
          f"{ms:.4f} ms/step; chassis x {x:.4f} m (> 0.4), max sinkage "
          f"{sink:.5f} m (> 0.002), wheel z in [{float(wz.min()):.4f}, "
          f"{float(wz.max()):.4f}] m, chassis up z {float(up[2]):.5f} "
          f"(> 0.97), joint violation {viol:.3e}; two runs bit for bit "
          f"[{card}]")
    _, cs, cscm = curiosity_eager(DEV, 50)
    _, ps, pscm = curiosity_eager("cpu", 50)
    dx = max(float((getattr(cs, f).cpu() - getattr(ps, f)).abs().max())
             for f in "xq")
    dv = max(float((getattr(cs, f).cpu() - getattr(ps, f)).abs().max())
             for f in "vw")
    ds = float((cscm.sinkage.cpu() - pscm.sinkage).abs().max())
    require(dx <= ROVER_X_ATOL and dv <= ROVER_V_ATOL and ds <= ROVER_X_ATOL,
            f"Curiosity card vs CPU: x/q {dx}, v/w {dv}, sinkage {ds}")
    print(f"Curiosity, 50 steps, card vs the port on the CPU: x/q {dx:.3e} "
          f"(≤ {ROVER_X_ATOL}), v/w {dv:.3e} (≤ {ROVER_V_ATOL}), sinkage "
          f"{ds:.3e} [{card}]")
    # the SCM pass alone at the patch's node count
    rover, state, params, scm0 = curiosity(DEV)
    w = rover.wheel_index
    ms_scm = cuda_ms(lambda: scm_wheel_forces(
        params, scm0, state.x[w], state.q[w], state.v[w], state.w[w],
        rover.wheel_radius, rover.wheel_width), 200)
    print(f"SCM pass alone (6 wheels x {scm0.sinkage.numel()} nodes), "
          f"eager: {ms_scm:.4f} ms/call (CUDA events, 200 calls) [{card}]")

    # the DBP rig: tests/test_dbp.py's checks
    def rig(slip, device=DEV, **kw):
        scm = make_scm_state((0, 0), (3.0, 1.5), 0.025, device=device)
        params = fields_as_tensors(SCMParams(Kphi=6e5, Kc=0.0, n_exp=1.0),
                                   scm.z0)
        return run_dbp_rig(params, scm, slip=slip, **{**DBP_RIG, **kw})

    pulls, sinks, tqs = {}, {}, {}
    t0 = time.perf_counter()
    for s in (0.05, 0.4):
        out = rig(s)
        tail = out.pull.shape[0] // 3
        pulls[s] = float(out.pull[-tail:].mean())
        sinks[s] = float(out.sinkage[-tail:].mean())
        tqs[s] = abs(float(out.torque[-tail:].mean()))
        require(bool(torch.isfinite(out.pull).all()), "DBP: non-finite pull")
    t_rig = (time.perf_counter() - t0) / 2
    rut = float(rig(0.2).scm.sinkage.max())
    again = rig(0.4)
    require(torch.equal(again.pull, out.pull)
            and torch.equal(again.scm.sinkage, out.scm.sinkage),
            "DBP: two runs differ")
    require(pulls[0.4] > pulls[0.05] + 20.0 and sinks[0.05] > 0.005
            and rut > 0.005 and tqs[0.4] > tqs[0.05],
            f"DBP: pulls {pulls}, sinkage {sinks}, rut {rut}, torque {tqs}")
    cut = dict(settle_steps=25, n_steps=25)
    card_r, cpu_r = rig(0.4, **cut), rig(0.4, "cpu", **cut)
    ratio = max(check_close(getattr(card_r, f), getattr(cpu_r, f),
                            DBP_TOL["rtol"], DBP_TOL["atol"],
                            f"DBP {f} card vs CPU")[1]
                for f in ("pull", "torque"))
    print(f"DBP rig (3.0 x 1.5 m at 0.025 m, {DBP_RIG['settle_steps']} + "
          f"{DBP_RIG['n_steps']} steps, {t_rig:.2f} s a run): pull "
          f"{pulls[0.05]:.2f} N at slip 0.05, {pulls[0.4]:.2f} N at 0.4 "
          f"(> +20), sinkage {sinks[0.05]:.5f} m (> 0.005), rut at 0.2 "
          f"{rut:.5f} m, |torque| {tqs[0.05]:.3f} < {tqs[0.4]:.3f} N m; two "
          f"runs bit for bit; the first 50 steps card vs CPU {ratio:.3f} of "
          f"rtol {DBP_TOL['rtol']} / atol {DBP_TOL['atol']} [{card}]")


DRIVE_BUILDS = {
    "Polaris, wishbone": lambda device, dtype=torch.float32: create_polaris(
        suspension="wishbone", dtype=dtype, device=device),
    "sedan": lambda device, dtype=torch.float32: create_sedan(
        dtype=dtype, device=device)}


def drive(build, device, dtype=torch.float32):
    """A straight-path follower (target 5 m/s, path 0.5 m to the left, no
    derivative term) for ``DRIVE_STEPS`` steps."""
    vehicle, state = build(device, dtype)
    return run_closed_loop(
        vehicle, state, SpeedController(kp=0.6, ki=0.2),
        PathFollower(path_xy=straight_path(0.0, 0.5, 200.0, 50, dtype=dtype,
                                           device=device),
                     look_ahead=6.0, kp=0.3, kd=0.0),
        flat_terrain(0.0), 5.0, DLC_H, DRIVE_STEPS)


def wishbone_and_sedan(card):
    """(d): the Polaris wishbone build (steered through its rack) and the
    sedan, card against CPU."""
    for what, build in DRIVE_BUILDS.items():
        card_out, t_run = mbs_timed(lambda: drive(build, DEV))
        cpu_out = drive(build, "cpu")
        dx = float((card_out.chassis_x.cpu() - cpu_out.chassis_x).abs().max())
        st = card_out.state
        require(all(bool(torch.isfinite(getattr(st, f)).all())
                    for f in "xqvw") and dx <= DRIVE_X_ATOL,
                f"{what}: card vs CPU {dx}")
        y = float(card_out.chassis_x[-1, 1])
        print(f"{what}, {DRIVE_STEPS} steps through the graph ({t_run:.2f} "
              f"s with build and capture): chassis at x "
              f"{float(card_out.chassis_x[-1, 0]):.4f}, y {y:.4f} m; card vs "
              f"CPU chassis track max |Δx| {dx:.3e} (≤ {DRIVE_X_ATOL}) "
              f"[{card}]")


def wheeled_main_path(card):
    """Phase 14: the HMMWV double lane change, Curiosity on SCM, the DBP
    rig, the Polaris wishbone build and the sedan."""
    # N = D M⁻¹ Dᵀ must be full float32 (solver/direct.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    for part, fn in (("a", dlc_parity), ("b", dlc_full),
                     ("c", rover_and_rig), ("d", wishbone_and_sedan)):
        t0 = time.perf_counter()
        fn(card)
        print(f"phase 14 ({part}) took {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------- phase 15


# tests/test_fsi.py:20-71: a cube floating in a periodic-xy tank
BLOCK_W, BLOCK_H, BLOCK_SIDE, BLOCK_RHO0 = 0.24, 0.3, 0.08, 1000.0
# the bodies card against CPU: tests/test_torch_crm_fsi.py's coupled-step
# tolerances (x rtol 1e-5 / atol 1e-6, v rtol 1e-4 / atol 1e-5); the
# markers at the North star's
BLOCK_T_SIM = {500.0: 0.4, 3000.0: 0.25}
# config #4 at a real size: d0 = 0.006 (40 spacings over the period),
# cells of W/16 = 0.015 m (≥ 2h = 0.0144), 96 neighbours, 32 markers a
# cell for the light block; the heavy one settles on the floor, where its
# markers and the floor's share cells (36 at most over its 0.25 s, rows
# 88 at most: a probe at 64 and 160 slots on the H100), so 48
BLOCK_D0, BLOCK_CELLS, BLOCK_K = 0.006, 16, 96
BLOCK_C = {500.0: 32, 3000.0: 48}
GATHER_DAM_C, GATHER_DAM_K = 64, 96


def floating_block_scene(d0=0.02, rho_solid=500.0, cells=3, max_per_cell=80,
                         max_neighbors=96, device=None):
    """tests/test_fsi.py's floating block on the port: a cube of side 0.08 m
    and density ``rho_solid`` (3 BCE layers, body 0) at its Archimedes
    height in 0.3 m of water (ρ0 1000, μ 0.5, c_s 15, laminar, XSPH 0.2,
    symplectic, dt = suggest_sph_dt) over 3 floor layers, in a 0.24 m
    tank periodic in x and y, the water at its hydrostatic density; the
    grid ``cells`` × ``cells`` cells across the period (the test: 3, 80
    slots).  Returns a dict with the model, params, grid, state, z0."""
    dev = torch.device(device or DEV)
    W, H, side, rho0 = BLOCK_W, BLOCK_H, BLOCK_SIDE, BLOCK_RHO0
    params = SPHParams(d0=d0, h=1.2 * d0, rho0=rho0, mu=0.5, c_s=15.0,
                       gravity=(0.0, 0.0, -G), dt=1e-4,
                       viscosity_model="laminar",
                       max_neighbors=max_neighbors,
                       max_per_cell=max_per_cell, rebuild_every=1,
                       integrator="symplectic", xsph_eps=0.2)
    params = params.replace(dt=suggest_sph_dt(params))
    m = rho_solid * side ** 3
    inertia = m * side ** 2 / 6.0
    z0 = H - side * rho_solid / rho0 + side / 2
    bld = SystemBuilder(device=dev)
    bld.add_body(mass=m, inertia=(inertia,) * 3, pos=(W / 2, W / 2, z0))
    model, bodies = bld.finalize()
    fluid = grid_sample_box((0, 0, 0), (W, W, H), d0)
    lo = np.array([W / 2 - side / 2, W / 2 - side / 2, z0 - side / 2])
    pad = 0.5 * d0
    fluid = fluid[~np.all((fluid > lo - pad) & (fluid < lo + side + pad),
                          axis=1)]
    floor = grid_sample_box((0, 0, -3 * d0), (W, W, 0), d0)
    shell = fsi_bce.box_body_markers((side / 2,) * 3, d0, layers=3)
    fl = make_sph_state(params, fluid, boundary_pts=floor,
                        rigid_pts=shell + np.array([W / 2, W / 2, z0]),
                        rigid_body_ids=np.zeros(len(shell), int),
                        rigid_local=shell, device=dev)
    g = params.eos_gamma
    B = params.c_s ** 2 * rho0 / g
    p_h = rho0 * G * torch.clamp(H - fl.pos[:, 2], min=0.0)
    fl = fl.replace(rho=torch.where(fl.kind == FLUID,
                                    rho0 * (1.0 + p_h / B) ** (1.0 / g),
                                    fl.rho))
    cell = W / cells
    grid = GridSpec(origin=(0.0, 0.0, -4 * d0), cell_size=cell,
                    dims=(cells, cells, int(np.ceil(2 * H / cell)) + 1),
                    periodic=(True, True, False))
    return dict(model=model, params=params, grid=grid, z0=z0,
                state=FSIState(bodies=bodies, fluid=fl,
                               time=torch.zeros((), device=dev)))


def periodic_column_scene(device=None, nx=10, nz=20, d0=0.02):
    """tests/test_sph.py:51-90's hydrostatic_setup on the port: a periodic
    x–y water column (nx × nx × nz markers over 3 floor layers, ρ0 1000,
    μ 0.05, c_s 20, laminar, symplectic, 4 substeps a cycle, 80 slots, 96
    neighbours), at its hydrostatic density."""
    dev = torch.device(device or DEV)
    H, W = nz * d0, nx * d0
    params = SPHParams(d0=d0, h=1.2 * d0, rho0=1000.0, mu=0.05, c_s=20.0,
                       gravity=(0.0, 0.0, -G), dt=1e-4,
                       viscosity_model="laminar", max_neighbors=96,
                       max_per_cell=80, rebuild_every=4,
                       integrator="symplectic")
    params = params.replace(dt=suggest_sph_dt(params))
    fluid = grid_sample_box((0, 0, 0), (W, W, H), d0)
    floor = grid_sample_box((0, 0, -3 * d0), (W, W, 0), d0)
    nxc = max(int(round(W / (2.5 * 1.2 * d0))), 1)
    cell = W / nxc
    grid = GridSpec(origin=(0.0, 0.0, -6 * d0), cell_size=cell,
                    dims=(nxc, nxc, int(np.ceil((2 * H + 6 * d0) / cell))
                          + 2), periodic=(True, True, False))
    st = make_sph_state(params, fluid, boundary_pts=floor, device=dev)
    g = params.eos_gamma
    B = params.c_s ** 2 * 1000.0 / g
    p_h = 1000.0 * G * torch.clamp(H - st.pos[:, 2], min=0.0)
    st = st.replace(rho=torch.where(st.kind == FLUID,
                                    1000.0 * (1.0 + p_h / B) ** (1.0 / g),
                                    st.rho))
    return params, grid, st


def same_list(a, b):
    return (torch.equal(a.idx.cpu(), b.idx.cpu())
            and torch.equal(a.valid.cpu(), b.valid.cpu())
            and int(a.overflow) == int(b.overflow))


def sph_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("pos", "vel", "rho")) and same_list(a.nbr, b.nbr)


def sph_close(got, ref, what, x_tol=NS_X_TOL, v_tol=NS_V_TOL):
    """Markers ``got`` against ``ref`` (either device): x and v at the
    given tolerances (v's atol scaled by max(1, max|v|)), ρ at the SPH
    state tolerance.  Returns the largest error over its tolerance."""
    v_ref = ref.vel.cpu()
    tv = dict(rtol=v_tol["rtol"],
              atol=v_tol["atol"] * max(1.0, float(v_ref.abs().max())))
    return max(check_close(g.cpu(), r.cpu(), what=f"{what} {w}", **t)[1]
               for g, r, t, w in ((got.pos, ref.pos, x_tol, "x"),
                                  (got.vel, v_ref, tv, "v"),
                                  (got.rho, ref.rho, SPH_RHO_TOL, "rho")))


def block_run(sc, dev, n_outer, scheme):
    """``make_fsi_advance_fn`` of a block scene on ``dev``: (state,
    overflow)."""
    adv = make_fsi_advance_fn(sc["model"], sc["params"], sc["grid"], 2,
                              scheme=scheme, device=dev)
    return adv(sc["state"], n_outer)


def gather_card_vs_cpu():
    """Phase 15 (a): at the JAX tests' sizes, the card against the port on
    the CPU from the same inputs, each run twice on the card (bit for
    bit), the lists equal entry for entry at step 0."""
    cpu = torch.device("cpu")
    lines = []
    sc, sc_cpu = floating_block_scene(), floating_block_scene(device=cpu)
    p, g = sc["params"], sc["grid"]
    nb = rebuild_sph_neighbors(p, g, sc["state"].fluid).nbr
    nb_cpu = rebuild_sph_neighbors(p, g, sc_cpu["state"].fluid).nbr
    require(same_list(nb, nb_cpu) and int(nb.overflow) == 0,
            "floating block: the lists differ at step 0")
    for scheme, n_outer in (("wcsph", 20), ("isph", 10)):
        a, ovf = block_run(sc, DEV, n_outer, scheme)
        b, _ = block_run(sc, DEV, n_outer, scheme)
        ref, ovf_cpu = block_run(sc_cpu, cpu, n_outer, scheme)
        require(int(ovf) == int(ovf_cpu) == 0,
                f"floating block, {scheme}: overflow")
        require(sph_equal(a.fluid, b.fluid) and all(torch.equal(
            getattr(a.bodies, f), getattr(b.bodies, f)) for f in "xqvw"),
            f"floating block, {scheme}: two runs on the card differ")
        r_b = max(check_close(getattr(a.bodies, f).cpu(),
                              getattr(ref.bodies, f), what=f"block {f}",
                              **tol)[1]
                  for f, tol in (("x", FSI_X_TOL), ("q", FSI_X_TOL),
                                 ("v", FSI_V_TOL), ("w", FSI_V_TOL)))
        r_f = sph_close(a.fluid, ref.fluid, f"floating block {scheme}")
        lines.append(f"floating block ({sc['state'].fluid.n} markers), "
                     f"{scheme}, {n_outer} outer steps x 2 substeps: body "
                     f"{r_b:.3f}, markers {r_f:.3f} of the tolerance, vz "
                     f"{float(a.bodies.v[0, 2]):.4e} m/s")
    params, grid, st = periodic_column_scene()
    _, _, st_cpu = periodic_column_scene(device=cpu)
    require(same_list(rebuild_sph_neighbors(params, grid, st).nbr,
                      rebuild_sph_neighbors(params, grid, st_cpu).nbr),
            "periodic column: the lists differ at step 0")
    a, ovf = make_sph_advance_fn(params, grid, device=DEV)(st, 3)
    b, _ = make_sph_advance_fn(params, grid, device=DEV)(st, 3)
    ref, ovf_cpu = make_sph_advance_fn(params, grid, device=cpu)(st_cpu, 3)
    require(int(ovf) == int(ovf_cpu) == 0, "periodic column: overflow")
    require(sph_equal(a, b), "periodic column: two runs on the card differ")
    lines.append(f"periodic column ({st.n} markers), 3 cycles x 4 "
                 f"substeps: {sph_close(a, ref, 'periodic column'):.3f} of "
                 f"the tolerance")
    sc, sc_cpu = crm_wheel_scene(), crm_wheel_scene(device=cpu)
    t, t_cpu = sc["state"].terrain, sc_cpu["state"].terrain
    cut = sph_kernels.KERNELS[sc["params"].kernel][2] * sc["params"].h
    require(same_list(
        build_neighbor_list(sc["grid"], t.pos, cut, sc["params"].max_per_cell,
                            sc["params"].max_neighbors),
        build_neighbor_list(sc["grid"], t_cpu.pos, cut,
                            sc["params"].max_per_cell,
                            sc["params"].max_neighbors)),
            "wheel bed: the lists differ at step 0")
    runs = []
    for s, d in ((sc, DEV), (sc, DEV), (sc_cpu, cpu)):
        st = s["state"]
        for _ in range(4):
            st, ov, _ = crm_fsi_step(s["model"], s["params"], s["soil"],
                                     s["grid"], st, 2, s["wheels"],
                                     f_ext_fn=s["drive"])
            require(int(ov) == 0, "wheel bed, gather: overflow")
        runs.append(st)
    require(fsi_equal(runs[0], runs[1]),
            "wheel bed, gather: two runs on the card differ")
    r = fsi_close(runs[0], runs[2], "wheel bed gather card vs CPU",
                  FSI_X_TOL, FSI_V_TOL, terrain=False)
    r_t = fsi_close(runs[0], runs[2], "wheel bed gather card vs CPU")
    lines.append(f"wheel bed ({t.n} markers), crm_fsi_step on the gather "
                 f"backend, 4 outer steps x 2 substeps: the wheel {r:.3f} "
                 f"of the coupled step's tolerance, bodies and terrain "
                 f"{r_t:.3f} of the North star's")
    print("phase 15 (a), card vs the port on the CPU, two runs on the card "
          "bit for bit, the lists equal at step 0: " + "; ".join(lines))


def fsi_pieces(sc, st, n_sub=2):
    """One outer step of ``fsi_step`` in its four parts, each under the
    profiler: (kernels, device ms) of the list rebuild (with the markers'
    move), the fluid substeps, the reaction and its reduction, and the
    multibody step (a graph replay)."""
    p, g, model = sc["params"], sc["grid"], sc["model"]
    b, f = st.bodies, st.fluid
    mbs = MBSStep(model, p.dt * n_sub, SolverSettings(solver="direct"))
    box = {}

    def rebuild():
        pos, vel = fsi_bce.update_rigid_markers(
            f.pos, f.vel, f.kind, f.body_id, f.bce_local, b.x, b.q, b.v, b.w)
        box["f"] = rebuild_sph_neighbors(p, g, f.replace(pos=pos, vel=vel))

    def substeps():
        fl = box["f"]
        for _ in range(n_sub):
            fl = sph_substep(p, g, fl)
        box["f"] = fl

    def reaction():
        fl = box["f"]
        _, dv = sph_wcsph.wcsph_rhs(p, g, fl.pos, fl.vel, fl.rho, fl.kind,
                                    fl.nbr.idx, fl.nbr.valid)
        fb, tw = fsi_bce.rigid_body_forces(p, dv, fl.kind, fl.body_id,
                                           fl.pos, b.x, model.n_bodies)
        box["load"] = (fb, Q.qrotate_inv(b.q, tw))

    out = {}
    for name, fn in (("rebuild", rebuild), ("substeps", substeps),
                     ("reaction", reaction)):
        _, ev = device_events(fn)
        out[name] = (len(ev), sum(e.time_range.elapsed_us()
                                  for e in ev) / 1e3)
    mbs(b, st.time, *box["load"])
    _, ev = device_events(lambda: mbs(b, st.time, *box["load"]))
    out["mbs"] = (len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3)
    return out


def block_at_size(card):
    """Phase 15 (b): config #4's rigid-body coupling at d0 = 0.006 m, the
    light and the heavy block through ``make_fsi_advance_fn`` with
    tests/test_fsi.py's checks."""
    for rho_solid, t_sim in BLOCK_T_SIM.items():
        sc = floating_block_scene(BLOCK_D0, rho_solid, BLOCK_CELLS,
                                  BLOCK_C[rho_solid], BLOCK_K)
        p, st0 = sc["params"], sc["state"]
        fl0 = st0.fluid
        n_fluid = int((fl0.kind == FLUID).sum())
        n_outer = int(t_sim / (2 * p.dt))
        adv = make_fsi_advance_fn(sc["model"], p, sc["grid"], 2, device=DEV)
        st, ovf = adv(st0, 1)                               # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ovf2 = adv(st, n_outer - 2)
        prev = st.bodies
        st, ovf3 = adv(st, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ovf = max(int(ovf), int(ovf2), int(ovf3))
        require(ovf == 0, f"block {rho_solid}: list overflow {ovf}")
        f = st.fluid
        require(all(bool(torch.isfinite(a).all()) for a in
                    (f.pos, f.vel, f.rho, st.bodies.x, st.bodies.v)),
                f"block {rho_solid}: non-finite state")
        floor = fl0.kind == BOUNDARY
        require(torch.equal(f.pos[floor], fl0.pos[floor]),
                f"block {rho_solid}: a floor marker moved")
        want, _ = fsi_bce.update_rigid_markers(
            f.pos, f.vel, f.kind, f.body_id, f.bce_local, prev.x, prev.q,
            prev.v, prev.w)
        rig = f.kind == RIGID_BCE
        r_err = float((f.pos[rig] - want[rig]).abs().max())
        require(r_err <= 4 * EPS32 * float(f.pos[rig].abs().max()),
                f"block {rho_solid}: a rigid marker is {r_err} m off")
        z, vz = float(st.bodies.x[0, 2]), float(st.bodies.v[0, 2])
        top = float(f.pos[f.kind == FLUID, 2].max())
        require(top < 2 * BLOCK_H, f"block {rho_solid}: fluid at z {top}")
        if rho_solid < BLOCK_RHO0:
            require(abs(z - sc["z0"]) < 0.025 and abs(vz) < 0.25,
                    f"light block: z {z} vs {sc['z0']}, vz {vz}")
        else:
            require(z < sc["z0"] - 0.03, f"heavy block: {sc['z0']} -> {z}")
        ms = wall / (n_outer - 1) * 1e3
        print(f"block rho {rho_solid:.0f} at d0 {BLOCK_D0} ({f.n} markers: "
              f"{n_fluid} fluid, {int(floor.sum())} floor, {int(rig.sum())} "
              f"on the cube; grid {sc['grid'].dims}, {BLOCK_C[rho_solid]} a "
              f"cell, "
              f"{BLOCK_K} neighbours): {n_outer} outer steps of 2 substeps "
              f"(t = {float(st.time):.4f} s), z {z:.5f} (start "
              f"{sc['z0']:.5f}, the light block's Archimedes height), vz "
              f"{vz:.4e} m/s, fluid top {top:.4f} m, "
              f"overflow 0 at every rebuild, floor unmoved, rigid markers "
              f"within {r_err:.2e} m; {ms:.4f} ms an outer step (host "
              f"clock) on {card}")
        if rho_solid < BLOCK_RHO0:
            pieces = fsi_pieces(sc, st)
            total = sum(ms_ for _, ms_ in pieces.values())
            print("block, one profiled outer step by part (kernels, device "
                  "ms): " + "; ".join(
                      f"{k} {n} kernels {t:.4f} ms" for k, (n, t) in
                      pieces.items()) + f"; {total:.4f} ms of device time "
                  f"in all")
            RATES["block_ms"] = ms


def gather_dam(card, n_target=1_000_000):
    """Phase 15 (c): phase 4's dam break (1,069,751 markers) through the
    gather backend's ``make_sph_advance_fn``, on phase 4's cells with 64
    markers a cell and 96 neighbours, 8 substeps a cycle; then one substep
    against phase 4's CUDA sweeps on the same input."""
    params, grid, state, C = dam_scene(n_target)
    params = params.replace(max_per_cell=GATHER_DAM_C,
                            max_neighbors=GATHER_DAM_K)
    n = state.n
    fluid = state.kind == FLUID
    torch.cuda.reset_peak_memory_stats()
    adv = make_sph_advance_fn(params, grid, device=DEV)
    st, ovf = adv(state, 1)                                 # warm-up
    require(int(ovf) == 0, f"gather dam warm-up overflow {int(ovf)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, ovf = adv(st, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(int(ovf) == 0, f"gather dam overflow {int(ovf)}")
    require(all(bool(torch.isfinite(a).all()) for a in
                (st.pos, st.vel, st.rho)), "gather dam: non-finite state")
    require(torch.equal(st.pos[~fluid], state.pos[~fluid]),
            "gather dam: a boundary marker moved")
    rho = st.rho[fluid]
    lo, hi = float(rho.min()), float(rho.max())
    require(0.7 * params.rho0 <= lo and hi <= 1.5 * params.rho0,
            f"gather dam: fluid density [{lo}, {hi}]")
    steps = 2 * params.rebuild_every
    rate = n * steps / wall
    most = int(st.nbr.valid.sum(1).max())
    one = params.replace(rebuild_every=1)
    got, _ = make_sph_advance_fn(one, grid, device=DEV)(st, 1)
    ref, ovf_p = make_sph_advance_pencil(one, grid, capacity=C,
                                         device=DEV)(st, 1)
    require(int(ovf_p) == 0, "gather dam: the sweeps overflow")
    v_scale = float(ref.vel.abs().max())
    r = max(check_close(got.rho, ref.rho, what="gather dam rho",
                        **SPH_RHO_TOL)[1],
            check_close(got.vel, ref.vel, SPH_VEL_RTOL,
                        SPH_VEL_ATOL * v_scale, "gather dam v")[1],
            check_close(got.pos, ref.pos, what="gather dam x",
                        **SPH_POS_TOL)[1])
    ph4 = RATES.get("dam")
    print(f"gather dam ({n} markers, grid {grid.dims}, {GATHER_DAM_C} a "
          f"cell, {GATHER_DAM_K} neighbours, most in a row {most}): "
          f"{steps} substeps in {wall:.4f} s = {rate:.6e} marker-steps/s "
          f"(host clock), peak device memory {peak:.3f} GiB, on {card}; "
          f"phase 4's sweeps: "
          + (f"{ph4:.6e} marker-steps/s" if ph4 else "not run in this call")
          + f"; overflow 0, finite, boundary unmoved, fluid rho [{lo:.4f}, "
          f"{hi:.4f}]; one substep against phase 4's CUDA sweeps {r:.3f} of "
          f"the SPH state tolerance")
    RATES["gather_dam"] = rate


def vehicle_gather(card):
    """Phase 15 (d): config #5's demo bed on CRM's default engine, the
    gather backend, through ``make_crm_fsi_advance_fn``: bench_crm's 6
    intervals of 40 outer steps with phase 13's checks, and the first 10
    outer steps against the pencil engine."""
    sc = crm_vehicle_scene()
    p = sc["params"]
    adv = make_crm_fsi_advance_fn(sc["model"], p, sc["soil"], sc["grid"],
                                  p.rebuild_every, sc["wheels"],
                                  f_ext_fn=sc["drive"], device=DEV)
    states, walls = vehicle_run(sc, adv, CRM_VEHICLE_INTERVALS,
                                "config #5, gather")
    rigid, on_cone, viol = vehicle_check(sc, states[-1], "config #5, gather")
    _, rut = vehicle_line(sc, states[-1], 0)
    require(rut < R_WHEEL * 1000, f"config #5, gather: rut {rut} mm")
    sim = CRM_VEHICLE_OUTER * p.dt * p.rebuild_every
    rtf = sum(walls[1:]) / (sim * (CRM_VEHICLE_INTERVALS - 1))
    ms = sum(walls[1:]) / ((CRM_VEHICLE_INTERVALS - 1)
                           * CRM_VEHICLE_OUTER) * 1e3
    a, ovf = adv(sc["state"], CRM_VEHICLE_CPU_OUTER)
    pencil = make_crm_fsi_advance_fn(
        sc["model"], p, sc["soil"], sc["grid"], p.rebuild_every,
        sc["wheels"], f_ext_fn=sc["drive"], engine="pencil",
        pencil_capacity=CRM_VEHICLE_C, device=DEV)
    b, ovf_p = pencil(sc["state"], CRM_VEHICLE_CPU_OUTER)
    require(int(ovf) == int(ovf_p) == 0, "config #5: overflow")
    r = fsi_close(a, b, "config #5, gather vs pencil", long_run=True)
    ph13 = RATES.get("config5_rtf")
    print(f"config #5, gather ({sc['state'].terrain.n} markers): "
          f"steady-state RTF = {rtf:.4f} ({ms:.4f} ms an outer step; first "
          f"interval {walls[0]:.3f} s left out) on {card}; phase 13's "
          f"persistent engine: "
          + (f"RTF {ph13:.4f}" if ph13 else "not run in this call")
          + f"; finite, walls unmoved, rigid markers within {rigid:.3e} m, "
          f"every granular stress inside the cone ({on_cone:.4f} on it), "
          f"joint violation {viol:.3e}, rut {rut:.2f} mm; the first "
          f"{CRM_VEHICLE_CPU_OUTER} outer steps against the pencil engine "
          f"{r:.3f} of the tolerance")


def gather_main_path(card):
    """Phase 15: the neighbour-list (gather) backend: (a) card against
    CPU, (b) config #4's rigid body at a real size, (c) the dam break at
    full width, (d) config #5's demo bed on CRM's default engine."""
    for part, fn in (("a", lambda c: gather_card_vs_cpu()),
                     ("b", block_at_size), ("c", gather_dam),
                     ("d", vehicle_gather)):
        t0 = time.perf_counter()
        fn(card)
        print(f"phase 15 ({part}) took {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------- phase 16

DEM_INTEGRATORS = ("forward_euler", "centered_difference",
                   "extended_taylor", "chung")
DEM_FRICTION = ("frictionless", "single_step", "multi_step")
DEM_ROLLING = ("schwartz", "elastic_plastic")
DEM_CYCLES = 3
# the North-star tolerances: positions in m, velocities in m/s; spins in
# rad/s at the velocities' tolerance over the radius (a surface speed of
# 1e-4 m/s at r = 5 cm)
DEM_X_TOL = dict(rtol=1e-4, atol=1e-5)
DEM_V_TOL = dict(rtol=1e-3, atol=1e-4)
DEM_W_TOL = dict(rtol=1e-3, atol=2e-3)
DEM_BOX_MAT = dict(youngs=5e6, poisson=0.3, restitution=0.4, mu_s=0.5)
DEM_MU_R, DEM_WALL_MU_R = 0.2, 0.1
# the user-stiffness model's raw coefficients on the 1 m box (K [N/m],
# Γ [1/s]), stiff enough that the pairs stay shallow at its dt
DEM_USER_MAT = dict(kn=2e5, gn=40.0, kt=1.5e5, gt=20.0)
DEM_USER_DT = 2e-4


def dem_box_setup(n=256, seed=0, rolling_mode="none",
                  force_model="mat_based", **system_kw):
    """tests/test_dem.py's ``make_system`` on its 1 m box (r = 5 cm, ρ =
    2500, E = 5e6, ν 0.3, e 0.4, μ 0.5, walls alike) with ``DEMSystem``'s
    defaults unless ``system_kw`` says otherwise; with rolling, μ_r 0.2
    (walls 0.1); with the user model, ``DEM_USER_MAT`` at dt 2e-4.  ``n``
    particles on a 0.102 m lattice jittered by ±2 %, with velocities
    (σ 1 m/s) and spins (σ 10 rad/s) from ``seed``, so that pairs and the
    floor touch in the first cycle.  Returns the ``DEMSystem`` arguments,
    the two materials and (pts, vel, omega) as float32 numpy arrays."""
    system = dict(radius=0.05, density=2500.0, box=((0, 0, 0), (1, 1, 1)),
                  rolling_mode=rolling_mode, force_model=force_model,
                  **system_kw)
    mat, wall = dict(DEM_BOX_MAT), dict(DEM_BOX_MAT)
    if rolling_mode != "none":
        mat["mu_r"], wall["mu_r"] = DEM_MU_R, DEM_WALL_MU_R
    if force_model == "user":
        mat.update(DEM_USER_MAT)
        wall.update(DEM_USER_MAT)
        system.setdefault("dt", DEM_USER_DT)
    rng = np.random.default_rng(seed)
    pts = grid_sample_box((0.05, 0.05, 0.05), (0.95, 0.95, 0.6), 0.102,
                          jitter=0.02, seed=seed + 1)[:n]
    vel = rng.normal(0.0, 1.0, pts.shape)
    omega = rng.normal(0.0, 10.0, pts.shape)
    return dict(system=system, material=mat, wall_material=wall,
                arrays=tuple(a.astype(np.float32) for a in (pts, vel, omega)))


def dem_system_of(setup, device=None, dtype=torch.float32):
    """The port's ``DEMSystem`` of a :func:`dem_box_setup` with its
    particles created (spins set), on ``device`` (the card by default)."""
    sys_ = DEMSystem(**setup["system"], dtype=dtype,
                     device=device or DEV)
    sys_.set_material(**setup["material"])
    sys_.set_wall_material(**setup["wall_material"])
    pts, vel, omega = setup["arrays"]
    sys_.create_particles(pts, vel=vel)
    sys_.state = sys_.state.replace(omega=torch.as_tensor(
        omega, dtype=dtype, device=sys_.device))
    return sys_


def dem_wall_setup(rolling_mode, wheel=True, seed=5):
    """Phase 9's five-kind walls (a conveyor floor, a z-cylinder, a
    spherical obstacle, a cone and, with ``wheel``, a sinking spinning
    wheel) around five_kind_scene's 120 particles, on a ``DEMSystem`` of
    r = 5 cm over the 0.52 m cube (its params and grid; the walls replace
    its box; 16 a cell): multi-step friction, ``rolling_mode`` with μ_r
    0.2 (walls 0.1), dt 2e-4, velocities (σ 0.5 m/s) and spins (σ 20
    rad/s) from
    ``seed``."""
    walls = five_kind_walls()
    if not wheel:
        walls.pop("wheels")
    _, _, _, pts, _ = five_kind_scene()
    rng = np.random.default_rng(seed)
    mat = dict(DEM_BOX_MAT, mu_r=DEM_MU_R)
    wall = dict(DEM_BOX_MAT, mu_s=0.3, mu_r=DEM_WALL_MU_R)
    return dict(system=dict(radius=0.05, density=2500.0,
                            box=((0, 0, 0), (0.52, 0.52, 0.52)), dt=2e-4,
                            rolling_mode=rolling_mode, rebuild_every=4,
                            max_per_cell=16),
                material=mat, wall_material=wall, walls=walls,
                arrays=(pts.astype(np.float32),
                        rng.normal(0.0, 0.5, pts.shape).astype(np.float32),
                        rng.normal(0.0, 20.0, pts.shape).astype(np.float32)))


def dem_wall_run(setup, device, n_cycles=DEM_CYCLES):
    """``make_advance_fn`` over the walls of a :func:`dem_wall_setup`:
    ``(state, overflow)`` after ``n_cycles``."""
    sys_ = DEMSystem(**setup["system"], device=device)
    sys_.set_material(**setup["material"])
    sys_.set_wall_material(**setup["wall_material"])
    sys_._build()
    bcs = convert.dem_boundaries_from_numpy(setup["walls"]).to(device)
    pts, vel, omega = setup["arrays"]
    state = make_dem_state(sys_.params, bcs, pts, vel, omega, device=device)
    return make_advance_fn(sys_.params, bcs, sys_.grid, device=device)(
        state, n_cycles)


def ramp_mesh_setup(n=200, seed=3):
    """A 0.6 m square of two triangles on a frame at (0.2, 0.2, 0.3),
    tilted 0.4 rad about y, moving at (0.1, 0, −0.05) m/s and turning at
    0.3 rad/s about y, inside tests/test_dem.py's 1 m box; ``n`` particles
    of r = 5 cm with their centres 0.3 r … 1.2 r above its face (some past
    its edges; a centre on the face would leave the normal to rounding),
    with velocities (σ 0.5 m/s) and spins (σ 10 rad/s) from ``seed``; the
    world triangles in float64 and the wall material's μ 0.3."""
    rng = np.random.default_rng(seed)
    verts = np.array([[0.0, 0.0, 0.0], [0.6, 0.0, 0.0], [0.6, 0.6, 0.0],
                      [0.0, 0.6, 0.0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    a = 0.4
    rot = np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0], np.float32)
    frame = dict(frame_pos=np.array([0.2, 0.2, 0.3], np.float32),
                 frame_rot=rot,
                 frame_vel=np.array([0.1, 0.0, -0.05], np.float32),
                 frame_omega=np.array([0.0, 0.3, 0.0], np.float32))
    R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                  [-np.sin(a), 0.0, np.cos(a)]])
    world = [frame["frame_pos"] + verts[faces[:, k]] @ R.T for k in range(3)]
    normal = R @ np.array([0.0, 0.0, 1.0])
    uv = rng.uniform(-0.05, 0.65, (n, 2))
    h = rng.uniform(0.3, 1.2, (n, 1)) * 0.05
    pts = frame["frame_pos"] + np.c_[uv, np.zeros(n)] @ R.T + h * normal
    return dict(system=dict(radius=0.05, density=2500.0,
                            box=((0, 0, 0), (1, 1, 1))),
                material=dict(DEM_BOX_MAT),
                wall_material=dict(DEM_BOX_MAT, mu_s=0.3),
                verts=verts, faces=faces, frame=frame, world=world,
                arrays=(pts.astype(np.float32),
                        rng.normal(0.0, 0.5, (n, 3)).astype(np.float32),
                        rng.normal(0.0, 10.0, (n, 3)).astype(np.float32)))


def ramp_mesh_forces(setup, device):
    """``sphere_mesh_forces`` of a :func:`ramp_mesh_setup` on ``device``:
    (forces on the particles, torques, force on the mesh, torque on the
    mesh), and the fullest cell's triangle count."""
    sys_ = DEMSystem(**setup["system"], device=device)
    sys_.set_material(**setup["material"])
    sys_.set_wall_material(**setup["wall_material"])
    sys_._build()
    mesh = make_triangle_mesh(setup["verts"], setup["faces"], device=device)
    mesh = mesh.replace(**{k: torch.as_tensor(v, device=device)
                           for k, v in setup["frame"].items()})
    bins, most = bin_triangles_numpy(sys_.grid, setup["world"], cap=8,
                                     margin=0.05, device=device)
    pos, vel, omega = (torch.as_tensor(a, device=device)
                       for a in setup["arrays"])
    return sphere_mesh_forces(sys_.params, sys_.grid, bins, mesh, pos, vel,
                              omega), most


def granular_params():
    """tests/test_granular_terrain.py's bed material and step: r = 1 cm,
    ρ = 2500, E = 2e6, ν 0.3, e 0.4, μ 0.6, μ_r 0.1 (walls alike), dt =
    2e-5, 16 neighbours, 8 a cell, 20 substeps an outer step, single-step
    friction, Schwartz rolling, centred differences; r, the mass, gravity
    and dt rounded to float32 as the test's arrays hold them (its material
    is Python floats)."""
    r = 0.01
    mat = DEMMaterial(youngs=2e6, poisson=0.3, restitution=0.4, mu_s=0.6,
                      mu_r=0.1)
    return DEMParams(radius=f32(r), mass=f32(2500.0 * 4 / 3 * np.pi * r ** 3),
                     material=mat, wall_material=mat,
                     gravity=(0.0, 0.0, f32(-9.81)), dt=f32(2e-5),
                     max_neighbors=16, max_per_cell=8, rebuild_every=20,
                     friction_mode="single_step", rolling_mode="schwartz",
                     integrator="centered_difference")


def granular_rig(device=None, bed=(0.5, 0.14), depth=0.06, params=None,
                 drop=0.0):
    """tests/test_granular_terrain.py's coupled wheel on the port: a 3 kg
    wheel (R = 8 cm, w = 5 cm) pre-sunk 5 mm into a carved crater of a
    ``bed`` × ``depth`` bed (and started ``drop`` lower than that, into
    the crater's wall), a drive torque of 0.35 N·m about y after 0.06 s
    and a lateral damper, on ``device`` (the card by default)."""
    dev = torch.device(device or DEV)
    params = params or granular_params()
    r = params.radius
    R_w, W_w = 0.08, 0.05
    x0 = 0.14
    z0 = depth + R_w - 0.005

    def carve(pts):
        dxz = pts[:, [0, 2]] - np.array([x0, z0])
        in_r = np.linalg.norm(dxz, axis=1) < (R_w + r)
        in_y = np.abs(pts[:, 1] - bed[1] / 2) < (W_w / 2 + r)
        return ~(in_r & in_y)

    terrain, grid, bcs = make_granular_terrain_state(
        params, bed, depth, R_w, W_w, n_wheels=1, carve_fn=carve,
        device=dev)
    bld = SystemBuilder(device=dev)
    bld.set_gravity((0, 0, -9.81))
    wheel = bld.add_body(mass=3.0, inertia=(0.01, 0.015, 0.01),
                         pos=(x0, bed[1] / 2, z0 - drop))
    model, bodies = bld.finalize()

    def drive(t, b):
        f = torch.zeros((model.n_bodies, 3), device=dev)
        tau = torch.zeros((model.n_bodies, 3), device=dev)
        tau[wheel, 1] += torch.where(t > 0.06, 0.35, 0.0)
        f[wheel, 1] += -20.0 * b.v[wheel, 1]
        return f, tau

    adv = make_granular_advance_fn(model, params, bcs, grid,
                                   n_substeps=params.rebuild_every,
                                   wheel_bodies=[wheel], f_ext_fn=drive,
                                   device=dev)
    state = GranularFSIState(bodies=bodies, terrain=terrain,
                             time=torch.zeros((), device=dev))
    return dict(params=params, adv=adv, state=state, wheel=wheel, x0=x0,
                z0=z0, depth=depth, R_w=R_w, grid=grid, bcs=bcs,
                model=model, drive=drive)


def granular_rig_check(rig, state, ovf, what):
    """tests/test_granular_terrain.py's assertions after its 550 outer
    steps: no overflow, the wheel held up by the bed and settled near its
    start, spun up and moved forward, the particles in the box and
    finite.  Returns (z, x, ω_y) of the wheel."""
    require(int(ovf) == 0, f"{what}: overflow {int(ovf)}")
    w = rig["wheel"]
    zw, xw = float(state.bodies.x[w, 2]), float(state.bodies.x[w, 0])
    wy = float(state.bodies.w[w, 1])
    require(rig["depth"] + rig["R_w"] - 0.03 < zw < rig["z0"] + 0.01,
            f"{what}: wheel z {zw}")
    require(wy > 1.2, f"{what}: wheel spin {wy}")
    require(xw > rig["x0"] + 0.005, f"{what}: wheel x {xw}")
    p = state.terrain.pos
    require(float(p[:, 2].min()) > -0.01 and bool(torch.isfinite(p).all()),
            f"{what}: particles out of the box or non-finite")
    return zw, xw, wy


def dem_state_close(got, ref, what, x_tol=DEM_X_TOL, v_tol=DEM_V_TOL,
                    w_tol=DEM_W_TOL):
    """Positions, velocities and spins of two ``DEMState``s within their
    tolerances; the largest ratio of an error to its tolerance."""
    return max(check_close(got.pos, ref.pos, what=f"{what} x", **x_tol)[1],
               check_close(got.vel, ref.vel, what=f"{what} v", **v_tol)[1],
               check_close(got.omega, ref.omega, what=f"{what} w",
                           **w_tol)[1])


def dem_state_equal(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in (
        "pos", "vel", "omega", "tan_disp", "bc_tan_disp", "time")) \
        and torch.equal(a.nbr.idx, b.nbr.idx)


def dem_card_vs_cpu():
    """Phase 16 (a): each case on the card against the port on the CPU
    after 3 cycles (the granular rig after 20 outer steps), and repeated
    on the card bit for bit.  The CPU runs take one thread: at a few
    hundred particles a thread pool costs more than it gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return dem_cases()
    finally:
        torch.set_num_threads(threads)


def dem_cases():
    """The cases of :func:`dem_card_vs_cpu`."""
    worst = {}

    def case(name, run):
        t0 = time.perf_counter()
        ref = run("cpu")
        got = run(DEV)
        again = run(DEV)
        require(int(got[1]) == int(ref[1]) == 0, f"{name}: overflow")
        require(dem_state_equal(got[0], again[0]),
                f"{name}: two runs on the card differ")
        worst[name] = dem_state_close(got[0], ref[0], name)
        print(f"DEM system {name}: card vs CPU {worst[name]:.3f} of the "
              f"tolerance, two card runs equal bit for bit "
              f"({time.perf_counter() - t0:.2f} s)")

    for integrator in DEM_INTEGRATORS:
        for friction in DEM_FRICTION:
            setup = dem_box_setup(integrator=integrator,
                                  friction_mode=friction)
            case(f"{integrator}/{friction}", lambda dev, s=setup: (
                lambda sy: sy._advance(sy.state, DEM_CYCLES))(
                    dem_system_of(s, dev)))
    for rolling in DEM_ROLLING:
        setup = dem_wall_setup(rolling, wheel=False)
        case(f"{rolling} rolling, four wall kinds",
             lambda dev, s=setup: dem_wall_run(s, dev))
    setup = dem_box_setup(force_model="user")
    case("user force model", lambda dev: (
        lambda sy: sy._advance(sy.state, DEM_CYCLES))(
            dem_system_of(setup, dev)))

    setup = ramp_mesh_setup()
    (ref, most) = ramp_mesh_forces(setup, "cpu")
    got, _ = ramp_mesh_forces(setup, DEV)
    again, _ = ramp_mesh_forces(setup, DEV)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            "sphere_mesh_forces: two card runs differ")
    f_scale = float(ref[0].abs().max())
    require(f_scale > 0 and int((ref[0].abs().sum(1) > 0).sum()) > 10,
            "sphere_mesh_forces: too few contacts")
    r = max(check_close(g, c, 1e-4, 1e-5 * f_scale * s,
                        f"sphere_mesh_forces {k}")[1]
            for g, c, k, s in zip(got, ref, ("f", "tau", "F", "T"),
                                  (1.0, 0.05, 1.0, 1.0)))
    print(f"sphere_mesh_forces, ramp of 2 triangles, 200 particles ("
          f"{most} triangles in the fullest cell): card vs CPU {r:.3f} of "
          f"the tolerance "
          f"(rtol 1e-4, atol 1e-5 of the largest force), two card runs "
          f"equal bit for bit")

    t0 = time.perf_counter()
    (ref, ovf_c), (got, ovf_g), (again, _) = (
        (lambda rig: rig["adv"](rig["state"], GRANULAR_PARITY_OUTER))(
            granular_rig(dev, drop=GRANULAR_DROP))
        for dev in ("cpu", DEV, DEV))
    require(int(ovf_c) == int(ovf_g) == 0, "granular rig: overflow")
    require(dem_state_equal(got.terrain, again.terrain)
            and all(torch.equal(getattr(got.bodies, k),
                                getattr(again.bodies, k)) for k in "xqvw"),
            "granular rig: two card runs differ")
    r = max(dem_state_close(got.terrain, ref.terrain, "granular bed"),
            check_close(got.bodies.x, ref.bodies.x, what="granular wheel x",
                        **DEM_X_TOL)[1],
            check_close(got.bodies.v, ref.bodies.v, what="granular wheel v",
                        **DEM_V_TOL)[1],
            check_close(got.bodies.w, ref.bodies.w, what="granular wheel w",
                        **DEM_W_TOL)[1])
    print(f"granular rig ({ref.terrain.n} particles, the wheel started "
          f"{GRANULAR_DROP} m into the crater's wall), "
          f"{GRANULAR_PARITY_OUTER} outer steps of 20 substeps: card vs "
          f"CPU {r:.3f} of the tolerance, two card runs equal bit for bit "
          f"({time.perf_counter() - t0:.2f} s)")
    return worst


def dem_gather_scene(n_target=1_000_000):
    """bench.py's pinned scene as its gather branch builds it
    (bench.py:84-110, :133-135, :155-157): bench_params with 12
    neighbours, 16 a cell, skin 0.3, 100 substeps a cycle, cells of two
    lattice spacings over the whole box from the origin, every float
    rounded to float32 as the JAX package holds it."""
    params, bcs, grid, pts, _ = bench_engine_scene("xla", n_target)
    params = dem_as_float32(replace(params, max_neighbors=12,
                                    max_per_cell=16, skin=0.3))
    return params, bcs, grid, pts


def dem_as_float32(params):
    """``params`` with every float rounded to float32."""
    def mat(m):
        return replace(m, **{f.name: f32(getattr(m, f.name))
                             for f in dataclasses.fields(m)})

    return replace(params, radius=f32(params.radius),
                   mass=f32(params.mass), dt=f32(params.dt),
                   material=mat(params.material),
                   wall_material=mat(params.wall_material),
                   gravity=tuple(f32(g) for g in params.gravity))


def dem_profile_cycle(params, bcs, grid, state):
    """One cycle under the profiler as ``make_advance_fn`` runs it, the
    rebuild and the substeps' graph replay in two windows (the graph
    captured before them): ``{part: (kernels, device ms)}`` and the
    state."""
    out = {}
    box = {"state": state}
    block = SubstepBlock(params, params.rebuild_every)
    block(rebuild_neighbors(params, grid, state), bcs)

    def rebuild():
        box["state"] = rebuild_neighbors(params, grid, box["state"])

    def substeps():
        box["state"] = block(box["state"], bcs)[0]

    for part, fn in (("rebuild", rebuild), ("substeps", substeps)):
        _, events = device_events(fn)
        out[part] = (len(events),
                     sum(e.time_range.elapsed_us() for e in events) / 1e3)
    return out, box["state"]


def dem_check_box(state, lo, hi, what):
    """Finite, and every particle inside the box by at most 0.25 r."""
    require(all(bool(torch.isfinite(a).all()) for a in
                (state.pos, state.vel, state.omega)),
            f"{what}: non-finite state")
    lo = torch.as_tensor(lo, dtype=state.pos.dtype, device=state.pos.device)
    hi = torch.as_tensor(hi, dtype=state.pos.dtype, device=state.pos.device)
    out = torch.maximum(lo - state.pos, state.pos - hi).max()
    require(float(out) < 0.0, f"{what}: a particle left the box "
            f"({float(out)} m past a wall)")


def dem_gather_full_width(card, n_target=1_000_000):
    """Phase 16 (b): bench.py's gather engine at 1,000,000 spheres through
    ``make_dem_state`` and ``make_advance_fn``: 1 warm-up and 2 timed
    cycles of 100 substeps, phase 2's checks, particle-steps/s beside
    phase 2's rate, peak memory, and one profiled cycle."""
    params, bcs, grid, pts = dem_gather_scene(n_target)
    n = len(pts)
    torch.cuda.reset_peak_memory_stats()
    adv = make_advance_fn(params, bcs, grid, device=DEV)
    state = make_dem_state(params, bcs, pts, device=DEV)
    st, ovf = adv(state, 1)
    require(int(ovf) == 0, f"gather DEM warm-up overflow {int(ovf)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, ovf = adv(st, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t_sim = 3 * params.rebuild_every * params.dt
    gaps, mean_v = check_full_width(params, bcs, pts, st.pos, st.vel,
                                    st.omega, ovf, t_sim, "gather DEM")
    steps = 2 * params.rebuild_every
    rate = n * steps / wall
    most = int(st.nbr.valid.sum(1).max())
    ph2 = RATES.get("dem")
    print(f"gather DEM ({n} spheres, grid {grid.dims}, 16 a cell, 12 "
          f"neighbours, most in a row {most}): {steps} substeps in "
          f"{wall:.4f} s = {rate:.6e} particle-steps/s (host clock), peak "
          f"device memory {peak:.3f} GiB, on {card}; phase 2's K1: "
          + (f"{ph2:.6e} particle-steps/s" if ph2 else "not run in this call")
          + f"; overflow 0, finite, wall gap min {gaps[0]:.4f} r at the "
          f"start and {gaps[1]:.4f} r at the end, mean v {mean_v.tolist()} "
          f"(free fall {-G * t_sim:.6e})")
    parts, _ = dem_profile_cycle(params, bcs.to(DEV), grid, st)
    total = sum(ms for _, ms in parts.values())
    print("gather DEM, one profiled cycle: " + "; ".join(
        f"{k} {n_k} kernels {ms:.4f} ms" for k, (n_k, ms) in parts.items())
        + f"; {total:.4f} ms of device time in all against "
        f"{wall / 2 * 1e3:.4f} ms a cycle by the host clock")
    RATES["gather_dem"] = rate


def dem_system_full_width(card, n_target=1_000_000):
    """Phase 16 (c): the same spheres and box through ``DEMSystem`` with
    its own defaults (multi-step friction, centred differences, dt from
    ``suggest_step_size``, 8 substeps a cycle, skin 0.2), 12 neighbours
    and 16 a cell: two timed ``advance`` calls of one cycle each, so that
    the friction history migrates at 1,000,000 particles."""
    params, bcs, _, pts = dem_gather_scene(n_target)
    lo = bcs.planes.point[0].tolist()
    hi = bcs.planes.point[3].tolist()
    torch.cuda.reset_peak_memory_stats()
    sys_ = DEMSystem(radius=0.005, density=2500.0, box=(lo, hi),
                     max_neighbors=12, max_per_cell=16, device=DEV)
    mat = dict(youngs=1e7, poisson=0.3, restitution=0.5, mu_s=0.5)
    sys_.set_material(**mat)
    sys_.set_wall_material(**mat)
    sys_.create_particles(pts)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sys_.advance(sys_.dt * 8)        # raises on an overflow
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = sys_.state
    dem_check_box(st, lo, hi, "DEMSystem 1M")
    kept = int((st.tan_disp.abs().sum(-1) > 0).sum())
    n = st.n
    print(f"DEMSystem ({n} spheres, grid {sys_.grid.dims}, dt "
          f"{sys_.dt:.9e} s): two advance calls of one cycle (8 substeps) in "
          f"{walls[0]:.4f} s and {walls[1]:.4f} s = "
          f"{n * 8 / walls[1]:.6e} particle-steps/s for the second (host "
          f"clock), peak device memory {peak:.3f} GiB, on {card}; overflow "
          f"0, finite, inside the box, {kept} pair slots with friction "
          f"history after the second rebuild, KE "
          f"{sys_.kinetic_energy():.6e} J")


# tools/dem_dam_break_reference.py: the JAX demo's outcome (its DEMSystem
# on the CPU, float32): the particle count, dt, and the front x and
# kinetic energy at each of its 12 frames.  The collapse is chaotic: the
# port on the CPU parts from it by up to 0.0388 m and 7.45 % of KE in
# float32, 0.0311 m and 5.86 % in float64; the card is held to twice the
# larger spread
DAM_N = 2380
DAM_DT = 0.00017307966481894255
JAX_DAM_FRONT = (
    0.2896081507205963, 0.3055984675884247, 0.33103010058403015,
    0.3703274726867676, 0.42496493458747864, 0.4906689524650574,
    0.5698563456535339, 0.6337763071060181, 0.6938408017158508,
    0.7541345953941345, 0.8145250678062439, 0.8749155402183533)
JAX_DAM_KE = (
    0.7401580385587351, 0.703752882328482, 1.1512568648439605,
    2.1071879193131196, 2.710841669912518, 2.2476139033282365,
    2.102816303825404, 1.7741079960483939, 1.5552129875993355,
    1.3054796559782105, 1.1409639730806602, 0.9367370157250112)
DAM_FRONT_TOL = 0.08
DAM_KE_RTOL = 0.15


def dem_dam_break_demo(card):
    """Phase 16 (d): demos/demo_dem_dam_break.py on the port's
    ``DEMSystem``, its PLY frames written through
    ``export_particle_sequence``, held to the JAX demo's particle count,
    dt, and front x and kinetic energy at each of its 12 frames."""
    radius = 0.01
    sys_ = DEMSystem(radius=radius, density=2500,
                     box=((0, 0, 0), (1.2, 0.2, 0.4)), rebuild_every=8,
                     max_neighbors=16, device=DEV)
    sys_.set_material(youngs=1e7, restitution=0.4, mu_s=0.5)
    sys_.set_wall_material(youngs=1e7, restitution=0.4, mu_s=0.5)
    pts = hcp_sample_box((0.005, 0.005, 0.005), (0.3, 0.195, 0.3),
                         radius * 1.01)
    sys_.create_particles(pts)
    require(len(pts) == DAM_N and sys_.dt == DAM_DT,
            f"dam break: {len(pts)} particles, dt {sys_.dt!r}; the JAX "
            f"demo has {DAM_N}, {DAM_DT!r}")
    frames, fronts, kes = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(12):
        sys_.advance(0.05)
        frames.append((float(sys_.state.time), sys_.positions.copy()))
        fronts.append(float(frames[-1][1][:, 0].max()))
        kes.append(sys_.kinetic_energy())
    wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as out:
        export_particle_sequence(out, frames)
        files = sorted(os.listdir(out))
        size = sum(os.path.getsize(os.path.join(out, f)) for f in files)
    require(len(files) == 13, f"dam break: {len(files)} files written")
    d_front = max(abs(a - b) for a, b in zip(fronts, JAX_DAM_FRONT))
    r_ke = max(abs(a - b) / b for a, b in zip(kes, JAX_DAM_KE))
    require(d_front <= DAM_FRONT_TOL and r_ke <= DAM_KE_RTOL,
            f"dam break: front x off by {d_front} m (tolerance "
            f"{DAM_FRONT_TOL}), KE by {r_ke} relative (tolerance "
            f"{DAM_KE_RTOL}): fronts {fronts}, KE {kes}")
    n_cycles = int(round(0.05 / (sys_.dt * 8))) * 12
    print(f"DEM dam break demo ({len(pts)} particles, dt {sys_.dt:.6e} s, "
          f"{n_cycles} cycles of 8 substeps): 12 frames in {wall:.3f} s on "
          f"{card}, {len(files)} files ({size} bytes) written; front x "
          f"within {d_front:.4f} m of the JAX demo (tolerance "
          f"{DAM_FRONT_TOL}), KE within {r_ke:.4f} relative (tolerance "
          f"{DAM_KE_RTOL}); last frame t = {frames[-1][0]:.4f} s, front "
          f"{fronts[-1]:.4f} m, KE {kes[-1]:.6e} J")


GRANULAR_PARITY_OUTER = 20
# the wheel started this much lower than the test's rig, into the crater's
# wall, so that the parity runs are coupled from the first substep
GRANULAR_DROP = 0.005
GRANULAR_RIG_OUTER = 550
GRANULAR_BED = (2.0, 0.5)
GRANULAR_BED_DEPTH = 0.1
GRANULAR_BED_OUTER = 200


def granular_terrain_runs(card):
    """Phase 16 (e): tests/test_granular_terrain.py's rig for its 550
    outer steps with its assertions, then the same wheel on a 2.0 × 0.5 ×
    0.1 m bed of r = 5 mm spheres (HCP), timed over 200 outer steps of 20
    substeps after 10 of warm-up."""
    rig = granular_rig(DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, ovf = rig["adv"](rig["state"], GRANULAR_RIG_OUTER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    zw, xw, wy = granular_rig_check(rig, st, ovf, "granular rig")
    sim = GRANULAR_RIG_OUTER * rig["params"].dt * 20
    print(f"granular rig ({st.terrain.n} particles): {GRANULAR_RIG_OUTER} "
          f"outer steps in {wall:.3f} s ({wall / GRANULAR_RIG_OUTER * 1e3:.3f}"
          f" ms an outer step, RTF {wall / sim:.3f}) on {card}; "
          f"tests/test_granular_terrain.py's assertions met: wheel z "
          f"{zw:.5f} m, x {xw:.5f} m, ω_y {wy:.4f} rad/s, overflow 0")

    params = replace(granular_params(), radius=f32(0.005),
                     mass=f32(2500.0 * 4 / 3 * np.pi * 0.005 ** 3))
    rig = granular_rig(DEV, bed=GRANULAR_BED, depth=GRANULAR_BED_DEPTH,
                       params=params)
    st, ovf = rig["adv"](rig["state"], 10)
    require(int(ovf) == 0, "granular bed warm-up: overflow")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, ovf = rig["adv"](st, GRANULAR_BED_OUTER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(int(ovf) == 0, "granular bed: overflow")
    require(all(bool(torch.isfinite(a).all()) for a in
                (st.terrain.pos, st.terrain.vel, st.bodies.x, st.bodies.w)),
            "granular bed: non-finite state")
    ms = wall / GRANULAR_BED_OUTER * 1e3
    sim = GRANULAR_BED_OUTER * params.dt * 20
    w = rig["wheel"]
    print(f"granular bed {GRANULAR_BED[0]} x {GRANULAR_BED[1]} x "
          f"{GRANULAR_BED_DEPTH} m ({st.terrain.n} particles of r = 5 mm, "
          f"grid {rig['grid'].dims}): {GRANULAR_BED_OUTER} outer steps of 20 "
          f"substeps in {wall:.3f} s = {ms:.3f} ms an outer step, RTF "
          f"{wall / sim:.3f}, on {card}; overflow 0, finite; wheel z "
          f"{float(st.bodies.x[w, 2]):.5f} m, ω_y "
          f"{float(st.bodies.w[w, 1]):.4f} rad/s")
    RATES["granular_bed_ms"] = ms


def dem_system_main_path(card):
    """Phase 16: the DEM system on the neighbour list: (a) card against
    CPU, (b) bench.py's gather engine at 1 M spheres, (c) ``DEMSystem``
    with its defaults at 1 M, (d) the DEM dam-break demo, (e) granular
    terrain."""
    for part, fn in (("a", lambda c: dem_card_vs_cpu()),
                     ("b", dem_gather_full_width),
                     ("c", dem_system_full_width),
                     ("d", dem_dam_break_demo),
                     ("e", granular_terrain_runs)):
        t0 = time.perf_counter()
        fn(card)
        print(f"phase 16 ({part}) took {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------- phase 17

# The JAX run of `JAX_PLATFORMS=cpu python tools/m113_reference.py --port`:
# chrono_tpu.models.m113.m113_acceleration_run (3,000 steps of 2 ms at
# 6,000 N·m a sprocket from rest on flat ground), the chassis speed after
# steps 0, 50, ..., 2,950, and the Marder check of tests/test_model_decks.py
# (600 steps at 16,000 N·m) after its last step.
M113_H = 2e-3
M113_STEPS = 3000
M113_EAGER_STEPS = 200
JAX_M113_SPEEDS = (
    0.0, 0.37735089659690857, 0.7564682960510254, 1.125618577003479,
    1.4963375329971313, 1.8706961870193481, 2.247736930847168,
    2.6250123977661133, 3.00134539604187, 3.377012252807617,
    3.7525599002838135, 4.128264427185059, 4.504120349884033,
    4.880021572113037, 5.255898952484131, 5.631743431091309,
    6.007568359375, 6.383402347564697, 6.7592453956604, 7.1350884437561035,
    7.510931491851807, 7.88677453994751, 8.262618064880371,
    8.638461112976074, 9.014304161071777, 9.39014720916748,
    9.765990257263184, 10.141833305358887, 10.51767635345459,
    10.893519401550293, 11.269362449645996, 11.6452054977417,
    12.021048545837402, 12.396891593933105, 12.772734642028809,
    13.148577690124512, 13.524420738220215, 13.900263786315918,
    14.276106834411621, 14.651949882507324, 15.027792930603027,
    15.40363597869873, 15.779479026794434, 16.15532112121582,
    16.531164169311523, 16.907007217407227, 17.28285026550293,
    17.658693313598633, 18.034536361694336, 18.41037940979004,
    18.786222457885742, 19.162065505981445, 19.53790855407715,
    19.91375160217285, 20.289594650268555, 20.665437698364258,
    21.04128074645996, 21.417123794555664, 21.792966842651367,
    22.16880989074707,
)
JAX_MARDER_SPEED = 4.562633514404297
MARDER_STEPS, MARDER_TORQUE = 600, 16000.0
# The same tool's port on the CPU: float32 within 2.4e-7 m/s of the JAX
# speeds, float64 within 8.7e-5 m/s (the float32 floor of the run); the
# Marder's final speed float32 6.3e-4 m/s and float64 1.1e-3 m/s from the
# JAX run's.  The card is held at ten times each floor, rounded up.
M113_SPEED_ATOL = 1e-3
MARDER_SPEED_ATOL = 0.02
# (a): 1,000 MPR pairs card against CPU, in float64 as
# tests/test_torch_mpr.py holds them (its tolerance; the ill-conditioned
# pairs excluded)
MPR_PAIRS = 1000
MPR_TOL = {"gap": 1e-5, "normal": 1e-4, "point": 1e-4}
# cut from 50 when phase 18 came: a float64 step is ~0.4 s on the card
CONVEX_SCENE_STEPS = 25
CONVEX_REPEAT_STEPS = 10
HHT_STEPS = 10
RK4_STEPS = 100
HYDRAULIC_STEPS = 60
# (c): the geared single-pin rig of tests/test_tracked.py's TestSprocketGear.
# A step is 0.83–1.15 s on the card (56,083 kernels: APGD's 300 iterations
# of ~180 launches), so 100 steps would take 115 s: the run was cut to 25
# steps with 20 held to the CPU (64.3 s), and to 8 with 6 held once
# phase 18 came, to keep chip_smoke.py within 1,000 s
RIG_STEPS = 8
RIG_CPU_STEPS = 6


def perturbed(state, seed, scale):
    """``state`` with each float leaf moved by ~``scale`` relative."""
    g = torch.Generator().manual_seed(seed)

    def p(a):
        noise = torch.randn(a.shape, generator=g, dtype=torch.float64)
        return a * (1.0 + scale * noise.to(a.dtype).to(a.device))

    return state.replace(**{f: p(getattr(state, f)) for f in "xqvw"})


def state_cpu(st):
    return BodyState(**{f: getattr(st, f).detach().cpu() for f in "xqvw"})


def within_response(got, ref, resp, what):
    """Each field within the North star's tolerance, its atol widened to
    twice ``resp[field]`` (the reference's own response to perturbations
    of its input) where that is larger; returns the largest error."""
    worst = 0.0
    for f, tol in (("x", POS_TOL), ("q", POS_TOL), ("v", VEL_TOL),
                   ("w", VEL_TOL)):
        worst = max(worst, assert_close(
            getattr(got, f), getattr(ref, f), tol["rtol"],
            max(tol["atol"], 2.0 * resp.get(f, 0.0)), f"{what} {f}"))
    return worst


def response(run, base, seeds=(1, 2)):
    """Largest change of each field of ``run(seed)`` against ``base``."""
    out = {}
    for s in seeds:
        st = run(s)
        for f in "xqvw":
            out[f] = max(out.get(f, 0.0), float(
                (getattr(st, f).double() - getattr(base, f).double()).abs()
                .max()))
    return out


def mpr_random_pairs(n, seed=0):
    """``n`` pairs over the five kinds (each kind against each), rotated,
    touching and separated (tests/test_torch_mpr.py's generator)."""
    rng = np.random.default_rng(seed)
    kind = np.tile(np.arange(5, dtype=np.int32), (2, n // 5 + 1))[:, :n]
    kind[1] = rng.permutation(kind[1])
    pos = rng.uniform(-1.0, 1.0, (2, n, 3)).astype(np.float32)
    q = rng.normal(size=(2, n, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    data = rng.uniform(0.3, 0.8, (2, n, 3)).astype(np.float32)
    verts = rng.uniform(-0.6, 0.6, (2, n, 8, 3)).astype(np.float32)
    return kind, pos, q, data, verts


def mpr_on(device, arrays, pos=None, rot=None):
    kind, pos0, q0, data, verts = arrays
    pos = pos0 if pos is None else pos
    q = q0 if rot is None else rot
    sh = [ConvexShape(*(torch.as_tensor(a[i], device=device)
                        for a in (kind, pos, q, data, verts)))
          for i in (0, 1)]
    return [x.cpu() for x in mpr_contact(*sh)]


def mpr_card_vs_cpu(card):
    """Float64, as tests/test_torch_mpr.py holds the port to JAX: a pair
    is ill-conditioned where the CPU answer itself moves past
    ``MPR_TOL`` when the positions and orientations move by ~1e-9 or
    ~1e-7 (two ways each; the card's rounding differs from the CPU's
    inside the rotations, so orientations are moved too, which the test
    against JAX on the CPU does not need); the others are held at
    ``MPR_TOL``, and the ill-conditioned ones must stay under a
    quarter.  In float32 (the card's own rounding: FMA
    contraction inside a kernel, division by a reciprocal) two card runs
    are held bit for bit and finite."""
    arrays = mpr_random_pairs(MPR_PAIRS)
    a32, b32 = mpr_on(DEV, arrays), mpr_on(DEV, arrays)
    require(all(torch.equal(x, y) for x, y in zip(a32, b32))
            and all(bool(torch.isfinite(x).all()) for x in a32),
            "MPR float32: two card runs differ or are not finite")
    ref32 = mpr_on("cpu", arrays)
    arrays64 = tuple(x.astype(np.float64) if x.dtype == np.float32 else x
                     for x in arrays)
    a = mpr_on(DEV, arrays64)
    require(all(torch.equal(x, y) for x, y in zip(a, mpr_on(DEV, arrays64))),
            "MPR float64: two card runs differ")
    ref = mpr_on("cpu", arrays64)

    def bad(got):
        return ((got[0] - ref[0]).abs() > MPR_TOL["gap"]) | (
            (got[1] - ref[1]).abs().amax(1) > MPR_TOL["normal"]) | (
            (got[2] - ref[2]).abs().amax(1) > MPR_TOL["point"])

    rng = np.random.default_rng(1)
    ill = torch.zeros(MPR_PAIRS, dtype=torch.bool)
    for scale in (1e-9, 1e-9, 1e-7, 1e-7):
        pos = arrays64[1] + scale * rng.normal(size=arrays64[1].shape)
        rot = arrays64[2] + scale * rng.normal(size=arrays64[2].shape)
        rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
        ill |= bad(mpr_on("cpu", arrays64, pos, rot))
    off = bad(a) & ~ill
    require(int(ill.sum()) < MPR_PAIRS // 4 and not bool(off.any()),
            f"MPR card vs CPU: {int(off.sum())} well-conditioned pairs off "
            f"({torch.nonzero(off).flatten().tolist()[:10]}), "
            f"{int(ill.sum())} ill-conditioned")
    keep = ~ill
    errs = [float((x[keep] - y[keep]).abs().max()) for x, y in zip(a, ref)]
    e32 = [float((x - y).abs().max()) for x, y in zip(a32, ref32)]
    print(f"MPR, {MPR_PAIRS} random pairs over the five kinds "
          f"({int((ref[0] < 0).sum())} touching): two card runs bit for "
          f"bit in float32 and float64; float64 card vs CPU on the "
          f"{int(keep.sum())} well-conditioned pairs max |Δgap| "
          f"{errs[0]:.3e}, |Δn| {errs[1]:.3e}, |Δp| {errs[2]:.3e} "
          f"({int(ill.sum())} ill-conditioned, excluded); float32 card vs "
          f"CPU on all pairs |Δgap| {e32[0]:.3e}, |Δn| {e32[1]:.3e}, |Δp| "
          f"{e32[2]:.3e} [{card}]")


def capsule_box_scene(device):
    """tests/test_contact.py's TestConvexNSC: a capsule (axis along world
    x) sunk to z = 0.2 into a ground box."""
    b = SystemBuilder(device=device)
    g = b.add_ground()
    cap = b.add_body(mass=2.0, inertia=(0.1, 0.15, 0.15), pos=(0.0, 0.0, 0.2))
    model, state = b.finalize()
    c = np.cos(np.pi / 4)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    convex = ConvexShapes(
        body=t([g, cap], torch.int32), kind=t([1, 2], torch.int32),
        pos=t([[0.0, 0.0, -0.5], [0.0, 0.0, 0.0]]),
        rot=t([[1.0, 0, 0, 0], [c, 0.0, c, 0.0]]),
        data=t([[10.0, 10.0, 0.5], [0.25, 0.3, 0.0]]),
        verts=t(np.zeros((2, 8, 3))), mu=t([0.5, 0.5]))
    coll = CollisionModel(
        spheres=no_spheres(device), boxes=None, convex=convex,
        grid=GridSpec(origin=(-12.0, -12.0, -2.0), cell_size=1.2,
                      dims=(20, 20, 8)), max_per_cell=8, max_contacts=16)
    return model, coll, state, SolverSettings(
        solver="apgd", max_iter=120, stab_factor=0.2), 2e-3, None


def mesh_ramp_scene(device):
    """tests/test_mesh_contact.py's cylinder (axis along world y) on a mesh
    ramp of two triangles tilted 15°, envelope 0.01."""
    b = SystemBuilder(device=device)
    g = b.add_ground()
    cyl = b.add_body(mass=2.0, inertia=(0.1, 0.1, 0.1), pos=(0.0, 0.0, 0.3))
    model, state = b.finalize()
    ang = np.deg2rad(15)
    verts = [(x * np.cos(ang), y, -x * np.sin(ang))
             for (x, y) in [(-1.5, -1), (1.5, -1), (1.5, 1), (-1.5, 1)]]
    meshes = MeshShapes.from_mesh(g, verts, [(0, 1, 2), (0, 2, 3)], mu=0.1,
                                  device=device)
    c = np.cos(np.pi / 4)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    convex = ConvexShapes(
        body=t([cyl], torch.int32), kind=t([3], torch.int32),
        pos=t(np.zeros((1, 3))), rot=t([[c, c, 0.0, 0.0]]),
        data=t([[0.3, 0.4, 0.0]]), verts=t(np.zeros((1, 8, 3))),
        mu=t([0.1]))
    coll = CollisionModel(
        spheres=no_spheres(device), boxes=None, convex=convex,
        meshes=meshes, grid=GridSpec(origin=(-4, -4, -2), cell_size=1.2,
                                     dims=(8, 8, 6)),
        max_contacts=32, envelope=0.01)
    return model, coll, state, SolverSettings(solver="apgd", max_iter=100), \
        1e-3, None


def no_spheres(device):
    return SphereShapes(body=torch.zeros((0,), dtype=torch.int32,
                                         device=device),
                        offset=torch.zeros((0, 3), device=device),
                        radius=torch.zeros((0,), device=device),
                        mu=torch.zeros((0,), device=device))


def as_float64(obj):
    """The carriers with their float tensors in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: as_float64(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: as_float64(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def convex_scene_run(scene, device, n, seed=None, snap=None):
    """``n`` float64 steps of a convex scene (and the state after ``snap``
    steps); ``seed`` moves its start by ~1e-12 relative."""
    model, coll, state, settings, h, xcf = scene(device)
    model, coll, state = (as_float64(x) for x in (model, coll, state))
    if seed is not None:
        state = perturbed(state, seed, 1e-12)
    t = torch.zeros((), dtype=state.x.dtype, device=device)
    at_snap = None
    for k in range(n):
        state, _, _ = nsc_step(model, coll, state, t, h, settings,
                               extra_contacts_fn=xcf)
        t = t + h
        if k + 1 == snap:
            at_snap = state
    return (state, at_snap) if snap else state


def card_vs_cpu(run, what, card):
    """``run(device, seed)`` twice on the card (bit for bit) and on the
    CPU; the card held to the CPU within the North star's tolerances,
    widened by the CPU run's own response to two small perturbations of
    its start where that is larger."""
    a, b = run(DEV, None), run(DEV, None)
    require(state_equal(a, b), f"{what}: two card runs differ")
    ref = run("cpu", None)
    resp = response(lambda s: run("cpu", s), ref)
    err = within_response(state_cpu(a), ref, resp, f"{what} card vs CPU")
    print(f"{what}: two card runs bit for bit; card vs CPU max abs err "
          f"{err:.3e} (the CPU run's own response to perturbations "
          + ", ".join(f"{f} {v:.1e}" for f, v in resp.items()) + f") [{card}]")


def stiff_spring_model(device, k=1e7):
    b = SystemBuilder(device=device)
    b.set_gravity((0, 0, -9.81))
    g = b.add_ground()
    blk = b.add_body(mass=1.0, inertia=(0.1, 0.1, 0.1), pos=(0, 0, -1.0))
    b.add_tsda(g, blk, (0, 0, 0), (0, 0, -1.0), k=k, c=200.0)
    return b.finalize()


def hht_run(device, seed=None, log=None):
    """tests/test_implicit_mbs.py's stiff spring under HHT (α −0.2, 10
    Newton iterations, tol 1e-4) at h = 1e-3."""
    model, state = stiff_spring_model(device)
    if seed is not None:
        state = perturbed(state, seed, 1e-7)
    step = make_hht_mbs_step(model, alpha=-0.2, newton_iters=10, tol=1e-4)
    acc = torch.zeros((model.n_bodies, 6), device=device)
    t = 0.0
    for _ in range(HHT_STEPS):
        out = step(state, acc, t, 1e-3)
        state, acc = out.state, out.acc
        t += float(out.h_used)
        if log is not None:
            log.append((int(out.iterations), float(out.h_used)))
    return state


def gyro_run(device, seed=None):
    b = SystemBuilder(device=device)
    b.set_gravity((0, 0, 0))
    b.add_body(mass=1.0, inertia=(1.0, 1.0, 2.0), omega_local=(0.1, 0.0, 5.0))
    model, state = b.finalize()
    if seed is not None:
        state = perturbed(state, seed, 1e-7)
    t = torch.zeros((), device=device)
    for _ in range(RK4_STEPS):
        state = step_rk4(model, state, t, 1e-3)
        t = t + 1e-3
    return state


def hydraulic_run(device, seed=None, pressures=None):
    """tests/test_external_ode.py's cylinder under a 100 kg load on a rail,
    the valve open for the first half of the run."""
    b = SystemBuilder(device=device)
    b.set_gravity((0, 0, -9.81))
    g = b.add_ground()
    load = b.add_body(mass=100.0, inertia=(1, 1, 1), pos=(0, 0, -0.5))
    b.add_joint("prismatic", load, g, world_pos=(0, 0, -0.5),
                world_axis=(0, 0, 1))
    model, state = b.finalize()
    if seed is not None:
        state = perturbed(state, seed, 1e-7)
    h, t_close = 2e-4, HYDRAULIC_STEPS // 2 * 2e-4
    hp = HydraulicParams(stroke0=torch.tensor(0.7, device=device))
    y, rhs = make_hydraulic_actuator(
        model, g, load, (0, 0, -1.2), (0, 0, 0), hp,
        lambda t: torch.where(t < t_close, 0.8, 0.0))
    step = make_ode_coupled_step(model, rhs, h)
    t = torch.zeros((), device=device)
    for _ in range(HYDRAULIC_STEPS):
        state, y, _ = step(state, y, t)
        t = t + h
    if pressures is not None:
        pressures.append(y.cpu())
    return state


def integrators_card_vs_cpu(card):
    logs = {}
    for dev in (DEV, "cpu"):
        logs[str(dev)] = []
        hht_run(dev, log=logs[str(dev)])
    require(logs[str(DEV)] == logs["cpu"],
            f"HHT Newton iterations / h_used, card {logs[str(DEV)]} vs CPU "
            f"{logs['cpu']}")
    print(f"HHT, stiff spring, {HHT_STEPS} steps: Newton iterations and "
          f"h_used a step equal on card and CPU "
          f"({[n for n, _ in logs['cpu']]}, h_used "
          f"{sorted({h for _, h in logs['cpu']})})")
    card_vs_cpu(lambda d, s: hht_run(d, s), f"HHT stiff spring, "
                f"{HHT_STEPS} steps", card)
    card_vs_cpu(gyro_run, f"RK4 gyroscope, {RK4_STEPS} steps", card)
    p = []
    card_vs_cpu(lambda d, s: hydraulic_run(d, s, p if s is None else None),
                f"hydraulic actuator, {HYDRAULIC_STEPS} steps", card)
    require(torch.equal(p[0], p[1]), "hydraulic: two card runs' pressures")
    err = assert_close(p[0], p[2], 1e-4, 1e-4 * 1e7, "hydraulic pressures")
    print(f"hydraulic actuator: chamber pressures card vs CPU max abs err "
          f"{err:.3e} Pa of {float(p[2].abs().max()):.6e} [{card}]")


def convex_card_vs_cpu(card):
    """(a): MPR pairs, the convex scenes, HHT, RK4 and the actuator.  The
    convex scenes are held card against CPU in float64: in float32 the
    mesh ramp's cylinder, lying across its two triangles' shared edge,
    flips a manifold point between the faces at the rounding floor (~2e-4
    m in 50 steps, the card against the CPU).  A scene's eager step is
    ~0.4 s on the card (APGD's ~180 launches an iteration, 100–120
    iterations), so the bit-for-bit repeat runs its first
    ``CONVEX_REPEAT_STEPS`` steps."""
    t0 = time.perf_counter()
    mpr_card_vs_cpu(card)
    n, n2 = CONVEX_SCENE_STEPS, CONVEX_REPEAT_STEPS
    for name, scene in (("capsule on box", capsule_box_scene),
                        ("cylinder on mesh ramp", mesh_ramp_scene)):
        print(f"  (a) {time.perf_counter() - t0:.1f} s so far")
        what = f"{name}, {n} nsc_steps in float64"
        a, a_snap = convex_scene_run(scene, DEV, n, snap=n2)
        require(state_equal(a_snap, convex_scene_run(scene, DEV, n2)),
                f"{what}: two card runs differ")
        ref = convex_scene_run(scene, "cpu", n)
        resp = response(
            lambda s, sc=scene: convex_scene_run(sc, "cpu", n, s), ref)
        err = within_response(state_cpu(a), ref, resp, f"{what} card vs CPU")
        print(f"{what}: the first {n2} steps of two card runs bit for bit; "
              f"card vs CPU max abs err {err:.3e} (the CPU run's own "
              f"response to 1e-12 perturbations " + ", ".join(
                  f"{f} {v:.1e}" for f, v in resp.items()) + f") [{card}]")
    print(f"  (a) {time.perf_counter() - t0:.1f} s so far")
    integrators_card_vs_cpu(card)


def m113_eager_samples(n, device):
    """``n`` eager ``tracked_step``s of the M113 run, sampled as
    ``m113_acceleration_run`` samples."""
    veh, state = build_m113(device=device)
    tq = torch.full((2,), 6000.0, device=device)
    flat = flat_terrain(0.0)
    out = []
    for k in range(n):
        state = tracked_step(veh, state, tq, flat, M113_H).state
        if k % 50 == 0:
            out.append(state.v[veh.chassis, 0].reshape(1))
    return torch.cat(out).cpu().numpy()


def m113_full(card):
    """(b): the acceleration run through a graph of ``tracked_step``."""
    m113_acceleration_run(n_steps=10, device=DEV)
    (_, _), t_setup = mbs_timed(
        lambda: m113_acceleration_run(n_steps=0, device=DEV))
    (times, v1), t_run = mbs_timed(lambda: m113_acceleration_run(device=DEV))
    _, v2 = m113_acceleration_run(device=DEV)
    require(np.array_equal(v1, v2), "M113: two graph runs differ")
    _, vg = m113_acceleration_run(n_steps=M113_EAGER_STEPS, device=DEV)
    ve, t_eager = mbs_timed(lambda: m113_eager_samples(M113_EAGER_STEPS,
                                                       DEV))
    eq = np.array_equal(vg, ve)
    rel = float(np.abs(vg - ve).max() / max(np.abs(ve).max(), 1e-30))
    require(eq or rel <= DLC_REPLAY_RTOL, f"M113 graph vs eager: {rel}")
    err = float(np.abs(v1 - np.asarray(JAX_M113_SPEEDS)).max())
    require(err <= M113_SPEED_ATOL and len(v1) == len(JAX_M113_SPEEDS),
            f"M113 vs the JAX run: max |Δv| {err}")
    veh, state = build_m113(device=DEV)
    tq = torch.full((2,), 6000.0, device=DEV)
    step = lambda: tracked_step(veh, state, tq, flat_terrain(0.0), M113_H)
    step()
    _, events = device_events(step)
    replay_ms = (t_run - t_setup) / M113_STEPS * 1e3
    sim_s = M113_STEPS * M113_H
    RATES["m113_ms_step"] = replay_ms
    print(f"M113 acceleration, {M113_STEPS} steps of {M113_H} s at 6000 N·m "
          f"a sprocket through the graph: {replay_ms:.4f} ms/step replayed "
          f"(the call {t_run:.3f} s with build, warm-up and capture "
          f"{t_setup:.3f} s), RTF {t_run / sim_s:.4f} (replay alone "
          f"{(t_run - t_setup) / sim_s:.4f}); {len(events)} kernels an eager "
          f"step; final speed {float(v1[-1]):.6f} m/s, JAX "
          f"{JAX_M113_SPEEDS[-1]:.6f}, max |Δv| over the {len(v1)} samples "
          f"{err:.3e} (≤ {M113_SPEED_ATOL}); two graph runs bit for bit; "
          f"{M113_EAGER_STEPS} eager steps "
          f"{'bit for bit' if eq else f'{rel:.3e} rel'} to the graph "
          f"({t_eager / M113_EAGER_STEPS * 1e3:.4f} ms/step eager) [{card}]")
    # build_marder with tests/test_model_decks.py's checks
    veh, state = build_marder(device=DEV)
    tq = torch.full((2,), MARDER_TORQUE, device=DEV)
    for _ in range(MARDER_STEPS):
        state = tracked_step(veh, state, tq, flat_terrain(0.0), M113_H).state
    vx = float(state.v[veh.chassis, 0])
    require(0.5 < vx < 15.0 and bool(torch.isfinite(state.x).all())
            and abs(vx - JAX_MARDER_SPEED) <= MARDER_SPEED_ATOL,
            f"Marder: vx {vx} (JAX {JAX_MARDER_SPEED})")
    print(f"Marder, {MARDER_STEPS} steps at {MARDER_TORQUE} N·m a sprocket: "
          f"vx {vx:.6f} m/s (JAX {JAX_MARDER_SPEED:.6f}, |Δ| ≤ "
          f"{MARDER_SPEED_ATOL}; test window 0.5–15) [{card}]")


def geared_rig(device):
    """tests/test_tracked.py's TestSprocketGear rig: a pitch-matched
    single-pin loop of 24 shoes on a chassis on an x-rail, the sprocket
    driven at 6 rad/s, a slick rim (μ 0.1), the gear on; APGD 300
    iterations, stab 0.05, h = 1e-3."""
    wheel_r, shoe_h, shoe_w = 0.2, 0.05, 0.2
    d = matched_track_span(wheel_r, shoe_h, 24, 16)
    rp = wheel_r + 0.5 * shoe_h + 2e-3
    zc = rp + 0.5 * shoe_h
    bld = SystemBuilder(device=device)
    bld.set_gravity((0, 0, -9.81))
    g = bld.add_ground()
    chassis = bld.add_body(mass=20.0, inertia=(2.0, 4.0, 5.0),
                           pos=(d / 2, 0.0, zc))
    bld.add_joint("prismatic", g, chassis, world_pos=(d / 2, 0.0, zc),
                  world_axis=(1, 0, 0))
    track = add_segmented_track(bld, chassis, (0.0, 0.0, zc), (d, 0.0, zc),
                                wheel_r, n_shoes=24, shoe_h=shoe_h,
                                shoe_w=shoe_w, shoe_mass=0.5)
    bld.add_motor_rotation_speed(chassis, track.sprocket,
                                 world_pos=(d, 0.0, zc), world_axis=(0, 1, 0),
                                 profile=6.0, add_joint=False)
    model, state = bld.finalize()
    gear = make_sprocket_gear(track, state)
    coll = CollisionModel(
        spheres=no_spheres(device), boxes=None,
        convex=track_collision_shapes(
            track, mu_rim=0.1, extra=ground_shape(g, device=device)),
        grid=GridSpec(origin=(-5, -5, -2), cell_size=1.0, dims=(12, 12, 4)),
        max_per_cell=8, max_contacts=96)
    settings = SolverSettings(solver="apgd", max_iter=300, stab_factor=0.05,
                              max_recovery_speed=0.5)
    return model, coll, state, settings, 1e-3, gear, track


def rig_main(card):
    """(c): the geared rig on the card for ``RIG_STEPS`` steps, timed; its
    first 20 steps held against the port on the CPU, one step from each
    card state (the solve stops at 300 iterations far from converged: a
    free-running comparison parts within steps, so each step is held
    within twice the CPU step's own response to two 1e-6 perturbations of
    its state)."""
    model, coll, state, settings, h, gear, track = geared_rig(DEV)
    xcf = lambda s: sprocket_gear_contacts(gear, s)
    t = torch.zeros((), device=DEV)
    states = [state_cpu(state)]
    tvi.reset_host_reads()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = RIG_STEPS
    for k in range(n):
        state, contacts, info = nsc_step(model, coll, state, t, h, settings,
                                         extra_contacts_fn=xcf)
        t = t + h
        if k < RIG_CPU_STEPS:
            states.append(state_cpu(state))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads = tvi.host_reads()
    _, events = device_events(lambda: nsc_step(
        model, coll, state, t, h, settings, extra_contacts_fn=xcf))
    sh = state.x[track.shoes].cpu()
    pitch_d = (torch.roll(sh, -1, 0) - sh).norm(dim=1)
    require(bool(torch.isfinite(state.x).all()) and bool(
        ((pitch_d - track.pitch).abs() <= 0.15 * track.pitch).all()),
        f"geared rig: the loop broke (pin distances {pitch_d.tolist()})")
    RATES["rig_ms_step"] = wall / n * 1e3
    print(f"geared single-pin rig (24 shoes, gear on, ω 6 rad/s, μ_rim 0.1, "
          f"APGD 300 iterations), {n} steps on the card: "
          f"{wall / n * 1e3:.3f} ms/step, RTF {wall / (n * h):.3f}, "
          f"{len(events)} kernels a step, {reads / n:.1f} host reads a "
          f"step, {int(contacts.count)} contacts; finite, pin distances "
          f"{float(pitch_d.min()):.5f}–{float(pitch_d.max()):.5f} m "
          f"(pitch {track.pitch:.5f}) [{card}]")
    cm, cc, _, cs, _, cgear, _ = geared_rig("cpu")
    cxcf = lambda s: sprocket_gear_contacts(cgear, s)
    worst = 0.0
    for k in range(RIG_CPU_STEPS):
        tk = torch.full((), k * h)
        one = lambda s: nsc_step(cm, cc, s, tk, h, cs,
                                 extra_contacts_fn=cxcf)[0]
        ref = one(states[k])
        resp = response(lambda s: one(perturbed(states[k], s, 1e-6)), ref)
        worst = max(worst, within_response(states[k + 1], ref, resp,
                                           f"geared rig step {k}"))
    print(f"geared rig, the first {RIG_CPU_STEPS} card steps each stepped "
          f"once on the CPU from the card's state: max abs err "
          f"{worst:.3e}, within twice the CPU step's own response [{card}]")


def tracked_main_path(card):
    """Phase 17: convex contact, tracked vehicles and the other steppers:
    (a) card against CPU, (b) the M113 acceleration run and the Marder,
    (c) the geared track rig."""
    # the CPU references here are small eager steps, which one thread runs
    # faster than eight
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for part, fn in (("a", convex_card_vs_cpu), ("b", m113_full),
                         ("c", rig_main)):
            t0 = time.perf_counter()
            fn(card)
            print(f"phase 17 ({part}) took {time.perf_counter() - t0:.2f} s")
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------- phase 18

# A driving actuation table in the 33-column format of the reference's
# RoboSimian actuation files (time, then limbs 1-4 × joints 1-8, each
# limb's joint 8 the wheel speed in driving mode).  The reference's own
# driving files are not in the repository, so this table is made up: its
# stance was solved here (scipy least squares on the limb kinematics of
# models/robosimian.py) to put limb 1's wheel centre at (0.6, 0.45, 0.7) m
# in the chassis frame with its axle along the chassis y axis; limbs 2-4
# take the same angles, negated on limbs 2 and 4, which mirrors the stance
# across both chassis planes (wheels level within 2e-6 m).  The wheels turn
# at ±0.4 rad/s, signed so that all four roll the robot along +x.  The
# cycle sways joints 1-7 by ±0.05 rad; the start table moves from the zero
# posture into the stance.
RS_STANCE = (0.189091, -0.390387, 0.333116, 0.847825, -0.274183, 1.08432,
             0.245948)
RS_WHEEL_SPEED = 0.4
RS_CYCLE_T = (0.0, 0.25, 0.5, 0.75, 1.0)
RS_SWAY = 0.05


def robosimian_posture():
    """The 32 angles of the table's first row (wheel speeds in the joint-8
    columns)."""
    limbs = []
    for li, sign in enumerate((1.0, -1.0, 1.0, -1.0)):
        wheel = RS_WHEEL_SPEED if li < 2 else -RS_WHEEL_SPEED
        limbs.append([sign * a for a in RS_STANCE] + [wheel])
    return np.asarray(limbs, np.float64).reshape(-1)


def robosimian_tables(directory):
    """Write ``driving_cycle.txt`` and ``driving_start.txt`` into
    ``directory`` and return their paths (cycle, start)."""
    post = robosimian_posture()
    sway = np.zeros(32)
    for li in range(4):
        sway[li * 8:li * 8 + 7] = RS_SWAY * np.cos(np.arange(7) + li)
    cycle = [[t, *(post + np.sin(2 * np.pi * t) * sway)] for t in RS_CYCLE_T]
    start = [[t, *(post * t)] for t in RS_CYCLE_T]
    for row in start:
        row[8::8] = post[7::8]        # the wheels keep their speed
    paths = []
    for name, rows in (("driving_cycle.txt", cycle),
                       ("driving_start.txt", start)):
        path = os.path.join(directory, name)
        np.savetxt(path, np.asarray(rows), fmt="%.9f")
        paths.append(path)
    return tuple(paths)


# (a) demos/demo_industrial_arm.py, whole, at its own sizes
ARM_T, ARM_H, ARM_SETTLE, ARM_SAMPLES, ARM_EVERY = 1.5, 2e-3, 200, 49, 10
ARM_STEPS = int(ARM_T / ARM_H)
# the eager loop that the graphs are held to: the settling steps and the
# first 100 running steps (an eager step is ~18 ms on the card)
ARM_EAGER_STEPS = 100
ARM_WAYPOINTS = ((0.0, 0.3, 1.0, 0.0, 0.7, 0.0),
                 (0.9, 0.5, 1.3, 0.3, 0.9, -0.4),
                 (1.4, 0.7, 1.6, 0.0, 0.9, 0.0))
ARM_VIOLATION = 1e-3
# The JAX run of `JAX_PLATFORMS=cpu python tools/arm_reference.py --port`:
# the final TCP and the tracking error after the demo's 750 steps, float32
# and float64, and the commanded end point.  The float32 run lies 1.2e-7 m
# from the float64 one at the end; the port on the CPU 4.0e-7 m (float32)
# and 1.4e-7 m (float64) from the JAX float32 run.  Mid-run TCP samples
# taken at a knot of the joint programs (t = 0.5 s, 1.0 s) differ by up to
# 3e-4 m between any two runs whose clocks round differently (the programs'
# slope jumps there), so the card is held at the end: ten times the
# largest CPU gap, rounded up.
JAX_ARM_TCP32 = (0.12758204340934753, 0.7397053837776184, 0.3760231137275696)
JAX_ARM_ERR32 = 1.4600096599955427e-07
JAX_ARM_TCP64 = (0.12758192491976336, 0.7397053317792431,
                 0.37602302108304253)
JAX_ARM_ERR64 = 9.527002102776942e-08
JAX_ARM_CMD = (0.12758198380470276, 0.7397052645683289, 0.3760230541229248)
ARM_TCP_ATOL = 5e-6


def arm_scene(device, dtype=torch.float32):
    """The demo's arm, trajectory and joint programs: (model, state, tool
    body, tool offset, commanded end point)."""
    arm = Arm6R.make(H=0.4, L1=0.6, L2=0.5, L3=0.15, device=device)
    poses = [fk_6r(arm, torch.tensor(q, device=device))
             for q in ARM_WAYPOINTS]
    traj = make_trajectory(torch.stack([p for p, _ in poses]),
                           torch.stack([r for _, r in poses]),
                           total_time=ARM_T, law="poly345", device=device)
    progs = joint_programs_from_trajectory(arm, traj, n_samples=ARM_SAMPLES)
    model, state, tool, off = create_arm_6dof(arm, progs, dtype=dtype,
                                              device=device)
    cmd = traj_eval(traj, ARM_T)[0].double().cpu().numpy()
    return model, state, tool, off.to(dtype), cmd


def arm_tcp(state, tool, off):
    return state.x[tool] + Q.qrotate(state.q[tool], off)


def arm_demo_eager(device, dtype=torch.float32, n_run=ARM_STEPS):
    """The demo (its first ``n_run`` running steps) as an eager loop: (TCP
    every 10 steps, final TCP, tracking error), float64 numpy.  ``t`` is a
    device scalar advanced by h, as the graph advances it."""
    model, state, tool, off, cmd = arm_scene(device, dtype)
    settings = SolverSettings(solver="direct")
    t = torch.zeros((), dtype=dtype, device=device)
    for _ in range(ARM_SETTLE):
        state = step_euler_implicit_linearized(model, state, t, ARM_H,
                                               settings)[0]
    tcp = []
    for i in range(n_run):
        state = step_euler_implicit_linearized(model, state, t, ARM_H,
                                               settings)[0]
        t = t + ARM_H
        if i % ARM_EVERY == 0:
            tcp.append(arm_tcp(state, tool, off))
    p = arm_tcp(state, tool, off).double().cpu().numpy()
    return (torch.stack(tcp).double().cpu().numpy(), p,
            float(np.linalg.norm(p - cmd)))


def arm_demo_graph(n_run=ARM_STEPS):
    """The demo (its first ``n_run`` running steps) on the card: the
    settling step and the running step (which also advances ``t``)
    captured into two graphs over the same static buffers and replayed;
    the TCP read every 10 steps.  Returns (model, final state, TCP samples,
    final TCP, tracking error, ms a step of the run with its reads)."""
    model, state, tool, off, cmd = arm_scene(DEV)
    settings = SolverSettings(solver="direct")
    cur = BodyState(**{f: getattr(state, f).clone() for f in "xqvw"})
    t = torch.zeros((), device=DEV)

    def compute():
        return step_euler_implicit_linearized(model, cur, t, ARM_H,
                                              settings)[0]

    def settle():
        new = compute()
        for f in "xqvw":
            getattr(cur, f).copy_(getattr(new, f))

    def run():
        settle()
        t.add_(ARM_H)

    g_settle = capture(settle, compute, DEV)
    g_run = capture(run, compute, DEV)
    for _ in range(ARM_SETTLE):
        g_settle.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    tcp = []
    start.record()
    for i in range(n_run):
        g_run.replay()
        if i % ARM_EVERY == 0:
            tcp.append(arm_tcp(cur, tool, off))
    end.record()
    torch.cuda.synchronize()
    p = arm_tcp(cur, tool, off).double().cpu().numpy()
    return (model, cur, torch.stack(tcp).double().cpu().numpy(), p,
            float(np.linalg.norm(p - cmd)), start.elapsed_time(end) / n_run)


def arm_demo(card):
    """(a): the demo through the graphs, against an eager loop on the card
    and the JAX run's numbers.  Returns the arm's model and final state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model, st, tcp, p, err, ms = arm_demo_graph()
    _, st2, tcp2, _, _, _ = arm_demo_graph()
    require(state_equal(st, st2) and np.array_equal(tcp, tcp2),
            "arm: two graph runs differ")
    _, _, tcp_g, p_g, _, _ = arm_demo_graph(ARM_EAGER_STEPS)
    (tcp_e, p_e, _), t_eager = mbs_timed(
        lambda: arm_demo_eager(DEV, n_run=ARM_EAGER_STEPS))
    same = np.array_equal(tcp_g, tcp_e) and np.array_equal(p_g, p_e)
    rel = float(max(np.abs(tcp_g - tcp_e).max(), np.abs(p_g - p_e).max())
                / np.abs(tcp_e).max())
    require(same or rel <= DLC_REPLAY_RTOL,
            f"arm graph vs eager: TCP {rel} rel")
    d_tcp = float(np.abs(p - np.asarray(JAX_ARM_TCP32)).max())
    d_err = abs(err - JAX_ARM_ERR32)
    viol = mbs_violation(model, st)
    finite = all(bool(torch.isfinite(getattr(st, f)).all()) for f in "xqvw")
    require(finite and viol < ARM_VIOLATION and d_tcp <= ARM_TCP_ATOL
            and d_err <= ARM_TCP_ATOL,
            f"arm: finite {finite}, violation {viol}, final TCP {p} (JAX "
            f"{JAX_ARM_TCP32}), tracking error {err} (JAX {JAX_ARM_ERR32})")
    n_k, dev_ms, _ = mbs_launches_per_step(model, st, SolverSettings(
        solver="direct"))
    print(f"industrial arm demo (6 bodies, 6 angle motors, direct solver), "
          f"{ARM_SETTLE} settling + {ARM_STEPS} steps of {ARM_H} s through "
          f"two captured graphs: {ms:.4f} ms/step (replays and the TCP read "
          f"every {ARM_EVERY} steps), eager loop "
          f"{t_eager / (ARM_SETTLE + ARM_EAGER_STEPS) * 1e3:.4f} ms/step; "
          f"{n_k} "
          f"kernels an eager step ({dev_ms:.4f} ms of device time) [{card}]")
    print(f"industrial arm: two graph runs bit for bit; graph vs eager TCP "
          f"over the settling and the first {ARM_EAGER_STEPS} running steps "
          f"{'bit for bit' if same else f'{rel:.3e} rel'}"
          f"; final TCP {p.tolist()} (JAX float32 {list(JAX_ARM_TCP32)}, max "
          f"|Δ| {d_tcp:.3e} ≤ {ARM_TCP_ATOL}); tracking error {err * 1e3:.4f} "
          f"mm (JAX {JAX_ARM_ERR32 * 1e3:.4f} mm); joint violation "
          f"{viol:.3e} (< {ARM_VIOLATION}); finite [{card}]")
    return model, st


# (b) demos/demo_robosimian_drive.py at full width
RS_H = 2e-3
RS_MAX_ITER = 60
# The JAX run of `JAX_PLATFORMS=cpu python tools/robosimian_reference.py
# --seeds 8`: the chassis advance after the test's 300 and the demo's 500
# steps from rest, and the largest change of it over 8 runs whose start
# state was moved by ~1e-6 relative (APGD stops at its 60 iterations
# unconverged, so the path turns on rounding; the port on the CPU lies
# 3.8e-5 m from the JAX advance at both).  The card is held at four times
# that response.
JAX_RS = {300: (0.10402527451515198, 6.745010614395142e-05),
          500: (0.18001526594161987, 5.206465721130371e-05)}
# the demo's 1 s (500 steps) when its first 50 steps say the run fits the
# budget, else the test's 300.  Phase 18 runs (b) last, with 90 s or what
# is left of the phase's 145 s, whichever is less
RS_STEPS = (300, 500)
RS_BUDGET_S = 90.0
PHASE18_S = 145.0
RS_PROBE = 50


def robosimian_scene(device, directory):
    """The demo's robot from the driving table: (model, state, coll,
    chassis, wheels, wheel speeds)."""
    cycle, _ = robosimian_tables(directory)
    _, posture, _ = gait_programs(cycle, device=device)
    post = posture.reshape(4, 8).copy()
    speeds = 4.0 * post[:, 7]
    post[:, 7] = 0.0
    model, state, coll, chassis, wheels = create_robosimian(
        post.reshape(-1), speeds, device=device)
    return model, state, coll, chassis, wheels, speeds


def robosimian_drive(card, budget_s=RS_BUDGET_S):
    """(b): the demo's drive on the card, held to the locomotion bounds of
    tests/test_robosimian.py and to the JAX run's advance; 500 steps if
    they fit ``budget_s`` seconds, else 300."""
    with tempfile.TemporaryDirectory() as d:
        model, state, coll, chassis, wheels, speeds = robosimian_scene(DEV, d)
    wp = state.x[wheels].cpu()
    require(bool(((wp[:, 2] - WHEEL_RADIUS).abs() <= 1e-5).all())
            and abs(float(wp[0, 0] + wp[1, 0])) < 1e-4
            and abs(float(wp[0, 1] + wp[3, 1])) < 1e-4
            and float(state.x[chassis, 2]) > 0.5,
            f"RoboSimian stance: wheels at {wp.tolist()}")
    settings = SolverSettings(solver="apgd", max_iter=RS_MAX_ITER,
                              stab_factor=0.2)
    x0 = state.x[chassis].clone()
    t = torch.zeros((), device=DEV)
    nsc_step(model, coll, state, t, RS_H, settings)
    tvi.reset_host_reads()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters, n = [], RS_STEPS[-1]
    for k in range(n):
        state, con, info = nsc_step(model, coll, state, t, RS_H, settings)
        t = t + RS_H
        iters.append(info.iterations)
        if k + 1 == RS_PROBE:
            torch.cuda.synchronize()
            per_step = (time.perf_counter() - t0) / RS_PROBE
            n = max((m for m in RS_STEPS if m * per_step <= budget_s),
                    default=RS_STEPS[0])
        if k + 1 == n:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads = tvi.host_reads()
    iters = torch.stack(iters).float()
    wall1, events = device_events(lambda: nsc_step(model, coll, state, t,
                                                   RS_H, settings))
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_name = {}
    for e in events:
        ms_n = by_name.setdefault(e.name, [0.0, 0])
        ms_n[0] += e.time_range.elapsed_us() / 1e3
        ms_n[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    d = (state.x[chassis] - x0).cpu().double()
    h = RS_H
    v_roll = abs(float(speeds[0])) * WHEEL_RADIUS
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in "xqvw")
    upright = abs(float(state.q[chassis, 1]))
    require(finite and 0.5 * v_roll * n * h < float(d[0]) < 1.3 * v_roll * n
            * h and abs(float(d[1])) < 0.2 * abs(float(d[0]))
            and abs(float(d[2])) < 0.05 and upright > 0.99,
            f"RoboSimian: advance {d.tolist()}, upright {upright}, finite "
            f"{finite}")
    jax_advance, jax_response = JAX_RS[n]
    tol = 4 * jax_response
    gap = abs(float(d[0]) - jax_advance)
    require(gap <= tol, f"RoboSimian: advance {float(d[0])} against the JAX "
            f"run's {jax_advance} (± {tol})")
    RATES["robosimian_ms_step"] = wall / n * 1e3
    print(f"RoboSimian drive ({model.n_bodies - 1} moving bodies, "
          f"{sum(m.n for m in model.motors.values())} motors, "
          f"{coll.max_contacts} contact slots; APGD {RS_MAX_ITER} "
          f"iterations, stab 0.2, h = {h}), {n} steps on the card: "
          f"{wall / n * 1e3:.3f} ms/step, RTF {wall / (n * h):.3f}, "
          f"{len(events)} kernels a step ({busy:.3f} ms of device time in a "
          f"{wall1 * 1e3:.3f} ms profiled step: idle "
          f"{1 - busy / (wall1 * 1e3):.3f}), {reads / n:.1f} host reads a "
          f"step, APGD iterations {float(iters.mean()):.1f} a step on "
          f"average, {int(con.count)} contacts at the end [{card}]")
    print("RoboSimian profiled step, top kernels: " + "; ".join(
        f"{name[:60]} {v[0]:.3f} ms / {v[1]}" for name, v in top))
    print(f"RoboSimian: {n} steps, "
          + ("the demo's 1 s" if n == RS_STEPS[-1] else
             f"the test's {n}: the first {RS_PROBE} steps put the demo's "
             f"{RS_STEPS[-1]} at {RS_STEPS[-1] * per_step:.1f} s, past "
             f"its budget of {budget_s:.1f} s")
          + f"; advance {float(d[0]):.6f} m in {n * h:.2f} s "
          f"(pure rolling {v_roll * n * h:.4f} m; bounds 0.5–1.3×), lateral "
          f"{float(d[1]):.3e} m, height {float(d[2]):.3e} m, upright "
          f"{upright:.6f}; JAX run {jax_advance:.6f} m, |Δ| {gap:.3e} ≤ "
          f"{tol:.3e} (four times its own response to 1e-6 start moves) "
          f"[{card}]")


# (c) tests/test_robots.py's three scenes, each through a captured step
COPTER_H, TURTLE_H = 2e-3, 1e-3
ROBOT_X_ATOL = 2e-4
ROBOT_V_TOL = dict(rtol=1e-3, atol=1e-3)


def robot_loop(step, state, n, h, device, graph):
    """``n`` steps of ``step(state, t)`` from ``state``: captured into a
    graph and replayed (``graph``), or an eager loop.  Returns the final
    state and the ms a step (graph replays, timed with CUDA events)."""
    cur = BodyState(**{f: getattr(state, f).clone() for f in "xqvw"})
    t = torch.zeros((), dtype=state.x.dtype, device=device)
    if not graph:
        for _ in range(n):
            cur = step(cur, t)
            t = t + h
        return cur, None

    def one():
        new = step(cur, t)
        for f in "xqvw":
            getattr(cur, f).copy_(getattr(new, f))
        t.add_(h)

    g = capture(one, lambda: step(cur, t), device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return cur, start.elapsed_time(end) / n


def robot_scenes(device):
    """(name, step, state, steps, h) of the three scenes."""
    copter, state = create_copter(device=device)
    w_h = float(copter_hover_omega(copter))
    d = 0.1 * w_h
    om = {"hover": torch.full((4,), w_h, device=device),
          "climb": torch.full((4,), 1.05 * w_h, device=device),
          "yaw": torch.tensor([w_h + d, w_h - d, w_h + d, w_h - d],
                              device=device)}
    scenes = [(name, (lambda s, t, o=o: copter_step(copter, s, o, t,
                                                   COPTER_H)[0]),
               state, 400 if name == "yaw" else 300, COPTER_H)
              for name, o in om.items()]
    bot, bstate = create_turtlebot(device=device)
    for name, (left, right) in (("straight", (8.0, 8.0)),
                                ("turn", (9.0, 5.0))):
        b = set_turtlebot_speeds(bot, left, right)
        scenes.append((name, (lambda s, t, b=b: turtlebot_step(
            b, s, t, TURTLE_H)[0]), bstate, 1500, TURTLE_H))
    return scenes, bot


def robot_checks(name, st, bot):
    """tests/test_robots.py's assertions on a final state."""
    x = st.x.double().cpu()
    if name == "hover":
        return (abs(float(x[0, 2]) - 1.0) < 0.02
                and abs(float(st.v[0, 2])) < 0.05)
    if name == "climb":
        return float(x[0, 2]) > 1.05
    if name == "yaw":
        up = Q.qrotate(st.q[0].cpu(), torch.tensor([0.0, 0.0, 1.0]))
        return abs(float(st.w[0, 2])) > 0.3 and float(up[2]) > 0.95
    xc = x[bot.chassis]
    if name == "straight":
        return float(xc[0]) > 0.15 and abs(float(xc[1])) < 0.05 * abs(
            float(xc[0])) + 1e-3
    e1 = Q.qrotate(st.q[bot.chassis].cpu(), torch.tensor([1.0, 0.0, 0.0]))
    return float(torch.atan2(e1[1], e1[0])) < -0.1


def robots_on_the_card(card):
    """(c): each scene through a captured step on the card, with the test's
    assertions, against the port's eager run on the CPU.  Returns the
    turtlebot, and the straight-driving scene's step, final state, step
    count and h."""
    scenes, bot = robot_scenes(DEV)
    cpu_scenes, _ = robot_scenes("cpu")
    for (name, step, state, n, h), (_, cstep, cstate, _, _) in zip(
            scenes, cpu_scenes):
        st, ms = robot_loop(step, state, n, h, DEV, graph=True)
        if name == "straight":
            straight = (step, st, n, h)
        require(robot_checks(name, st, bot),
                f"{name}: tests/test_robots.py's check fails on the card: "
                f"x {st.x.tolist()}, w {st.w.tolist()}")
        ref, _ = robot_loop(cstep, cstate, n, h, "cpu", graph=False)
        errs = [assert_close(st.x, ref.x, 0.0, ROBOT_X_ATOL, f"{name} x"),
                assert_close(st.q, ref.q, 0.0, ROBOT_X_ATOL, f"{name} q")]
        errs += [assert_close(getattr(st, f), getattr(ref, f),
                              ROBOT_V_TOL["rtol"], ROBOT_V_TOL["atol"],
                              f"{name} {f}") for f in "vw"]
        print(f"robots, {name} ({n} steps of {h} s through a captured "
              f"step): {ms:.4f} ms/step; tests/test_robots.py's check holds; "
              f"against the port on the CPU max |Δ| x {errs[0]:.3e}, q "
              f"{errs[1]:.3e} (≤ {ROBOT_X_ATOL}), v {errs[2]:.3e}, ω "
              f"{errs[3]:.3e} [{card}]")
    return bot, straight


# (d) sensors on (c)'s turtlebot, and ray sensors in a 20,000-triangle scene
NOISE_N = 2048
SENSOR_TOL = dict(rtol=1e-5, atol=1e-6)
RAY_ATOL = 1e-4


def sensor_reads(bot, prev, cur, gen, sigma=(0.0, 0.0, 0.0)):
    """IMU on the chassis (lever arm 5 cm up), GPS on the chassis and the
    left wheel's tachometer, from (prev, cur); ``sigma`` the accelerometer,
    gyroscope and GPS noise."""
    dev = cur.x.device
    imu = make_imu(bot.chassis, mount_pos=(0.0, 0.0, 0.05),
                   accel_sigma=sigma[0], gyro_sigma=sigma[1], device=dev)
    gps = make_gps(bot.chassis, sigma=sigma[2], device=dev)
    r = imu_read(imu, cur, prev, TURTLE_H, gen)
    g = gps_read(gps, cur, gen)
    tach = tachometer_read(cur, bot.wheels[0], axis=1)
    return (torch.cat([r.accel, r.gyro, r.mag]),
            torch.stack([g.lat, g.lon, g.alt]), tach)


def height_field_scene(device, n=100, size=20.0, seed=0):
    """A ``RayScene`` of a seeded height field (n × n cells, two triangles
    each: 20,000 at n = 100) plus two boxes, two spheres and a plane."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-size / 2, size / 2, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = 0.3 * np.sin(0.7 * X) * np.cos(0.5 * Y) + 0.05 * rng.normal(
        size=X.shape)
    V = np.stack([X, Y, Z], -1).reshape(-1, 3)
    k = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).reshape(-1)
    tri = np.concatenate([np.stack([k, k + n + 1, k + 1], 1),
                          np.stack([k + 1, k + n + 1, k + n + 2], 1)])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    rot = Q.q_to_matrix(Q.q_from_axis_angle(
        torch.tensor([0.0, 0.0, 1.0]), torch.tensor([0.3, -0.7])))
    return RayScene(
        tri_v0=t(V[tri[:, 0]]), tri_v1=t(V[tri[:, 1]]),
        tri_v2=t(V[tri[:, 2]]),
        sph_c=t([[3.0, 1.0, 1.0], [-2.0, -4.0, 0.8]]), sph_r=t([0.8, 1.2]),
        box_c=t([[0.0, 4.0, 0.5], [-5.0, 0.5, 1.0]]), box_R=rot.to(device),
        box_h=t([[1.0, 0.5, 1.0], [0.5, 2.0, 1.5]]),
        pln_p=t([[0.0, 0.0, -1.0]]), pln_n=t([[0.0, 0.0, 1.0]])), len(tri)


def sensors_on_the_card(card, bot, straight):
    """(d): noise-free readings card against CPU from the same states (the
    end of (c)'s straight drive and one step on), the noisy moments, and
    the lidar and depth camera card against CPU."""
    step, prev, n, h = straight
    cur = step(prev, torch.full((), n * h, device=DEV))
    n += 1
    gen = torch.Generator(device=DEV).manual_seed(0)
    got = sensor_reads(bot, prev, cur, gen)
    ref = sensor_reads(bot, state_cpu(prev), state_cpu(cur),
                       torch.Generator().manual_seed(0))
    errs = [assert_close(g, r, SENSOR_TOL["rtol"], SENSOR_TOL["atol"],
                         f"sensor {w}")
            for g, r, w in zip(got, ref, ("imu", "gps", "tachometer"))]
    sigma = (0.2, 0.02, 1.5)
    noisy = [sensor_reads(bot, prev, cur, gen, sigma)
             for _ in range(NOISE_N)]
    lines = []
    for what, sl, s in (("accelerometer", slice(0, 3), sigma[0]),
                        ("gyroscope", slice(3, 6), sigma[1])):
        e = (torch.stack([r[0][sl] for r in noisy]) - got[0][sl]).double()
        lines.append((what, e, s))
    alt = torch.stack([r[1][2] for r in noisy]).double() - got[1][2]
    lines.append(("GPS altitude", alt, sigma[2]))
    for what, e, s in lines:
        m, sd = float(e.mean()), float(e.std())
        bar = 4 * s / np.sqrt(e.numel())
        require(abs(m) <= bar and abs(sd - s) <= bar,
                f"{what} noise: mean {m}, σ {sd} (σ {s}, bar {bar})")
    print(f"sensors on the turtlebot after {n} steps: IMU, GPS, tachometer "
          f"noise-free card vs CPU max |Δ| {errs[0]:.3e}, {errs[1]:.3e}, "
          f"{errs[2]:.3e} (rtol {SENSOR_TOL['rtol']}); noisy, {NOISE_N} "
          f"reads from a seeded generator on the card: " + "; ".join(
              f"{w} mean {float(e.mean()):.3e} σ {float(e.std()):.4e} (σ "
              f"{s}, ± {4 * s / np.sqrt(e.numel()):.2e})"
              for w, e, s in lines) + f" [{card}]")
    scene, n_tri = height_field_scene(DEV)
    cscene, _ = height_field_scene("cpu")
    pose_x = torch.tensor([0.5, -0.5, 1.5], device=DEV)
    pose_q = Q.q_from_axis_angle(torch.tensor([0.0, 0.0, 1.0]),
                                 torch.tensor(0.4)).to(DEV)
    for what, fn in (("lidar_scan (16 × 360)", lidar_scan),
                     ("depth_image (48 × 64)", depth_image)):
        img = fn(scene, pose_x, pose_q)
        ms = cuda_ms(lambda: fn(scene, pose_x, pose_q), 5)
        # the CPU reference casts 5,760 rays against 20,000 triangles: all
        # the host's cores
        threads = torch.get_num_threads()
        torch.set_num_threads(os.cpu_count() or 1)
        try:
            ref = fn(cscene, pose_x.cpu(), pose_q.cpu())
        finally:
            torch.set_num_threads(threads)
        err = assert_close(img, ref, 0.0, RAY_ATOL, what)
        hit = float((img < 100.0).float().mean())
        print(f"{what} in a scene of {n_tri} triangles, 2 boxes, 2 spheres "
              f"and a plane: {ms:.3f} ms a scan (CUDA events), "
              f"{hit:.3f} of the rays hit, ranges "
              f"{float(img.min()):.3f}–{float(img.max()):.3f} m; card vs CPU "
              f"max |Δ| {err:.3e} m (≤ {RAY_ATOL}) [{card}]")


# (e) model files and the YAML app
FILE_STEPS = 200
FILE_H = 1e-3
FILE_X_ATOL = 2e-4

URDF_TWO_LINK = """<robot name="arm">
  <link name="base">
    <inertial><mass value="0"/>
      <inertia ixx="1" iyy="1" izz="1" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <link name="upper">
    <inertial><origin xyz="0.25 0 0"/><mass value="2.0"/>
      <inertia ixx="0.01" iyy="0.05" izz="0.05" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <link name="lower">
    <inertial><origin xyz="0.2 0 0"/><mass value="1.0"/>
      <inertia ixx="0.005" iyy="0.02" izz="0.02" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0 1"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="elbow" type="continuous">
    <parent link="upper"/><child link="lower"/>
    <origin xyz="0.5 0 0"/><axis xyz="0 1 0"/>
  </joint>
</robot>
"""

# a pin, a ball and a slider joint, each child frame turned against its
# joint frame so that the chain starts away from rest
OSIM_CHAIN = """<?xml version="1.0" encoding="UTF-8"?>
<OpenSimDocument Version="30000">
  <Model name="chain">
    <gravity>0 -9.80665 0</gravity>
    <BodySet>
      <objects>
        <Body name="ground">
          <mass>0</mass>
          <mass_center>0 0 0</mass_center>
          <inertia_xx>1</inertia_xx><inertia_yy>1</inertia_yy>
          <inertia_zz>1</inertia_zz>
        </Body>
        <Body name="rod1">
          <mass>1.0</mass>
          <mass_center>0 0 0</mass_center>
          <inertia_xx>0.02</inertia_xx><inertia_yy>0.002</inertia_yy>
          <inertia_zz>0.02</inertia_zz>
          <Joint>
            <PinJoint name="pin">
              <parent_body>ground</parent_body>
              <location_in_parent>0 0 0</location_in_parent>
              <orientation_in_parent>0 0 0</orientation_in_parent>
              <location>0 0.5 0</location>
              <orientation>0 0 0.5</orientation>
            </PinJoint>
          </Joint>
        </Body>
        <Body name="rod2">
          <mass>0.8</mass>
          <mass_center>0 0.1 0</mass_center>
          <inertia_xx>0.015</inertia_xx><inertia_yy>0.002</inertia_yy>
          <inertia_zz>0.015</inertia_zz>
          <Joint>
            <BallJoint name="ball">
              <parent_body>rod1</parent_body>
              <location_in_parent>0 -0.5 0</location_in_parent>
              <orientation_in_parent>0 0 0</orientation_in_parent>
              <location>0 0.4 0</location>
              <orientation>0.3 0.2 -0.4</orientation>
            </BallJoint>
          </Joint>
        </Body>
        <Body name="slider">
          <mass>0.5</mass>
          <mass_center>0 0 0</mass_center>
          <inertia_xx>0.001</inertia_xx><inertia_yy>0.001</inertia_yy>
          <inertia_zz>0.001</inertia_zz>
          <Joint>
            <SliderJoint name="slide">
              <parent_body>rod2</parent_body>
              <location_in_parent>0 -0.3 0</location_in_parent>
              <orientation_in_parent>0 0 1.2</orientation_in_parent>
              <location>0 0 0</location>
              <orientation>0 0 0</orientation>
            </SliderJoint>
          </Joint>
        </Body>
      </objects>
    </BodySet>
  </Model>
</OpenSimDocument>
"""

# a revolute pendulum, a second link on a spherical joint, and a
# translational spring-damper from the ground to the second link
ADAMS_DECK = """ADAMS/View model name: chain
!
PART/01, GROUND
!
MARKER/0101, PART = 01
, QP = 0, 0, 0
, REULER = 0D, 90D, 0D
!
MARKER/0102, PART = 01
, QP = 1.5, 0, 0.5
!
PART/02, MASS = 1
, CM = 0201, IP = 0.01, 0.1, 0.1
!
MARKER/0201, PART = 02
, QP = 0.5, 0, 0
, REULER = 0D, 90D, 0D
!
MARKER/0202, PART = 02
, QP = 0, 0, 0
, REULER = 0D, 90D, 0D
!
MARKER/0203, PART = 02
, QP = 1, 0, 0
!
PART/03, MASS = 0.5
, CM = 0301, IP = 0.005, 0.02, 0.02
!
MARKER/0301, PART = 03
, QP = 1.3, 0, -0.2
, REULER = 30D, 20D, 10D
!
MARKER/0302, PART = 03
, QP = 1, 0, 0
!
MARKER/0303, PART = 03
, QP = 1.4, 0, -0.3
!
JOINT/1, REVOLUTE
, I = 0202, J = 0101
!
JOINT/2, SPHERICAL
, I = 0302, J = 0203
!
SPRINGDAMPER/1, TRANSLATIONAL
, I = 0303, J = 0102, K = 40, C = 0.5, LENGTH = 0.6
!
ACCGRAV/, KGRAV = -9.80665
!
END
"""

MBS_SPEC_YAML = """simulation:
  time_step: 1.0e-3
  end_time: 0.5
  gravity: [0, 0, -9.81]
  solver: {type: direct}
model:
  type: mbs
  bodies:
    - {name: ground, fixed: true}
    - {name: rod, mass: 1.0, inertia: [0.01, 0.05, 0.05], pos: [0.5, 0, 0]}
    - {name: disc, mass: 0.5, inertia: [0.002, 0.004, 0.002], pos: [1, 0, 0]}
  joints:
    - {type: revolute, body1: ground, body2: rod, pos: [0, 0, 0],
       axis: [0, 1, 0]}
  motors:
    - {type: rotation_speed, body1: rod, body2: disc, pos: [1, 0, 0],
       axis: [1, 0, 0], profile: {type: sine, amplitude: 3.0,
       frequency: 2.0}}
  springs:
    - {body1: ground, body2: rod, point1: [1, 0, 0.8], point2: [1, 0, 0],
       spring_coefficient: 20.0, damping_coefficient: 0.5,
       free_length: 0.8}
output: {csv: @CSV@}
"""

DEM_SPEC_YAML = """simulation: {end_time: 0.05, gravity: [0, 0, -9.81]}
model:
  type: dem
  radius: 0.05
  density: 2500
  box: [[0, 0, 0], [0.5, 0.5, 0.5]]
  material: {youngs: 5.0e+6, restitution: 0.4, mu_s: 0.5}
  particles: {sampler: grid, region: [[0.05, 0.05, 0.05], [0.45, 0.45, 0.45]],
              spacing: 0.1}
output: {frames: @FRAMES@}
"""


def model_decks(directory):
    """Write the URDF, OpenSim and ADAMS decks into ``directory``; return
    {kind: path}."""
    paths = {}
    for kind, text in (("urdf", URDF_TWO_LINK), ("osim", OSIM_CHAIN),
                       ("adm", ADAMS_DECK)):
        paths[kind] = os.path.join(directory, f"chain.{kind}")
        with open(paths[kind], "w") as f:
            f.write(text)
    return paths


def load_deck(kind, path, device, dtype=torch.float32):
    """(model, state) of a deck file."""
    if kind == "urdf":
        with open(path) as f:
            return build_from_urdf(f.read(), dtype=dtype,
                                   device=device)[:2]
    if kind == "osim":
        return load_osim(path, dtype=dtype, device=device)[:2]
    return load_adm(path, dtype=dtype, device=device)


def start_yaml_app(directory):
    """Write the MBS and DEM specs into ``directory`` and start ``python -m
    chrono_tpu_torch.run`` on each (two processes, on the card); returns
    (processes, csv path, frames directory, start time) for (e)."""
    csv_path = os.path.join(directory, "pendulum.csv")
    frames = os.path.join(directory, "frames")
    specs = {"mbs": MBS_SPEC_YAML.replace("@CSV@", csv_path),
             "dem": DEM_SPEC_YAML.replace("@FRAMES@", frames)}
    procs, t0 = {}, time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    for name, text in specs.items():
        path = os.path.join(directory, f"{name}.yaml")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "chrono_tpu_torch.run", path], cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs, csv_path, frames, t0


def model_files_and_yaml(card, arm, yaml_run):
    """(e): the three decks built on the card and run through ``simulate``
    against the port on the CPU; the YAML app's two runs (``yaml_run``, from
    ``start_yaml_app``) and what they wrote; ``arm`` (the model and a state
    of (a)'s arm) through the archive."""
    settings = SolverSettings(solver="direct")
    model, st = arm
    text = archive_out(model)
    back = archive_in(text)
    t = torch.full((), 0.25, device=DEV)
    a = step_euler_implicit_linearized(model, st, t, ARM_H, settings)[0]
    b = step_euler_implicit_linearized(back, st, t, ARM_H, settings)[0]
    require(type(back) is type(model) and state_equal(a, b),
            "arm: the archived model steps differently")
    print(f"industrial arm: its Model through archive_out / archive_in "
          f"({len(text)} bytes of JSON) steps bit for bit as the original "
          f"[{card}]")
    with tempfile.TemporaryDirectory() as d:
        for kind, path in model_decks(d).items():
            model, state = load_deck(kind, path, DEV)
            (final, _), wall = mbs_timed(lambda: simulate(
                model, state, FILE_H, FILE_STEPS, settings, save_every=0))
            cm, cst = load_deck(kind, path, "cpu")
            ref, _ = simulate(cm, cst, FILE_H, FILE_STEPS, settings,
                              save_every=0)
            viol = mbs_violation(model, final)
            finite = all(bool(torch.isfinite(getattr(final, f)).all())
                         for f in "xqvw")
            moved = float((final.x - state.x).abs().max())
            err = float((final.x.cpu() - ref.x).abs().max())
            require(finite and viol < MBS_VIOLATION and err <= FILE_X_ATOL
                    and moved > 1e-3,
                    f"{kind} deck: finite {finite}, violation {viol}, card vs "
                    f"CPU {err}, moved {moved}")
            print(f"{kind} deck ({model.n_bodies} bodies, "
                  f"{sum(j.n for j in model.joints.values())} joints), "
                  f"{FILE_STEPS} steps through simulate on the card: "
                  f"{wall / FILE_STEPS * 1e3:.4f} ms/step with the capture; "
                  f"moved {moved:.4f} m, joint violation {viol:.3e} (< "
                  f"{MBS_VIOLATION}), card vs CPU max |Δx| {err:.3e} (≤ "
                  f"{FILE_X_ATOL}) [{card}]")
    procs, csv_path, frames, t0 = yaml_run
    outs = {name: p.communicate(timeout=300)[0] for name, p in procs.items()}
    wall = time.perf_counter() - t0
    for name, p in procs.items():
        require(p.returncode == 0,
                f"python -m chrono_tpu_torch.run {name}.yaml: exit "
                f"{p.returncode}\n{outs[name]}")
    cols, data = CSVWriter.read(csv_path)
    require(data.shape == (500, 10) and "disc_z" in cols
            and bool(np.isfinite(data).all())
            and float(data[-1, cols.index("rod_z")]) < -0.05,
            f"MBS spec: csv {data.shape}, columns {cols}")
    pos = np.asarray(FrameWriter.read_frame(frames, 0)["pos"])
    with open(os.path.join(frames, "index.json")) as f:
        t_frame = json.load(f)[0]["time"]
    # the grid's layers start at z = 0.1 … 0.4 (mean 0.25), clear of
    # the floor, and fall ~1.2 cm in 0.05 s
    require(pos.shape == (64, 3) and bool(np.isfinite(pos).all())
            and t_frame > 0.04 and float(pos[:, 2].mean()) < 0.245,
            f"DEM spec: frame {pos.shape}, time {t_frame}, mean z "
            f"{float(pos[:, 2].mean())}")
    print(f"YAML app, `python -m chrono_tpu_torch.run` on an MBS spec "
          f"(pendulum, sine-driven disc motor, spring) and a DEM spec "
          f"(64 spheres on a grid), two processes on the card started with "
          f"the phase and collected {wall:.2f} s later; "
          f"{outs['mbs'].strip().splitlines()[-1]!r}"
          f", {outs['dem'].strip().splitlines()[-1]!r}; the csv holds "
          f"{data.shape[0]} finite rows of {len(cols)} columns, the rod down "
          f"to z = {float(data[-1, cols.index('rod_z')]):.4f} m; the "
          f"frame {pos.shape[0]} finite positions, mean z "
          f"{float(pos[:, 2].mean()):.4f} m (0.25 at the start) [{card}]")


def robots_main_path(card):
    """Phase 18: robots and model files: (a) the industrial-arm demo, (c)
    copter and turtlebot, (d) sensors, (e) model files and the YAML app,
    whose two processes run from the phase's start, then (b) the RoboSimian
    drive, within what is left of the phase's time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        yaml_run = start_yaml_app(d)
        try:
            t0 = time.perf_counter()
            arm = arm_demo(card)
            print(f"phase 18 (a) took {time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            bot, straight = robots_on_the_card(card)
            print(f"phase 18 (c) took {time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            sensors_on_the_card(card, bot, straight)
            print(f"phase 18 (d) took {time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            model_files_and_yaml(card, arm, yaml_run)
            print(f"phase 18 (e) took {time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            robosimian_drive(card, min(RS_BUDGET_S, PHASE18_S - (
                t0 - start)))
            print(f"phase 18 (b) took {time.perf_counter() - t0:.2f} s")
        finally:
            torch.set_num_threads(threads)
            for p in yaml_run[0].values():
                if p.poll() is None:
                    p.kill()
                    p.wait()

def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace one more SPH cycle with torch.profiler")
    args = parser.parse_args()
    require(torch.cuda.is_available(), "chip_smoke.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all([*KERNELS, *((name, ("PAIR_COUNTERS",))
                                  for name in COUNTED)])
    for name in KERNELS:
        _build.load(name)
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    # phase 1: DEM parity on the card
    t0 = time.perf_counter()
    for mode in ("frictionless", "single_step"):
        print(f"K1 vs twin, 120 particles, 1 substep, {mode}: "
              f"max abs err {k1_small_substep(mode):.3e}")
        print(f"K1 vs twin, 120 particles, 3 cycles, {mode}: "
              f"max abs err {k1_three_cycles(mode):.3e}")
    print(f"K1 vs twin, 64000 overlapping particles, 1 substep: max abs "
          f"err {k1_one_substep(*overlap_scene()):.3e}")
    print(f"K2 vs twin, 6 cycles: bit-exact "
          f"({k2_six_cycles()} cells changed occupants)")
    for C, stir in ((16, False), (16, True), (3, True)):
        changed, most = k2_rows_cycles(C, stir)
        require(changed > 0 and (most > C) == (C == 3),
                f"dem_migrate_rows, C={C}: {changed} particles changed "
                f"cell, at most {most} landed in a cell")
        print(f"dem_migrate_rows vs twin and slot path, 6 cycles, C={C}"
              f"{', stirred' if stir else ''}: bit-exact ({changed} "
              f"particles changed cell, at most {most} landed in a cell)")
    loss = k2_rows_jump()
    require(loss == 1, f"a two-cell jump lost {loss} particles, not 1")
    print(f"dem_migrate_rows, a two-cell jump: lost {loss} particle, as "
          "its twin and the slot path lose it")
    print(f"phase 1 took {time.perf_counter() - t0:.2f} s")

    # phase 2: the DEM main path at full size
    t0 = time.perf_counter()
    kernels = main_path(card)
    print(f"phase 2 took {time.perf_counter() - t0:.2f} s")

    # phase 3: SPH parity on the card
    t0 = time.perf_counter()
    for viscosity in ("artificial", "laminar"):
        errs = sph_one_substep(viscosity)
        print(f"SPH sweeps vs twins, mini dam, 1 substep, {viscosity}: "
              f"{format_errs(errs)}")
        print(f"SPH path vs twins, mini dam, 3 cycles x 4 substeps, "
              f"{viscosity}: max abs err {sph_three_cycles(viscosity):.3e}")
    print(f"phase 3 took {time.perf_counter() - t0:.2f} s")

    # phase 4: the WCSPH dam break at full width
    t0 = time.perf_counter()
    kernels += sph_main_path(card, args.profile)
    print(f"phase 4 took {time.perf_counter() - t0:.2f} s")

    # phase 5: CRM parity on the card
    t0 = time.perf_counter()
    errs, outer_errs = crm_one_substep()
    print(f"CRM sweeps vs twins, mini bed, 1 substep: {format_errs(errs)}")
    for name, e in outer_errs.items():
        print(f"crm_outer (4 substeps) vs {name}, mini bed: "
              f"{format_errs({'crm_outer': e})}")
    errs, list_ovf = crm_outer_short_list()
    print(f"crm_outer (4 substeps) with a 16-slot list, mini bed: list "
          f"overflow {list_ovf} reported; "
          + "; ".join(f"vs {k}: " + format_errs({"crm_outer": e})
                      for k, e in errs.items()))
    print(f"CRM path vs twins, mini bed, 3 cycles x 4 substeps: max abs err "
          f"{crm_three_cycles():.3e}")
    print(f"phase 5 took {time.perf_counter() - t0:.2f} s")

    # phase 6: CRM terrain at full width
    t0 = time.perf_counter()
    kernels += crm_main_path(card)
    print(f"phase 6 took {time.perf_counter() - t0:.2f} s")

    # phase 7: NSC parity on the card
    t0 = time.perf_counter()
    for P, errs in nsc_one_sweep().items():
        print(f"NSC kernels vs twins, sweep scene (24 spheres, blade walls "
              f"at 0.3 rad), P={P}: {format_errs(errs)}")
    for dynamic in (False, True):
        what = "dynamic blade" if dynamic else "blade"
        print(f"NSC path vs twins, {what} scene, 2 steps: max abs err "
              f"{nsc_two_steps(dynamic):.3e}")
    print(f"phase 7 took {time.perf_counter() - t0:.2f} s")

    # phase 8: the bladed mixer at full width, and at 400,000 spheres
    t0 = time.perf_counter()
    kernels += mixer_main_path(card)
    mixer_large(card)
    print(f"phase 8 took {time.perf_counter() - t0:.2f} s")

    # phase 9: the forces path's kernel and the five boundary kinds
    t0 = time.perf_counter()
    for mode in ("frictionless", "single_step"):
        err, ratio = forces_small(mode)
        print(f"dem_forces vs twin, 120 particles, {mode}: max abs err "
              f"{err:.3e} ({ratio:.3f} of its tolerance)")
    print(f"forces path vs twins, five boundary kinds, 3 cycles x 4 "
          f"substeps: max abs err {forces_path_three_cycles():.3e}")
    print(f"phase 9 took {time.perf_counter() - t0:.2f} s")

    # phase 10: the sym / pencil, pallas / xla and silo scenes at 1M
    t0 = time.perf_counter()
    sym_row, row = dem_full_width(card)
    kernels[0].update(sym_row)
    kernels.append({"name": "dem_forces", "route": "cuda",
                    "source": "chrono_tpu_torch/csrc/dem_forces.cu",
                    "replaces": "; ".join(DEM_FORCES_REPLACES), **row,
                    "library_ms": None})
    print(f"phase 10 took {time.perf_counter() - t0:.2f} s")

    # phase 11: the multibody core (config #1)
    t0 = time.perf_counter()
    mbs_main_path(card)
    print(f"phase 11 took {time.perf_counter() - t0:.2f} s")

    # phase 12: rigid-body contact (config #2 as bench_mixer builds it)
    t0 = time.perf_counter()
    general_mixer_main_path(card)
    print(f"phase 12 took {time.perf_counter() - t0:.2f} s")

    # phase 13: the vehicle on CRM terrain (config #5 as bench_crm builds
    # it), on the CRM kernels of phase 6
    t0 = time.perf_counter()
    vehicle = vehicle_main_path(card)
    for row in kernels:
        if row["name"] in vehicle:
            row["launches_by_phase"] = {"6": row["launches"],
                                        "13": vehicle[row["name"]]}
            row["launches"] += vehicle[row["name"]]
    print(f"phase 13 took {time.perf_counter() - t0:.2f} s")

    # phase 14: wheeled vehicles and rovers on rigid and SCM terrain (no
    # kernel on its path)
    t0 = time.perf_counter()
    wheeled_main_path(card)
    print(f"phase 14 took {time.perf_counter() - t0:.2f} s")

    # phase 15: the neighbour-list (gather) backend (no kernel on its path)
    t0 = time.perf_counter()
    gather_main_path(card)
    print(f"phase 15 took {time.perf_counter() - t0:.2f} s")

    # phase 16: the DEM system on the neighbour list (no kernel on its path)
    t0 = time.perf_counter()
    dem_system_main_path(card)
    print(f"phase 16 took {time.perf_counter() - t0:.2f} s")

    # phase 17: convex contact, tracked vehicles and the other steppers (no
    # kernel on their path)
    t0 = time.perf_counter()
    tracked_main_path(card)
    print(f"phase 17 took {time.perf_counter() - t0:.2f} s")

    # phase 18: robots, sensors and model files (no kernel on their path)
    t0 = time.perf_counter()
    robots_main_path(card)
    print(f"phase 18 took {time.perf_counter() - t0:.2f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
