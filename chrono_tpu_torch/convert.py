"""Build the port's parameter objects from the JAX package's leaves.

The JAX package keeps ``DEMParams`` / ``DEMMaterial`` / ``DEMBoundaries``
(planes, cylinders, spheres, cones, wheels) / ``GridSpec`` / ``SPHParams`` /
``SPHState`` / ``CRMParams`` / ``CRMState`` / ``CRMFSIState`` /
``ActiveDomainSpec`` / ``NeighborList`` / ``FSIState`` /
``NSCPencilParams`` and the
multibody ``Model`` / ``BodyState``, the contact pipeline's
``CollisionModel`` / ``Contacts`` and ``SMCParams`` as pytrees of arrays and
static fields.
A caller that holds them flattens each into a mapping of field name → numpy
array or Python scalar (nested mappings for the two materials, the wall
kinds, and a model's joints, motors and force elements); these functions
turn such mappings into the port's objects.  The vehicle's carriers (the tires'
parameters, ``PowertrainParams``, ``WheeledVehicle``, ``SCMParams`` /
``SCMState``, ``Rover`` and the drivers) come across the same way, and
so do the neighbour-list DEM system's ``DEMState`` (its list and
histories), ``TriangleMesh`` / ``MeshBins``, the granular terrain's
``GranularFSIState``, the contact pipeline's convex shapes, the tracked
vehicles (``TrackedVehicle`` / ``TrackParams``, ``SegmentedTrack``,
``DoublePinTrack``, ``SprocketGear``), the 2-D profiles, the hydraulic
actuator's ``HydraulicParams``, the rotation functions, the robots
(``Arm6R``, ``ArmSCARA``, ``Trajectory``, ``Copter``, ``Turtlebot``) and
the sensors (``NoiseModel``, ``IMUSensor``, ``GPSSensor``, ``RayScene``).  The NSC
multiplier maps move γ
between this port's single-sided layout and the JAX dense reference's pair
lattice.  So this package never sees JAX.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Any, Mapping

import numpy as np
import torch

from chrono_tpu_torch.collision import pipeline as cp
from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.collision import profile2d as p2d
from chrono_tpu_torch.core import rotation_functions as RF
from chrono_tpu_torch.core import functions as F
from chrono_tpu_torch.dem import bc
from chrono_tpu_torch.dem.bc import PlaneBCs
from chrono_tpu_torch.dem.neighbors import NeighborList
from chrono_tpu_torch.dem.mesh import MeshBins, TriangleMesh
from chrono_tpu_torch.dem.params import DEMMaterial, DEMParams
from chrono_tpu_torch.dem.system import DEMState
from chrono_tpu_torch.fsi.active import ActiveDomainSpec
from chrono_tpu_torch.fsi.crm_terrain import CRMFSIState
from chrono_tpu_torch.fsi.system import FSIState
from chrono_tpu_torch.fsi.sph.crm import CRMParams, CRMState
from chrono_tpu_torch.fsi.sph.state import SPHParams, SPHState
from chrono_tpu_torch.models.industrial import Arm6R, ArmSCARA, Trajectory
from chrono_tpu_torch.models.robots import Copter, Turtlebot
from chrono_tpu_torch.models.rover import Rover
from chrono_tpu_torch.ops.cuda.sph_substep import SortedCells
from chrono_tpu_torch.physics import force_elements as fe
from chrono_tpu_torch.physics.external import HydraulicParams
from chrono_tpu_torch.physics.body import BodyProps, BodyState
from chrono_tpu_torch.physics.joints import JointData
from chrono_tpu_torch.physics.motors import MotorData
from chrono_tpu_torch.physics import shafts as sh
from chrono_tpu_torch.physics.smc import SMCParams
from chrono_tpu_torch import sensors
from chrono_tpu_torch.physics.system import Model
from chrono_tpu_torch.solver.nsc_pencil import NSCPencilParams
from chrono_tpu_torch.utils.tree import is_static
from chrono_tpu_torch.vehicle import driver as drv
from chrono_tpu_torch.vehicle.granular_terrain import GranularFSIState
from chrono_tpu_torch.vehicle import tire as tr
from chrono_tpu_torch.vehicle.powertrain import PowertrainParams
from chrono_tpu_torch.vehicle.terrain import SCMParams, SCMState
from chrono_tpu_torch.vehicle import track_shoes as ts
from chrono_tpu_torch.vehicle.tracked import TrackedVehicle, TrackParams
from chrono_tpu_torch.vehicle.wheeled import WheeledVehicle


def _scalar(x) -> float:
    return float(np.asarray(x))


def material_from_numpy(leaves: Mapping[str, Any]) -> DEMMaterial:
    """``DEMMaterial`` from the JAX ``DEMMaterial`` fields (any left out
    keep their defaults)."""
    return DEMMaterial(**{f.name: _scalar(leaves[f.name])
                          for f in fields(DEMMaterial) if f.name in leaves})


def params_from_numpy(leaves: Mapping[str, Any]) -> DEMParams:
    """``DEMParams`` from the JAX ``DEMParams`` fields: every one, the
    static ones (capacities, skin, integrator, friction, rolling and
    force model) as they are."""
    static = {f.name: leaves[f.name] for f in fields(DEMParams)
              if f.name in leaves and f.name in (
                  "max_neighbors", "max_per_cell", "rebuild_every", "skin",
                  "integrator", "friction_mode", "rolling_mode",
                  "force_model")}
    return DEMParams(
        radius=_scalar(leaves["radius"]), mass=_scalar(leaves["mass"]),
        material=material_from_numpy(leaves["material"]),
        wall_material=material_from_numpy(leaves["wall_material"]),
        gravity=tuple(float(g) for g in np.asarray(leaves["gravity"])),
        dt=_scalar(leaves["dt"]), **static)


def _walls(cls, leaves: Mapping[str, Any]):
    return cls(**{f.name: torch.tensor(np.asarray(leaves[f.name],
                                                  np.float32))
                  for f in fields(cls)})


def planes_from_numpy(leaves: Mapping[str, Any]) -> PlaneBCs:
    return _walls(PlaneBCs, leaves)


_BC_CLASSES = {"planes": PlaneBCs, "cylinders": bc.CylinderBCs,
               "spheres": bc.SphereBCs, "cones": bc.ConeBCs,
               "wheels": bc.WheelBCs}


def dem_boundaries_from_numpy(leaves: Mapping[str, Any]) -> bc.DEMBoundaries:
    """``DEMBoundaries`` from the JAX ``DEMBoundaries`` fields: each kind a
    mapping of its leaves (numpy arrays) or None."""
    return bc.DEMBoundaries(**{
        kind: None if leaves.get(kind) is None
        else _walls(cls, leaves[kind]) for kind, cls in _BC_CLASSES.items()})


def grid_from_numpy(leaves: Mapping[str, Any]) -> GridSpec:
    return GridSpec(origin=tuple(float(o) for o in leaves["origin"]),
                    cell_size=float(leaves["cell_size"]),
                    dims=tuple(int(d) for d in leaves["dims"]),
                    periodic=tuple(bool(p) for p in
                                   leaves.get("periodic", (False,) * 3)))


def sph_params_from_numpy(leaves: Mapping[str, Any]) -> SPHParams:
    """``SPHParams`` from the JAX ``SPHParams`` fields (floats as numpy
    scalars, gravity as a (3,) array, the static fields as they are).
    ``density_reinit_every`` comes across as it is; nothing reads it, in
    either package."""
    floats = ("d0", "h", "rho0", "mu", "c_s", "dt", "eos_gamma",
              "alpha_visc", "delta_sph", "xsph_eps")
    static = ("kernel", "viscosity_model", "boundary_model", "shifting",
              "rebuild_every", "integrator")
    ints = ("max_neighbors", "max_per_cell", "density_reinit_every")
    return SPHParams(
        gravity=tuple(float(g) for g in np.asarray(leaves["gravity"])),
        **{k: _scalar(leaves[k]) for k in floats},
        **{k: leaves[k] for k in static if k in leaves},
        **{k: int(leaves[k]) for k in ints if k in leaves})


def neighbor_list_from_numpy(leaves: Mapping[str, Any], *, device
                             ) -> NeighborList:
    """``dem.neighbors.NeighborList`` on ``device`` from the JAX
    ``NeighborList`` fields (``idx`` int32, ``valid`` bool, ``overflow``
    () int32)."""
    return NeighborList(
        idx=torch.as_tensor(np.array(leaves["idx"], np.int32),
                            device=device),
        valid=torch.as_tensor(np.array(leaves["valid"], bool),
                              device=device),
        overflow=torch.as_tensor(np.array(leaves["overflow"], np.int32),
                                 device=device))


def _nbr(leaves: Mapping[str, Any], device):
    nbr = leaves.get("nbr")
    return None if nbr is None else neighbor_list_from_numpy(nbr,
                                                             device=device)


def sph_state_from_numpy(leaves: Mapping[str, Any], *, device) -> SPHState:
    """``SPHState`` on ``device`` from the JAX ``SPHState`` fields, its
    neighbour list (a mapping of its fields) if given."""
    def t(name, dtype):
        return torch.as_tensor(np.array(leaves[name]), dtype=dtype,
                               device=device)

    return SPHState(pos=t("pos", torch.float32), vel=t("vel", torch.float32),
                    rho=t("rho", torch.float32), kind=t("kind", torch.int32),
                    body_id=t("body_id", torch.int32),
                    bce_local=t("bce_local", torch.float32),
                    time=t("time", torch.float32), nbr=_nbr(leaves, device))


def crm_params_from_numpy(leaves: Mapping[str, Any]) -> CRMParams:
    """``CRMParams`` from the JAX ``CRMParams`` fields.  ``dilatancy``
    comes across as it is; nothing reads it, in either package (the
    return is non-associated)."""
    return CRMParams(**{f: _scalar(leaves[f]) for f in (
        "youngs", "poisson", "friction_angle", "cohesion", "dilatancy")
        if f in leaves})


def crm_state_from_numpy(leaves: Mapping[str, Any], *, device) -> CRMState:
    """``CRMState`` on ``device`` from the JAX ``CRMState`` fields, its
    neighbour list (a mapping of its fields) if given."""
    def t(name, dtype):
        return torch.as_tensor(np.array(leaves[name]), dtype=dtype,
                               device=device)

    return CRMState(**{f: t(f, torch.float32) for f in (
        "pos", "vel", "rho", "bce_local", "tau_d", "tau_o", "time")},
        kind=t("kind", torch.int32), body_id=t("body_id", torch.int32),
        nbr=_nbr(leaves, device))


def fsi_state_from_numpy(leaves: Mapping[str, Any], *, device) -> FSIState:
    """``fsi.system.FSIState`` on ``device`` from the JAX ``FSIState``
    fields: ``bodies`` as for :func:`body_state_from_numpy`, ``fluid`` as
    for :func:`sph_state_from_numpy`, ``time``."""
    return FSIState(
        bodies=body_state_from_numpy(leaves["bodies"], device=device),
        fluid=sph_state_from_numpy(leaves["fluid"], device=device),
        time=torch.as_tensor(np.array(leaves["time"], np.float32),
                             device=device))


def crm_fsi_state_from_numpy(leaves: Mapping[str, Any], *, device):
    """``fsi.crm_terrain.CRMFSIState`` on ``device`` from the JAX
    ``CRMFSIState`` fields: ``bodies`` as for :func:`body_state_from_numpy`,
    ``terrain`` as for :func:`crm_state_from_numpy` (with ``kind``,
    ``body_id`` and ``bce_local`` of its rigid markers), ``time``."""
    return CRMFSIState(
        bodies=body_state_from_numpy(leaves["bodies"], device=device),
        terrain=crm_state_from_numpy(leaves["terrain"], device=device),
        time=torch.as_tensor(np.array(leaves["time"], np.float32),
                             device=device))


def active_spec_from_numpy(leaves: Mapping[str, Any], *, device):
    """``fsi.active.ActiveDomainSpec`` on ``device`` from the JAX
    ``ActiveDomainSpec`` fields (``box``, ``margin``; ``capacity`` as a
    plain int)."""
    def t(name):
        return torch.as_tensor(np.array(leaves[name], np.float32),
                               device=device)

    return ActiveDomainSpec(box=t("box"), margin=t("margin"),
                            capacity=int(leaves["capacity"]))


def nsc_params_from_numpy(leaves: Mapping[str, Any]) -> NSCPencilParams:
    """``NSCPencilParams`` from the JAX ``NSCPencilParams`` fields."""
    floats = ("radius", "mass", "mu", "dt", "envelope", "stab_factor",
              "max_recovery", "omega", "blade_inertia", "blade_torque")
    return NSCPencilParams(
        gravity=tuple(float(g) for g in np.asarray(leaves["gravity"])),
        **{k: _scalar(leaves[k]) for k in floats if k in leaves},
        **{k: int(leaves[k]) for k in ("n_iter", "restart_every")
           if k in leaves},
        **{k: bool(leaves[k]) for k in ("track_residual",
                                        "track_wall_reactions")
           if k in leaves})


def motion_function_from_numpy(leaves: Mapping[str, Any], *, device
                               ) -> F.MotionFunction:
    """A ``core.functions`` MotionFunction from ``{"class": name, field:
    value, …}``: arrays become float32 tensors on ``device``, a nested
    function is such a mapping, ``FSequence.fns`` a list of them, and the
    static fields (``FConstAcc.aw1``/``aw2``, ``FIntegral.samples``) keep
    their Python type."""
    cls = F.FUNCTIONS[leaves["class"]]
    kw = {}
    for f in fields(cls):
        if f.name not in leaves:
            continue
        v = leaves[f.name]
        if is_static(f):
            kw[f.name] = type(f.default)(np.asarray(v))
        elif isinstance(v, Mapping):
            kw[f.name] = motion_function_from_numpy(v, device=device)
        elif isinstance(v, (list, tuple)):
            kw[f.name] = tuple(motion_function_from_numpy(x, device=device)
                               for x in v)
        else:
            kw[f.name] = torch.as_tensor(np.array(v, np.float32),
                                         device=device)
    return cls(**kw)


def _present(v) -> bool:
    """A leaf that is there: not None, nor numpy's wrap of None."""
    return v is not None and not (isinstance(v, np.ndarray)
                                  and v.dtype == object)


def dem_state_from_numpy(leaves: Mapping[str, Any], *, device) -> DEMState:
    """``dem.system.DEMState`` on ``device`` from the JAX ``DEMState``
    fields: the neighbour list as a mapping of its fields, the histories,
    and Chung's and the rolling fields where they are present."""
    def t(name):
        return torch.as_tensor(np.array(leaves[name], np.float32),
                               device=device)

    optional = {f: t(f) for f in ("acc_old", "alpha_old", "roll_disp",
                                  "bc_roll_disp")
                if _present(leaves.get(f))}
    return DEMState(pos=t("pos"), vel=t("vel"), omega=t("omega"),
                    nbr=neighbor_list_from_numpy(leaves["nbr"],
                                                 device=device),
                    tan_disp=t("tan_disp"), bc_tan_disp=t("bc_tan_disp"),
                    time=t("time"), **optional)


def triangle_mesh_from_numpy(leaves: Mapping[str, Any], *, device
                             ) -> TriangleMesh:
    """``dem.mesh.TriangleMesh`` on ``device`` from the JAX fields."""
    return TriangleMesh(**{f.name: torch.as_tensor(
        np.array(leaves[f.name], np.float32), device=device)
        for f in fields(TriangleMesh)})


def mesh_bins_from_numpy(leaves: Mapping[str, Any], *, device) -> MeshBins:
    """``dem.mesh.MeshBins`` on ``device`` from the JAX fields."""
    return MeshBins(tri_ids=torch.as_tensor(
        np.array(leaves["tri_ids"], np.int32), device=device),
        cap=int(leaves["cap"]))


def granular_state_from_numpy(leaves: Mapping[str, Any], *, device
                              ) -> GranularFSIState:
    """``vehicle.granular_terrain.GranularFSIState`` on ``device`` from the
    JAX fields: ``bodies`` as for :func:`body_state_from_numpy`,
    ``terrain`` as for :func:`dem_state_from_numpy`, ``time``."""
    return GranularFSIState(
        bodies=body_state_from_numpy(leaves["bodies"], device=device),
        terrain=dem_state_from_numpy(leaves["terrain"], device=device),
        time=torch.as_tensor(np.array(leaves["time"], np.float32),
                             device=device))


def _carrier(cls, leaves: Mapping[str, Any], device):
    """A dataclass of tensors from its numpy leaves: int32 body indices,
    float32 otherwise (the builder's types)."""
    kw = {}
    for f in fields(cls):
        v = leaves[f.name]
        if f.name == "profile":
            kw[f.name] = motion_function_from_numpy(v, device=device)
        else:
            a = np.asarray(v)
            kw[f.name] = torch.as_tensor(
                a.astype(np.int32 if a.dtype.kind in "iu" else np.float32),
                device=device)
    return cls(**kw)


def body_state_from_numpy(leaves: Mapping[str, Any], *, device
                          ) -> BodyState:
    """``BodyState`` on ``device`` from the JAX ``BodyState`` fields
    (x, q, v, w)."""
    return _carrier(BodyState, leaves, device)


SHAFT_DATA = {"gear": sh.ShaftGearData, "planetary": sh.ShaftPlanetaryData,
              "shaft_body": sh.ShaftBodyData}


def mbs_model_from_numpy(leaves: Mapping[str, Any], *, device) -> Model:
    """The multibody ``Model`` on ``device`` from the JAX ``Model``'s
    leaves: ``props`` (inv_mass, inertia, inv_inertia), ``gravity``,
    ``joints`` / ``couplers`` / ``motors`` / ``load_motors`` as mappings
    kind → that kind's fields (a motor's ``profile`` as for
    :func:`motion_function_from_numpy`), ``tsda`` / ``rsda`` / ``bushings``
    as their fields or None, ``shaft_constraints`` as a mapping kind
    (gear, planetary, shaft_body) → that kind's fields and
    ``shaft_elements`` as its fields or None."""

    def kinds(key, cls):
        return {k: _carrier(cls, v, device)
                for k, v in (leaves.get(key) or {}).items()}

    def optional(key, cls):
        v = leaves.get(key)
        return None if v is None else _carrier(cls, v, device)

    return Model(
        props=_carrier(BodyProps, leaves["props"], device),
        gravity=torch.as_tensor(np.array(leaves["gravity"], np.float32),
                                device=device),
        joints=kinds("joints", JointData), motors=kinds("motors", MotorData),
        load_motors=kinds("load_motors", MotorData),
        tsda=optional("tsda", fe.TSDAData),
        rsda=optional("rsda", fe.RSDAData),
        shaft_constraints={
            k: _carrier(SHAFT_DATA[k], v, device)
            for k, v in (leaves.get("shaft_constraints") or {}).items()},
        shaft_elements=optional("shaft_elements", sh.ShaftTorqueElements),
        couplers=kinds("couplers", JointData),
        bushings=optional("bushings", fe.BushingData))


def convex_shapes_from_numpy(leaves: Mapping[str, Any], *, device
                             ) -> cp.ConvexShapes:
    """``ConvexShapes`` on ``device`` from the JAX ``ConvexShapes`` fields
    (``body``, ``kind``, ``pos``, ``rot``, ``data``, ``verts``, ``mu`` and
    ``family`` or None): int32 indices, kinds and families, float32
    otherwise."""
    fam = leaves.get("family")
    return cp.ConvexShapes(
        **{f: torch.as_tensor(np.asarray(leaves[f], np.float32),
                              device=device)
           for f in ("pos", "rot", "data", "verts", "mu")},
        **{f: torch.as_tensor(np.asarray(leaves[f], np.int32),
                              device=device) for f in ("body", "kind")},
        family=(None if not _present(fam) else torch.as_tensor(
            np.asarray(fam, np.int32), device=device)))


def collision_model_from_numpy(leaves: Mapping[str, Any], *, device
                               ) -> cp.CollisionModel:
    """The contact pipeline's ``CollisionModel`` on ``device`` from the JAX
    ``CollisionModel``'s leaves: ``spheres`` and ``boxes`` / ``convex`` /
    ``meshes`` (or None) as mappings of their fields (``convex`` as for
    :func:`convex_shapes_from_numpy`), ``grid`` as for
    :func:`grid_from_numpy`, and the capacities, ``envelope``, ``mu_roll``,
    ``mu_spin`` and ``mesh_candidates``."""

    def shapes(key, cls):
        v = leaves.get(key)
        return None if v is None else _carrier(cls, v, device)

    convex = leaves.get("convex")
    return cp.CollisionModel(
        spheres=_carrier(cp.SphereShapes, leaves["spheres"], device),
        boxes=shapes("boxes", cp.BoxShapes),
        convex=(None if convex is None
                else convex_shapes_from_numpy(convex, device=device)),
        meshes=shapes("meshes", cp.MeshShapes),
        grid=grid_from_numpy(leaves["grid"]),
        max_per_cell=int(leaves["max_per_cell"]),
        max_contacts=int(leaves["max_contacts"]),
        envelope=_scalar(leaves.get("envelope", 0.0)),
        mu_roll=_scalar(leaves.get("mu_roll", 0.0)),
        mu_spin=_scalar(leaves.get("mu_spin", 0.0)),
        mesh_candidates=int(leaves.get("mesh_candidates", 0)))


def smc_params_from_numpy(leaves: Mapping[str, Any]) -> SMCParams:
    """``SMCParams`` from the JAX ``SMCParams`` fields (material floats as
    numpy scalars, the three model choices as strings)."""
    return SMCParams(
        **{f.name: (str(leaves[f.name]) if is_static(f)
                    else _scalar(leaves[f.name]))
           for f in fields(SMCParams) if f.name in leaves})


def contacts_from_numpy(leaves: Mapping[str, Any], *, device) -> cp.Contacts:
    """``Contacts`` on ``device`` from the JAX ``Contacts`` fields: int32
    bodies and count, bool ``active``, float32 otherwise."""
    def t(name, dtype):
        return torch.as_tensor(np.array(leaves[name]), dtype=dtype,
                               device=device)

    return cp.Contacts(
        body_a=t("body_a", torch.int32), body_b=t("body_b", torch.int32),
        **{k: t(k, torch.float32) for k in ("point", "normal", "gap", "mu",
                                            "r_eff")},
        active=t("active", torch.bool), count=t("count", torch.int32))


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cell_slots(cells: SortedCells):
    """(N, 3) cell coordinates and (N,) slots (rank in the cell) of the
    sorted bodies; every slot must lie below the capacity."""
    cell = _np(cells.cell).astype(np.int64)
    slot = np.arange(len(cell)) - _np(cells.start).astype(np.int64)[cell]
    if (slot >= cells.capacity).any():
        raise ValueError("a cell holds more bodies than the capacity")
    _, ny, nz = cells.dims
    return np.stack([cell // (ny * nz), (cell // nz) % ny, cell % nz], 1), \
        slot


def _k27(d):
    """Index of the neighbour offset d ∈ {−1, 0, 1}³ in the dense
    lattice's order (dx-major, then dy, then dz)."""
    return ((d[:, 0] + 1) * 3 + (d[:, 1] + 1)) * 3 + (d[:, 2] + 1)


def nsc_gamma_to_dense(gam, wgam, partners, cells: SortedCells):
    """The port's single-sided multipliers γ (3, N, P) and wall multipliers
    (3, N, W) of the cell-sorted bodies as the JAX dense reference holds
    them: ``(dense (nx, ny, nz, 27, 3, C, C), wdense (nx, ny, nz, C, W,
    3))`` float32 numpy arrays, C the capacity.  Each contact is written on
    both sides; the partner's copy is (γn, γu, −γv), since its tangents are
    −t1 and t2."""
    g, wg, part = _np(gam), _np(wgam), _np(partners)
    ijk, slot = _cell_slots(cells)
    C, W = cells.capacity, wg.shape[2]
    dense = np.zeros(tuple(cells.dims) + (27, 3, C, C), np.float32)
    wdense = np.zeros(tuple(cells.dims) + (C, W, 3), np.float32)
    o, p = np.nonzero(part >= 0)
    j = part[o, p].astype(np.int64)
    d = ijk[j] - ijk[o]
    for comp, sign in ((0, 1.0), (1, 1.0), (2, -1.0)):
        dense[ijk[o, 0], ijk[o, 1], ijk[o, 2], _k27(d), comp, slot[o],
              slot[j]] = g[comp, o, p]
        dense[ijk[j, 0], ijk[j, 1], ijk[j, 2], _k27(-d), comp, slot[j],
              slot[o]] = sign * g[comp, o, p]
    wdense[ijk[:, 0], ijk[:, 1], ijk[:, 2], slot] = wg.transpose(1, 2, 0)
    return dense, wdense


def nsc_gamma_from_dense(dense, wdense, partners, cells: SortedCells):
    """The inverse of :func:`nsc_gamma_to_dense`, read from the owner's
    copy: ``(γ (3, N, P), wγ (3, N, W))`` float32 CPU tensors, 0 in the
    empty slots."""
    dense, wdense, part = _np(dense), _np(wdense), _np(partners)
    ijk, slot = _cell_slots(cells)
    g = np.zeros((3,) + part.shape, np.float32)
    o, p = np.nonzero(part >= 0)
    j = part[o, p].astype(np.int64)
    k = _k27(ijk[j] - ijk[o])
    for comp in range(3):
        g[comp, o, p] = dense[ijk[o, 0], ijk[o, 1], ijk[o, 2], k, comp,
                              slot[o], slot[j]]
    wg = wdense[ijk[:, 0], ijk[:, 1], ijk[:, 2], slot].transpose(2, 0, 1)
    return torch.from_numpy(g), torch.from_numpy(np.ascontiguousarray(wg))


# ------------------------------------------------------------- vehicles

TIRE_PARAMS = {"tmeasy": tr.TMeasyParams, "fiala": tr.FialaParams,
               "pac89": tr.Pac89Params, "pac02": tr.Pac02Params,
               "tmsimple": tr.TMsimpleParams}


def _float_fields(cls, leaves: Mapping[str, Any], device, nested=None,
                  skip=()):
    """The constructor arguments of a dataclass of float32 tensors on
    ``device`` from its numpy leaves (the JAX package keeps numbers as
    float32 arrays or Python floats); ``nested`` maps a field to the class
    its mapping builds; static fields keep their Python type (tuples of
    ints for body indices); fields in ``skip`` are left out."""
    nested = nested or {}
    kw = {}
    for f in fields(cls):
        if not f.init or f.name not in leaves or f.name in skip:
            continue
        v = leaves[f.name]
        if f.name in nested:
            kw[f.name] = nested[f.name](**_float_fields(nested[f.name], v,
                                                        device))
        elif is_static(f):
            a = np.asarray(v)
            kw[f.name] = (tuple(int(i) for i in a.reshape(-1))
                          if isinstance(f.default, tuple) else int(a))
        else:
            kw[f.name] = torch.as_tensor(np.array(v, np.float32),
                                         device=device)
    return kw


def _float_carrier(cls, leaves: Mapping[str, Any], device, nested=None):
    return cls(**_float_fields(cls, leaves, device, nested))


def tire_params_from_numpy(kind: str, leaves: Mapping[str, Any], *, device):
    """A tire model's parameters (``kind``: tmeasy, fiala, pac89, pac02,
    tmsimple) from the JAX parameter class's fields."""
    return _float_carrier(TIRE_PARAMS[kind], leaves, device)


def tmeasy_params_from_numpy(leaves: Mapping[str, Any], *, device):
    return tire_params_from_numpy("tmeasy", leaves, device=device)


def powertrain_params_from_numpy(leaves: Mapping[str, Any], *, device
                                 ) -> PowertrainParams:
    return _float_carrier(PowertrainParams, leaves, device)


def wheeled_vehicle_from_numpy(leaves: Mapping[str, Any], *, device
                               ) -> WheeledVehicle:
    """``WheeledVehicle`` from the JAX one's leaves: ``model`` as for
    :func:`mbs_model_from_numpy` (shafts included), ``tire`` TMeasy,
    ``powertrain``, the scalars, and the static ``chassis`` / ``wheels`` /
    ``knuckles``."""
    return WheeledVehicle(
        model=mbs_model_from_numpy(leaves["model"], device=device),
        tire=tmeasy_params_from_numpy(leaves["tire"], device=device),
        powertrain=powertrain_params_from_numpy(leaves["powertrain"],
                                                device=device),
        **_float_fields(WheeledVehicle, leaves, device,
                        skip=("model", "tire", "powertrain")))


def scm_params_from_numpy(leaves: Mapping[str, Any], *, device
                          ) -> SCMParams:
    return _float_carrier(SCMParams, leaves, device)


def scm_state_from_numpy(leaves: Mapping[str, Any], *, device) -> SCMState:
    return _float_carrier(SCMState, leaves, device)


def rover_from_numpy(leaves: Mapping[str, Any], *, device):
    """``models.rover.Rover`` from the JAX one's leaves (``model`` as for
    :func:`mbs_model_from_numpy`)."""
    return Rover(model=mbs_model_from_numpy(leaves["model"], device=device),
                 **_float_fields(Rover, leaves, device, skip=("model",)))


DRIVERS = {"SpeedController": drv.SpeedController,
           "PathFollower": drv.PathFollower, "DataDriver": drv.DataDriver,
           "HumanDriver": drv.HumanDriver}


def driver_from_numpy(name: str, leaves: Mapping[str, Any], *, device):
    """A controller of ``vehicle.driver`` (``name``: SpeedController,
    PathFollower, DataDriver, HumanDriver) from the JAX one's fields, its
    ``PIDState`` as a nested mapping."""
    return _float_carrier(DRIVERS[name], leaves, device,
                          nested={"state": drv.PIDState})


# ------------------------------------------------- tracked vehicles, misc

def tracked_vehicle_from_numpy(leaves: Mapping[str, Any], *, device
                               ) -> TrackedVehicle:
    """``TrackedVehicle`` from the JAX one's leaves: ``model`` as for
    :func:`mbs_model_from_numpy`, ``track`` the ``TrackParams`` fields
    (``n_patches`` static), the scalars, and the static ``chassis`` /
    ``sprockets``."""
    return TrackedVehicle(
        model=mbs_model_from_numpy(leaves["model"], device=device),
        track=_float_carrier(TrackParams, leaves["track"], device),
        **_float_fields(TrackedVehicle, leaves, device,
                        skip=("model", "track")))


def _plain(v):
    """A host value of a NamedTuple carrier: lists and tuples as tuples
    of Python numbers, arrays and scalars as Python numbers."""
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    a = np.asarray(v)
    if a.ndim:
        return tuple(_plain(x) for x in a)
    return a.item()


def _host_tuple(cls, leaves: Mapping[str, Any], lists=()):
    kw = {k: _plain(leaves[k]) for k in cls._fields if k in leaves}
    for k in lists:
        kw[k] = list(kw[k])
    return cls(**kw)


def segmented_track_from_numpy(leaves: Mapping[str, Any]
                               ) -> ts.SegmentedTrack:
    """``vehicle.track_shoes.SegmentedTrack`` (host values: body ids, pitch,
    radius, half extents) from the JAX one's fields."""
    return _host_tuple(ts.SegmentedTrack, leaves, lists=("shoes",))


def double_pin_track_from_numpy(leaves: Mapping[str, Any]
                                ) -> ts.DoublePinTrack:
    return _host_tuple(ts.DoublePinTrack, leaves,
                       lists=("shoes", "connectors"))


def sprocket_gear_from_numpy(leaves: Mapping[str, Any]) -> ts.SprocketGear:
    """``vehicle.track_shoes.SprocketGear`` (host values) from the JAX
    one's fields."""
    return _host_tuple(ts.SprocketGear, leaves)


def profile2d_from_numpy(leaves: Mapping[str, Any], *, device
                         ) -> p2d.Profile2D:
    """``collision.profile2d.Profile2D``: the body and the frame as host
    values, the elements as float32 tensors on ``device``."""
    host = ("body", "frame_rot", "frame_pos")
    return p2d.Profile2D(
        **{k: _plain(leaves[k]) for k in host},
        **{k: torch.as_tensor(np.asarray(leaves[k], np.float32),
                              device=device)
           for k in p2d.Profile2D._fields if k not in host})


def profile_circles_from_numpy(leaves: Mapping[str, Any], *, device
                               ) -> p2d.ProfileCircles:
    return p2d.ProfileCircles(
        body=torch.as_tensor(np.asarray(leaves["body"], np.int32),
                             device=device),
        **{k: torch.as_tensor(np.asarray(leaves[k], np.float32),
                              device=device)
           for k in ("offset", "radius", "mu")})


def hydraulic_params_from_numpy(leaves: Mapping[str, Any], *, device
                                ) -> HydraulicParams:
    return _float_carrier(HydraulicParams, leaves, device)


ROTATION_FUNCTIONS = {cls.__name__: cls for cls in (
    RF.RotConst, RF.RotAxisAngle, RF.RotSlerp, RF.RotABC)}


def rotation_function_from_numpy(leaves: Mapping[str, Any], *, device):
    """A ``core.rotation_functions`` function from ``{"class": name, field:
    value, …}``: arrays become float32 tensors on ``device``, a scalar
    program (``angle``, ``fa``, ``fb``, ``fc``) a mapping as for
    :func:`motion_function_from_numpy`."""
    cls = ROTATION_FUNCTIONS[leaves["class"]]
    kw = {}
    for f in fields(cls):
        v = leaves[f.name]
        kw[f.name] = (motion_function_from_numpy(v, device=device)
                      if isinstance(v, Mapping) else torch.as_tensor(
                          np.array(v, np.float32), device=device))
    return cls(**kw)


# ------------------------------------------------------ robots and sensors

def arm6r_from_numpy(leaves: Mapping[str, Any], *, device) -> Arm6R:
    """``models.industrial.Arm6R`` (float32 lengths, base pose) from the
    JAX one's fields."""
    return _float_carrier(Arm6R, leaves, device)


def arm_scara_from_numpy(leaves: Mapping[str, Any], *, device) -> ArmSCARA:
    """``models.industrial.ArmSCARA`` from the JAX one's fields (the static
    ``right_elbow`` a bool)."""
    return ArmSCARA(**_float_fields(ArmSCARA, leaves, device,
                                    skip=("right_elbow",)),
                    right_elbow=bool(np.asarray(leaves["right_elbow"])))


def trajectory_from_numpy(leaves: Mapping[str, Any], *, device
                          ) -> Trajectory:
    """``models.industrial.Trajectory`` from the JAX one's fields (the
    static ``law`` a string)."""
    return Trajectory(**_float_fields(Trajectory, leaves, device,
                                      skip=("law",)),
                      law=str(np.asarray(leaves["law"])))


def copter_from_numpy(leaves: Mapping[str, Any], *, device) -> Copter:
    """``models.robots.Copter`` from the JAX one's leaves (``model`` as for
    :func:`mbs_model_from_numpy`, the static ``body``)."""
    return Copter(model=mbs_model_from_numpy(leaves["model"], device=device),
                  **_float_fields(Copter, leaves, device, skip=("model",)))


def turtlebot_from_numpy(leaves: Mapping[str, Any], *, device) -> Turtlebot:
    """``models.robots.Turtlebot`` from the JAX one's leaves (``model`` as
    for :func:`mbs_model_from_numpy`, the static ``chassis`` and
    ``wheels``)."""
    return Turtlebot(
        model=mbs_model_from_numpy(leaves["model"], device=device),
        **_float_fields(Turtlebot, leaves, device, skip=("model",)))


def noise_model_from_numpy(leaves: Mapping[str, Any], *, device
                           ) -> sensors.NoiseModel:
    return _float_carrier(sensors.NoiseModel, leaves, device)


def imu_from_numpy(leaves: Mapping[str, Any], *, device
                   ) -> sensors.IMUSensor:
    """``sensors.IMUSensor`` from the JAX one's fields, its two noise
    models as nested mappings."""
    return _float_carrier(sensors.IMUSensor, leaves, device, nested={
        "accel_noise": sensors.NoiseModel, "gyro_noise": sensors.NoiseModel})


def gps_from_numpy(leaves: Mapping[str, Any], *, device
                   ) -> sensors.GPSSensor:
    return _float_carrier(sensors.GPSSensor, leaves, device,
                          nested={"noise": sensors.NoiseModel})


def ray_scene_from_numpy(leaves: Mapping[str, Any], *, device
                         ) -> sensors.RayScene:
    """``sensors.RayScene`` from the JAX one's fields; an absent family
    (None) stays absent."""
    return sensors.RayScene(**{
        f.name: torch.as_tensor(np.asarray(leaves[f.name], np.float32),
                                device=device)
        for f in fields(sensors.RayScene) if _present(leaves.get(f.name))})
