"""Build the port's parameter objects from the JAX package's leaves.

The JAX package keeps ``DEMParams`` / ``DEMMaterial`` / ``PlaneBCs`` /
``GridSpec`` / ``SPHParams`` / ``SPHState`` / ``CRMParams`` / ``CRMState``
as pytrees of arrays and static fields.  A caller that holds them flattens
each into a mapping of field name → numpy array or Python scalar (nested
mappings for the two materials); these functions turn such mappings into
the port's objects.
So this package never sees JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.dem.bc import PlaneBCs
from chrono_tpu_torch.dem.params import DEMMaterial, DEMParams
from chrono_tpu_torch.fsi.sph.crm import CRMParams, CRMState
from chrono_tpu_torch.fsi.sph.state import SPHParams, SPHState


def _scalar(x) -> float:
    return float(np.asarray(x))


def material_from_numpy(leaves: Mapping[str, Any]) -> DEMMaterial:
    return DEMMaterial(youngs=_scalar(leaves["youngs"]),
                       poisson=_scalar(leaves["poisson"]),
                       restitution=_scalar(leaves["restitution"]),
                       mu_s=_scalar(leaves["mu_s"]))


def params_from_numpy(leaves: Mapping[str, Any]) -> DEMParams:
    """``DEMParams`` from the JAX ``DEMParams`` fields.  The fields that
    the cell-slot path does not read (neighbour-list capacities, rolling
    resistance, integrator choice) are not carried over."""
    if leaves.get("force_model", "mat_based") != "mat_based":
        raise NotImplementedError("only the mat_based force model is ported")
    return DEMParams(
        radius=_scalar(leaves["radius"]), mass=_scalar(leaves["mass"]),
        material=material_from_numpy(leaves["material"]),
        wall_material=material_from_numpy(leaves["wall_material"]),
        gravity=tuple(float(g) for g in np.asarray(leaves["gravity"])),
        dt=_scalar(leaves["dt"]),
        rebuild_every=int(leaves["rebuild_every"]),
        friction_mode=str(leaves["friction_mode"]))


def planes_from_numpy(leaves: Mapping[str, Any]) -> PlaneBCs:
    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    return PlaneBCs(point=t(leaves["point"]), normal=t(leaves["normal"]),
                    vel=t(leaves["vel"]))


def grid_from_numpy(leaves: Mapping[str, Any]) -> GridSpec:
    return GridSpec(origin=tuple(float(o) for o in leaves["origin"]),
                    cell_size=float(leaves["cell_size"]),
                    dims=tuple(int(d) for d in leaves["dims"]),
                    periodic=tuple(bool(p) for p in
                                   leaves.get("periodic", (False,) * 3)))


def sph_params_from_numpy(leaves: Mapping[str, Any]) -> SPHParams:
    """``SPHParams`` from the JAX ``SPHParams`` fields (floats as numpy
    scalars, gravity as a (3,) array, the static fields as they are).  The
    neighbour-list capacities of the gather backend are not carried over;
    density reinitialisation is not ported and is refused."""
    if int(leaves.get("density_reinit_every", 0)) != 0:
        raise NotImplementedError("density reinitialisation is not ported")
    floats = ("d0", "h", "rho0", "mu", "c_s", "dt", "eos_gamma",
              "alpha_visc", "delta_sph", "xsph_eps")
    static = ("kernel", "viscosity_model", "boundary_model", "shifting",
              "rebuild_every", "integrator")
    return SPHParams(
        gravity=tuple(float(g) for g in np.asarray(leaves["gravity"])),
        **{k: _scalar(leaves[k]) for k in floats},
        **{k: leaves[k] for k in static if k in leaves})


def sph_state_from_numpy(leaves: Mapping[str, Any], *, device) -> SPHState:
    """``SPHState`` on ``device`` from the JAX ``SPHState`` fields (its
    neighbour list, if given, is not carried over)."""
    def t(name, dtype):
        return torch.as_tensor(np.array(leaves[name]), dtype=dtype,
                               device=device)

    return SPHState(pos=t("pos", torch.float32), vel=t("vel", torch.float32),
                    rho=t("rho", torch.float32), kind=t("kind", torch.int32),
                    body_id=t("body_id", torch.int32),
                    bce_local=t("bce_local", torch.float32),
                    time=t("time", torch.float32))


def crm_params_from_numpy(leaves: Mapping[str, Any]) -> CRMParams:
    """``CRMParams`` from the JAX ``CRMParams`` fields.  Dilatancy is read
    by nothing (the return is non-associated) and a non-zero one is
    refused."""
    if _scalar(leaves.get("dilatancy", 0.0)) != 0.0:
        raise NotImplementedError("dilatancy (tan ψ ≠ 0) is not ported")
    return CRMParams(**{f: _scalar(leaves[f]) for f in (
        "youngs", "poisson", "friction_angle", "cohesion") if f in leaves})


def crm_state_from_numpy(leaves: Mapping[str, Any], *, device) -> CRMState:
    """``CRMState`` on ``device`` from the JAX ``CRMState`` fields (its
    neighbour list, if given, is not carried over)."""
    def t(name, dtype):
        return torch.as_tensor(np.array(leaves[name]), dtype=dtype,
                               device=device)

    return CRMState(**{f: t(f, torch.float32) for f in (
        "pos", "vel", "rho", "bce_local", "tau_d", "tau_o", "time")},
        kind=t("kind", torch.int32), body_id=t("body_id", torch.int32))
