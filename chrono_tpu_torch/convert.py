"""Build the port's parameter objects from the JAX package's leaves.

The JAX package keeps ``DEMParams`` / ``DEMMaterial`` / ``PlaneBCs`` /
``GridSpec`` as pytrees of arrays and static fields.  A caller that holds
them flattens each into a mapping of field name → numpy array or Python
scalar (nested mappings for the two materials); these functions turn such
mappings into the port's objects.  So this package never sees JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.dem.bc import PlaneBCs
from chrono_tpu_torch.dem.params import DEMMaterial, DEMParams


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
