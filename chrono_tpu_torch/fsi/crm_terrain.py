"""CRM deformable terrain: the box terrain patch.

Counterpart of part of ``chrono_tpu/fsi/crm_terrain.py``:
``make_crm_terrain_state`` (granular bed with lithostatic pre-stress, wall
BCE floor and side layers, and the neighbour grid over it).  The vehicle
coupling (rigid BCE markers, ``crm_fsi_step``,
``make_crm_fsi_advance_persistent``) needs the multibody core and comes
with the vehicle slice; terrain alone runs on
``fsi.sph.crm_pencil.make_crm_advance_pencil``.
"""

from __future__ import annotations

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.fsi import bce
from chrono_tpu_torch.fsi.sph.crm import (
    CRMParams, CRMState, lithostatic_init, make_crm_state,
)
from chrono_tpu_torch.fsi.sph.kernels import KERNELS
from chrono_tpu_torch.fsi.sph.system import make_sph_state
from chrono_tpu_torch.utils.samplers import grid_sample_box


def make_crm_terrain_state(params, crm: CRMParams, size, depth,
                           spacing=None, rigid_pts=None, rigid_body_ids=None,
                           rigid_local=None, carve_fn=None, surface_fn=None,
                           air: float = 30.0, margin: float = 6.0,
                           dtype=torch.float32, *,
                           device) -> tuple[CRMState, GridSpec]:
    """Box terrain patch: granular bed (lithostatic pre-stress) and wall BCE
    floor and side layers, on ``device``.

    ``size``: (Lx, Ly); ``depth``: bed depth; ``carve_fn(pts) -> keep
    mask`` removes granular markers; ``surface_fn(x, y) -> z`` shapes the
    bed surface from a heightmap (depths measured up to min(depth,
    surface)); ``air``: headroom above the bed in d0 units covered by the
    grid (and by the side walls, capped at 20·d0); ``margin``: the grid's
    margin beyond the bed box, in d0 units.  Rigid BCE markers
    (``rigid_pts``) are not ported and raise.  Returns (CRMState, GridSpec).
    """
    d0 = float(spacing if spacing is not None else params.d0)
    Lx, Ly = float(size[0]), float(size[1])
    H = float(depth)
    gran = grid_sample_box((0, 0, 0), (Lx, Ly, H), d0)
    if surface_fn is not None:
        zs = np.asarray(surface_fn(gran[:, 0], gran[:, 1]), float)
        gran = gran[gran[:, 2] < zs]
    if carve_fn is not None:
        gran = gran[np.asarray(carve_fn(gran), bool)]
    walls = bce.box_wall_markers(
        (0, 0, 0), (Lx, Ly, H + min(20.0, float(air)) * d0), d0,
        layers=3, top_open=True)
    sph = make_sph_state(params, gran, boundary_pts=walls,
                         rigid_pts=rigid_pts, rigid_body_ids=rigid_body_ids,
                         rigid_local=rigid_local, dtype=dtype, device=device)
    state = make_crm_state(sph, dtype)
    if surface_fn is None:
        surface = H
    else:
        # heightmap bed: per-marker lithostatic depth to the local surface
        pos = state.pos.cpu().numpy()
        surface = torch.as_tensor(
            np.minimum(np.asarray(surface_fn(pos[:, 0], pos[:, 1]), float),
                       H), dtype=dtype, device=device)
    state = lithostatic_init(state, params, crm, surface_z=surface)

    cell = KERNELS[params.kernel][2] * float(params.h)
    margin = float(margin) * d0
    zmax = H + float(air) * d0
    dims = (int(np.ceil((Lx + 2 * margin) / cell)),
            int(np.ceil((Ly + 2 * margin) / cell)),
            int(np.ceil((zmax + 2 * margin) / cell)))
    grid = GridSpec(origin=(-margin, -margin, -margin), cell_size=cell,
                    dims=dims)
    return state, grid
