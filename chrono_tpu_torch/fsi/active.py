"""Active domains and the moving patch: spatial scaling for CRM and FSI.

Counterpart of ``chrono_tpu/fsi/active.py`` (the reference's activity boxes
around each FSI solid, and its moving-patch particle relocator).  The
markers inside an extended box around an anchor are gathered into a buffer
of a fixed ``capacity`` (one stable sort a call), the solver runs on that
buffer, and the results scatter back; extended-only granular markers enter
as FROZEN neighbours, not integrated.  Cost a substep scales with
``capacity`` instead of the whole marker count.  Every function runs on
its tensors' device with no host sync.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from chrono_tpu_torch.fsi.sph.state import FLUID, FROZEN, RIGID_BCE


@dataclass(frozen=True)
class ActiveDomainSpec:
    """The per-body activity boxes.

    ``box``: (3,) half-extents of the strict active box around each anchor;
    ``margin``: (3,) extra half-width of the extended box (at least the
    kernel support, so frozen neighbours fully pad the active set);
    ``capacity``: the compact buffer's size, a plain int."""

    box: torch.Tensor
    margin: torch.Tensor
    capacity: int = 4096


class CompactSet(NamedTuple):
    idx: torch.Tensor        # (capacity,) gathered marker indices (unique)
    strict: torch.Tensor     # (capacity,) bool: integrate this marker
    count: torch.Tensor      # () int32: extended-active markers
    overflow: torch.Tensor   # () int32: max(count − capacity, 0)


def activity_masks(spec: ActiveDomainSpec, pos, kind, anchors):
    """(strict, extended) masks of the markers; ``anchors`` (B, 3) are the
    FSI solids' positions.  Granular markers are boxed; RIGID_BCE markers
    are always active; walls take part when inside the extended box."""
    det = torch.abs(pos[:, None, :] - anchors[None, :, :])     # (N, B, 3)
    box = spec.box.to(pos)
    in_strict = torch.any(torch.all(det <= box, dim=-1), dim=1)
    in_ext = torch.any(torch.all(det <= box + spec.margin.to(pos), dim=-1),
                       dim=1)
    is_rigid = kind == RIGID_BCE
    return in_strict | is_rigid, in_ext | is_rigid


def compact_indices(spec: ActiveDomainSpec, ext):
    """``(idx, count, overflow)``: a stable sort puts the extended-active
    markers first; the buffer takes the first ``capacity`` (far markers
    fill any slack and enter as FROZEN).  ``overflow`` () int32 is the
    excess of the extended-active count over the capacity."""
    order = torch.argsort((~ext).to(torch.int8), stable=True)
    idx = order[: spec.capacity]
    count = ext.sum().to(torch.int32)
    overflow = torch.clamp(count - spec.capacity, min=0).to(torch.int32)
    return idx, count, overflow


def _per_marker(state, n):
    """The per-marker tensor fields (not the neighbour list, which the
    gather engine rebuilds on the sub-state before any use)."""
    return [f.name for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)
            and getattr(state, f.name).dim() >= 1
            and getattr(state, f.name).shape[0] == n]


def gather_state(state, idx, strict):
    """The compact sub-state: every per-marker field gathered on ``idx``;
    gathered granular markers outside the strict set become FROZEN."""
    n = strict.shape[0]
    sub = state.replace(**{f: getattr(state, f)[idx]
                           for f in _per_marker(state, n)})
    frozen = (sub.kind == FLUID) & ~strict[idx]
    return sub.replace(kind=torch.where(frozen, FROZEN, sub.kind))


def scatter_state(full, sub, idx):
    """Write the compact results back; ``kind`` keeps the full state's
    codes (FROZEN was a view of the buffer) and ``time`` is the buffer's."""
    n = full.pos.shape[0]
    changes = {}
    for f in _per_marker(full, n):
        if f == "kind":
            continue
        out = getattr(full, f).clone()
        out[idx] = getattr(sub, f)
        changes[f] = out
    return full.replace(**changes, time=sub.time)


def relocate_patch_x(state, x_front, patch_length: float, surface_z: float,
                     params, crm=None):
    """Moving-patch relocation along +x: granular markers more than
    ``patch_length`` behind ``x_front`` move forward by ``patch_length``
    and arrive at rest, at ρ0, and (with ``crm``, on a CRM state) with the
    lithostatic stress of their new depth.  Returns (state, n_moved)."""
    move = (state.kind == FLUID) & (state.pos[:, 0] < x_front - patch_length)
    pos = state.pos.clone()
    pos[:, 0] = pos[:, 0] + torch.where(move, patch_length, 0.0).to(pos)
    vel = torch.where(move[:, None], 0.0, state.vel)
    rho = torch.where(move, float(params.rho0), state.rho)
    out = state.replace(pos=pos, vel=vel, rho=rho)
    if crm is not None and hasattr(state, "tau_d"):
        g = abs(float(params.gravity[2]))
        depth = torch.clamp(surface_z - pos[:, 2], min=0.0)
        szz = -float(params.rho0) * g * depth
        K0 = crm.poisson / (1.0 - crm.poisson)
        tau_new = torch.stack([K0 * szz, K0 * szz, szz], dim=-1)
        out = out.replace(
            tau_d=torch.where(move[:, None], tau_new, state.tau_d),
            tau_o=torch.where(move[:, None], 0.0, state.tau_o))
    return out, move.sum().to(torch.int32)
