"""WCSPH right-hand side: so far only the marker mass.

Counterpart of part of ``chrono_tpu/fsi/sph/wcsph.py``: ``particle_mass``,
which the BCE force reduction (``fsi.bce.rigid_body_forces``) reads.  The
gather backend's passes (``adami_bc``, ``wcsph_rhs``) come with ROADMAP
Queue 1 item 3; the cell-sorted sweeps of ``ops.cuda.sph_substep`` run the
dam break.
"""

from __future__ import annotations


def particle_mass(params) -> float:
    """ρ0 · d0³, the mass of one marker."""
    return params.rho0 * params.d0 ** 3
