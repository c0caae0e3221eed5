"""PyTorch port (chrono_tpu_torch) vs the JAX package: kernel K1 against
the TPU kernel ``dem_sym_substep_pallas`` (the ``sym`` backend and
``__graft_entry__.entry()``), one substep, in interpret mode on the CPU,
where K1 runs its plain twin.  Tolerances are those of
tests/test_pallas_kernel.py ``test_sym_advance_parity``.
"""

import numpy as np
import jax.numpy as jnp

from chrono_tpu.collision.cell_list import GridSpec
from chrono_tpu.dem.cell_dense import (
    field_to_pencils, pallas_static_coefs, pencils_to_particles, to_cells,
)
from chrono_tpu.ops.pallas.dem_sym_kernel import (
    dem_sym_substep_pallas, edge_ok_fwd,
)

from test_torch_dem_backends import fused_kw, k1_substep, per_particle_close


def test_k1_matches_sym_kernel_on_graft_scene():
    """One substep of the scene ``__graft_entry__.entry()`` compiles (729
    particles of r = 5 cm in a unit box, 7³ cells of 1.45 d, C = 8, box
    walls, gravity), with random velocities and spins: K1's twin against
    ``dem_sym_substep_pallas`` in interpret mode, called as entry() calls
    it but with interpret=True."""
    import __graft_entry__ as graft

    sys_ = graft._small_dem()
    params, bcs = sys_.params, sys_.bcs
    cell = 1.45 * 2 * float(params.radius)
    dims = (int(np.ceil(1.0 / cell)),) * 3
    grid = GridSpec(origin=(0.0, 0.0, 0.0), cell_size=cell, dims=dims)
    pos = np.asarray(sys_.state.pos)
    rng = np.random.default_rng(8)
    vel = rng.normal(0, 0.2, pos.shape).astype(np.float32)
    omega = rng.normal(0, 5.0, pos.shape).astype(np.float32)
    field = to_cells(grid, 8, *(jnp.asarray(a) for a in (pos, vel, omega)))
    assert int(field.overflow) == 0
    nzp = ((dims[2] + 1 + 127) // 128) * 128
    out = dem_sym_substep_pallas(
        field_to_pencils(field, nzp), edge_ok_fwd(dims), grid_dims=dims,
        C=8, Bxy=8, interpret=True, **pallas_static_coefs(params),
        **fused_kw(params, bcs))
    ref = [np.asarray(a) for a in
           pencils_to_particles(out, field, dims, 8, dims[2])]
    got = k1_substep(params, bcs, grid, pos, vel, omega)
    assert np.abs(ref[1] - vel).max() > 1e-3          # contacts resolved
    per_particle_close(got, ref)
