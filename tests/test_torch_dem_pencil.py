"""PyTorch port (chrono_tpu_torch) vs the JAX package: kernel K1 against
the TPU kernel ``dem_pencil_substep_pallas`` (the ``pencil`` backend), one
substep, in interpret mode on the CPU, where K1 runs its plain twin.
Tolerances are those of tests/test_pallas_kernel.py
``test_pencil_advance_backend_parity``.
"""

import numpy as np
import jax.numpy as jnp

from chrono_tpu.dem.cell_dense import (
    field_to_pencils, pallas_static_coefs, pencils_to_particles, to_cells,
)
from chrono_tpu.ops.pallas.dem_pencil_kernel import (
    dem_pencil_substep_pallas, edge_ok_xy,
)

from test_torch_dem_backends import (
    fused_kw, k1_substep, kernel_scene, per_particle_close,
)


def test_k1_matches_pencil_substep_kernel():
    """One substep on the 4 × 4 × 4 scene with box walls and gravity: K1's
    twin against ``dem_pencil_substep_pallas`` in interpret mode."""
    params, bcs, grid, pos, vel, omega = kernel_scene("single_step")
    params = params.replace(gravity=jnp.asarray([0.0, 0.0, -9.81]))
    field = to_cells(grid, 8, *(jnp.asarray(a) for a in (pos, vel, omega)))
    out = dem_pencil_substep_pallas(
        field_to_pencils(field, 128), edge_ok_xy(grid.dims),
        grid_dims=grid.dims, C=8, Bxy=4, interpret=True,
        **pallas_static_coefs(params), **fused_kw(params, bcs))
    ref = [np.asarray(a) for a in
           pencils_to_particles(out, field, grid.dims, 8, grid.dims[2])]
    got = k1_substep(params, bcs, grid, pos, vel, omega)
    assert np.abs(ref[1] - vel).max() > 1e-3
    per_particle_close(got, ref)
