"""PyTorch port (chrono_tpu_torch) vs the JAX package: whole settling-box
advances (bin, fused substeps, rebin, unbin) on the 120-particle scenes of
tests/test_pallas_kernel.py, at the tolerances that file holds the JAX
backends to.  On the CPU the port's kernels run their plain twins."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chrono_tpu.dem.cell_dense import make_cell_dense_advance

from chrono_tpu_torch.dem import cell_dense as t_cd

from test_torch_cell_dense import _port, _scene


@functools.cache
def _jax_xla_advance(friction_mode):
    pos, params, bcs, grid = _scene(7, friction_mode)
    adv = make_cell_dense_advance(params, bcs, grid, backend="xla",
                                  capacity=16)
    z = jnp.zeros(pos.shape)
    p, v, o, ovf = adv(jnp.asarray(pos), z, z, 3)
    assert int(ovf) == 0
    return np.asarray(p), np.asarray(v), np.asarray(o)


@pytest.mark.parametrize("migrate", [False, True])
@pytest.mark.parametrize("friction_mode", ["frictionless", "single_step"])
def test_advance_matches_jax_xla(friction_mode, migrate):
    """3 cycles × 4 substeps: the port tracks the JAX xla backend at the
    tolerances of test_flat_advance_parity."""
    pos, params, bcs, grid = _scene(7, friction_mode)
    adv = t_cd.make_cell_dense_advance(*_port(params, bcs, grid),
                                       capacity=16, migrate=migrate,
                                       device="cpu")
    z = np.zeros_like(pos)
    p, v, o, ovf = adv(pos, z, z, 3)
    assert int(ovf) == 0
    px, vx, ox = _jax_xla_advance(friction_mode)
    assert np.abs(vx).max() > 0.05
    np.testing.assert_allclose(p.numpy(), px, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), vx, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(o.numpy(), ox, rtol=1e-3, atol=1e-4)


def test_migrate_matches_sort_rebin():
    """6 cycles on the test_flat_migrate_parity scene: migration and the
    full sort rebin are both pure data movement between identical
    substeps, so they agree to the bounds that test demands of JAX."""
    pos, params, bcs, grid = _scene(11)
    port = _port(params, bcs, grid)
    z = np.zeros_like(pos)
    ps, vs, os_, ovs = t_cd.make_cell_dense_advance(
        *port, capacity=16, migrate=False, device="cpu")(pos, z, z, 6)
    pm, vm, om, ovm = t_cd.make_cell_dense_advance(
        *port, capacity=16, migrate=True, device="cpu")(pos, z, z, 6)
    assert int(ovs) == 0 and int(ovm) == 0
    # particles crossed cell faces, so the migration moved data
    cells0 = t_cd.to_cells(port[2], 16, torch.from_numpy(pos), ps, ps).perm
    cells1 = t_cd.to_cells(port[2], 16, ps, ps, ps).perm
    assert (cells0 // 16 != cells1 // 16).any()
    np.testing.assert_allclose(pm.numpy(), ps.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(vm.numpy(), vs.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(om.numpy(), os_.numpy(), rtol=1e-6,
                               atol=1e-6)

