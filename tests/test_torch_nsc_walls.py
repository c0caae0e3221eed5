"""PyTorch port vs the JAX package: the NSC stepper with a spinning drum and
with a dynamic blade.

The second half of tests/test_torch_nsc.py's whole-advance cases, in a file
of their own so that each file stays short on one CPU core: every distinct
scene compiles the JAX dense reference (``make_nsc_pencil_advance(backend=
"xla")``) anew, about 10 s on one core.
"""

import numpy as np

from chrono_tpu.solver import nsc_pencil as jn

from chrono_tpu_torch.collision.cell_list import GridSpec

from test_torch_nsc import R, V_ATOL, W_ATOL, X_ATOL, _both


def _drum():
    grid = GridSpec(cell_size=2.1 * R, dims=(8, 4, 8))
    cx, cz = 4 * 2.1 * R, 4 * 2.1 * R
    walls = (("cyl", 1, (cx, 0.0, cz), 3.5 * 2.1 * R, 3.0, 0.5),
             ("plane", (0.0, 1.0, 0.0), 0.0, (0.0, 0.0, 0.0), 0.2),
             ("plane", (0.0, -1.0, 0.0), -4 * 2.1 * R, (0.0, 0.0, 0.0), 0.2))
    rng = np.random.default_rng(7)
    n = 30
    pos = np.stack([rng.uniform(cx - 0.2, cx + 0.2, n),
                    rng.uniform(0.1, 0.3, n),
                    rng.uniform(0.12, 0.3, n)], axis=1)
    p = jn.NSCPencilParams(radius=R, mass=0.2, mu=0.5, dt=2e-3, n_iter=30,
                           envelope=0.002 * R)
    return p, grid, walls, pos, np.zeros((n, 3)), 2, {}




def test_dynamic_blade_matches_dense_reference():
    """The dynamic blade of tests/test_nsc_dynamic_blade.py (the spin a
    solver variable) at its tolerances, with the wall reactions and the Δγ
    series of the last step (the two spheres touch only walls, so the port's
    single-sided Δγ and the dense reference's are the same norm)."""
    cell = 2.1 * R
    grid = GridSpec(cell_size=cell, dims=(6, 6, 4))
    c = (3 * cell, 3 * cell, R)
    walls = (("plane", (0.0, 0.0, 1.0), 0.0, (0.0, 0.0, 0.0), 0.4),
             ("rotbox", 2, c, (2.2 * R, 0.8 * R, 1.2 * R), 0.0, 0.3))
    p = jn.NSCPencilParams(radius=R, mass=0.2, mu=0.3, dt=1e-3, n_iter=30,
                           envelope=0.1 * R, omega=0.3, blade_inertia=0.05,
                           blade_torque=0.05, track_residual=True,
                           track_wall_reactions=True)
    du, dv = 1.6 * R, 0.8 * R + 1.001 * R
    pos = np.asarray([[c[0] + du, c[1] + dv, R], [c[0] - du, c[1] - dv, R]])
    got, ref = _both(p, grid, walls, pos, np.zeros((2, 3)), 6,
                     dict(wspin0=np.zeros(1)))
    assert int(got[3]) == 0 and int(ref[3]) == 0
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(ref[-1]),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=2e-3, atol=2e-5)
    assert float(np.asarray(ref[-1])[0]) > 0.0
    dg, rdg = got[4].numpy(), np.asarray(ref[4])
    assert dg.shape == rdg.shape == (30,)
    np.testing.assert_allclose(dg, rdg, rtol=2e-3, atol=1e-3 * rdg.max())
    for g, r in zip(got[5], ref[5]):          # force, torque (W, 3)
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-3,
                                   atol=1e-3 * np.abs(r).max())
    assert float(np.abs(np.asarray(ref[5][0])).max()) > 1.0


def test_drum_matches_dense_reference():
    """The spinning drum of tests/test_nsc_pencil.py (a cylinder wall and
    two planes) for two steps."""
    got, ref = _both(*_drum())
    assert int(got[3]) == 0 and int(ref[3]) == 0
    for g, r, atol in zip(got[:3], ref[:3], (X_ATOL, V_ATOL, W_ATOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0.05
