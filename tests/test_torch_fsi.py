"""PyTorch port (chrono_tpu_torch) vs the JAX package: rigid bodies in
WCSPH and ISPH (config #4's coupling), and ISPH.

The oracle scene is tests/test_fsi.py's floating block (a 0.08 m cube at
ρ 500 in a 0.24 m periodic-xy tank at d0 = 0.02): ``make_fsi_advance_fn``
for several outer steps with each scheme against the JAX one, the port's
``fsi_step`` against its advance, ``isph_substep`` with CG,
``make_isph_advance_fn`` with BiCGStab and ``suggest_isph_dt``; and ``make_sph_advance_fn`` with and without
``adaptive_dt`` on tests/test_sph.py's periodic water column.  The JAX
advances are jitted once a module.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu.collision.cell_list import GridSpec as JGrid
from chrono_tpu.fsi import system as j_fsi
from chrono_tpu.fsi.sph import isph as j_isph
from chrono_tpu.fsi.sph import system as j_sys

from chrono_tpu_torch import convert
from chrono_tpu_torch.fsi import system as t_fsi
from chrono_tpu_torch.fsi.sph import isph as t_isph
from chrono_tpu_torch.fsi.sph import system as t_sys

from test_fsi import floating_block_setup
from test_torch_crm_fsi import model_leaves
from test_torch_wcsph import (
    _leaves, assert_same_list, fluid_close, jit_rebuild, port_grid,
    port_state,
)

# bodies: the tolerances tests/test_torch_crm_fsi.py holds the coupled
# step to
BODY_X_TOL = dict(rtol=1e-5, atol=1e-6)
BODY_V_TOL = dict(rtol=1e-4, atol=1e-5)
N_SUB = 2


@pytest.fixture(scope="module", autouse=True)
def threads():
    """The multibody step's tiny LAPACK calls would pay for a larger
    pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def port_fsi(model, params, grid, state):
    """The JAX scene as the port's, on the CPU."""
    fluid = _leaves(state.fluid, ("nbr",))
    return (convert.mbs_model_from_numpy(model_leaves(model), device="cpu"),
            convert.sph_params_from_numpy(_leaves(params)), port_grid(grid),
            convert.fsi_state_from_numpy(
                {"bodies": _leaves(state.bodies), "fluid": fluid,
                 "time": np.asarray(state.time)}, device="cpu"))


@functools.cache
def block(rho_solid=500.0):
    """tests/test_fsi.py's block, on cells of W/5 = 2h with 32 slots (the
    test's cells of W/3 with 80 slots make 2,160 candidates a marker,
    which on one core costs a second a list; the lists are the same
    pairs)."""
    model, params, grid, state, z0, H, side = floating_block_setup(rho_solid)
    params = params.replace(max_per_cell=32)
    cell = grid.lengths[0] / 5
    grid = JGrid(origin=grid.origin, cell_size=cell,
                 dims=(5, 5, int(np.ceil(2 * H / cell)) + 2),
                 periodic=grid.periodic)
    return (model, params, grid, state) + port_fsi(model, params, grid,
                                                   state)


@functools.cache
def jax_run(scheme, n_outer, rho_solid=500.0):
    model, params, grid, state = block(rho_solid)[:4]
    return j_fsi.make_fsi_advance_fn(model, params, grid, N_SUB,
                                     scheme=scheme)(state, n_outer)


@functools.cache
def port_run(scheme, n_outer, rho_solid=500.0):
    tm, tp, tg, ts = block(rho_solid)[4:]
    got, ovf = t_fsi.make_fsi_advance_fn(tm, tp, tg, N_SUB, scheme=scheme,
                                         device="cpu")(ts, n_outer)
    assert int(ovf) == 0
    return got


def bodies_close(got, ref):
    for f, tol in (("x", BODY_X_TOL), ("q", BODY_X_TOL), ("v", BODY_V_TOL),
                   ("w", BODY_V_TOL)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f,
                                   **tol)


@pytest.mark.parametrize("scheme,n_outer", [("wcsph", 4), ("isph", 2)])
def test_fsi_advance_matches_jax(scheme, n_outer):
    """The floating block, ``n_outer`` outer steps of 2 substeps: the body
    and the markers; the block has moved, the floor has not."""
    ref, got = jax_run(scheme, n_outer), port_run(scheme, n_outer)
    bodies_close(got.bodies, ref.bodies)
    fluid_close(got.fluid, ref.fluid)
    assert_same_list(got.fluid.nbr, ref.fluid.nbr)
    assert float(got.time) == pytest.approx(float(ref.time), rel=1e-6)
    start = block()[7]
    assert float((got.bodies.v - start.bodies.v).abs().max()) > 1e-4
    floor = start.fluid.kind == 1
    assert torch.equal(got.fluid.pos[floor], start.fluid.pos[floor])


def test_fsi_step_is_the_advance():
    """``fsi_step`` called by hand (eager multibody step) gives the
    advance's state bit for bit, and the rigid markers sit at
    x_b + R ξ of the bodies they were moved with."""
    tm, tp, tg, ts = block()[4:]
    st = ts
    for _ in range(4):
        prev = st.bodies
        st, info = t_fsi.fsi_step(tm, tp, tg, st, tp.dt, N_SUB)
    ref = port_run("wcsph", 4)
    for f in "xqvw":
        assert torch.equal(getattr(st.bodies, f), getattr(ref.bodies, f))
    for f in ("pos", "vel", "rho"):
        assert torch.equal(getattr(st.fluid, f), getattr(ref.fluid, f))
    from chrono_tpu_torch.core import quaternion as Q
    rigid = st.fluid.kind == 2
    want = prev.x[0] + Q.qrotate(prev.q[0].expand(int(rigid.sum()), 4),
                                 st.fluid.bce_local[rigid])
    assert float((st.fluid.pos[rigid] - want).abs().max()) < 1e-6
    with pytest.raises(ValueError, match="scheme"):
        t_fsi.make_fsi_advance_fn(tm, tp, tg, scheme="implicit",
                                  device="cpu")


@functools.cache
def listed_block():
    """The floating block's markers after 4 outer steps, with their lists
    built by both packages."""
    model, params, grid = block()[:3]
    js = jax_run("wcsph", 4).fluid
    js = jit_rebuild(params, grid, js)
    tp, tg = block()[5:7]
    ts = t_sys.rebuild_sph_neighbors(tp, tg, port_state(js).replace(nbr=None))
    assert_same_list(ts.nbr, js.nbr)
    return params, grid, js, tp, tg, ts


def test_isph_advance_and_dt_match_jax():
    """``make_isph_advance_fn`` with BiCGStab for one cycle of 2 steps
    (``fsi_step`` above runs ``isph_substep`` with CG, and
    ``isph_solid_reaction``), and ``suggest_isph_dt``."""
    jp, jg, js, tp, tg, ts = listed_block()
    jp2, tp2 = jp.replace(rebuild_every=2), tp.replace(rebuild_every=2)
    ref, ovf, iters = j_isph.make_isph_advance_fn(
        jp2, jg, linear_solver="bicgstab")(js, 1)
    got, t_ovf, t_iters = t_isph.make_isph_advance_fn(
        tp2, tg, linear_solver="bicgstab", device="cpu")(ts, 1)
    assert int(ovf) == int(t_ovf) == 0
    assert abs(int(iters) - int(t_iters)) <= 2
    fluid_close(got, ref)
    for v_max in (0.05, 1.0):
        assert t_isph.suggest_isph_dt(tp, v_max) == pytest.approx(
            j_isph.suggest_isph_dt(jp, v_max), rel=1e-6)


@pytest.mark.parametrize("builder", ["heightmap", "heightmap_fluid",
                                     "container", "container_lid", "fill",
                                     "annulus"])
def test_scene_builders_match_jax(builder):
    """``fsi/bce.py``'s heightmap and cylinder scene builders: the same
    points, bit for bit."""
    from chrono_tpu.fsi import bce as j_bce
    from chrono_tpu_torch.fsi import bce as t_bce

    heights = 0.05 * np.sin(np.linspace(0, 3, 21))[:, None] \
        + 0.02 * np.cos(np.linspace(0, 2, 11))[None, :]
    calls = {
        "heightmap": ("heightmap_markers", (heights, (0.0, -0.2), 0.1, 0.04),
                      {}),
        "heightmap_fluid": ("heightmap_markers",
                            (heights, (0.1, 0.0), 0.1, 0.05),
                            dict(layers=2, depth=0.2)),
        "container": ("cylinder_container_markers", (0.3, 0.5, 0.04), {}),
        "container_lid": ("cylinder_container_markers", (0.2, 0.3, 0.05),
                          dict(layers=2, top_open=False)),
        "fill": ("cylinder_fluid_fill", (0.3, 0.4, 0.04), {}),
        "annulus": ("cylinder_fluid_fill", (0.3, 0.2, 0.03),
                    dict(inner_radius=0.1, z0=0.02)),
    }
    name, args, kw = calls[builder]
    ref = getattr(j_bce, name)(*args, **kw)
    got = getattr(t_bce, name)(*args, **kw)
    for r, g in (zip(ref, got) if isinstance(ref, tuple) else ((ref, got),)):
        if r is None:
            assert g is None
            continue
        assert len(r) > 50
        np.testing.assert_array_equal(g, r)
