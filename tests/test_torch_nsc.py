"""PyTorch port (chrono_tpu_torch) vs the JAX package: the NSC/DVI stepper.

The oracle is the JAX dense reference (``backend="xla"``: ``dense_sweep_u``,
``dense_sweep_g`` and ``make_nsc_pencil_advance``), to which the JAX package
holds its three Pallas layouts (tests/test_nsc_pencil.py,
tests/test_nsc_dynamic_blade.py), and ``detect_half``, the detection of the
JAX mixer's path.  The interpret-mode TPU kernels are not run here: each of
their cases takes over 40 s on one CPU core.  On the CPU the port's kernels
run their plain twins.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu.collision.cell_list import GridSpec as JGridSpec
from chrono_tpu.dem.cell_dense import to_cells
from chrono_tpu.ops.pallas import nsc_pencil_kernel as jk
from chrono_tpu.ops.pallas.nsc_half_kernel import detect_half
from chrono_tpu.solver import nsc_pencil as jn

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.convert import (
    _cell_slots, nsc_gamma_from_dense, nsc_gamma_to_dense,
    nsc_params_from_numpy,
)
from chrono_tpu_torch.fsi.sph.pencil import bin_to_cells
from chrono_tpu_torch.ops import nsc_pair as tk
from chrono_tpu_torch.ops.cuda import nsc_sweep as ns
from chrono_tpu_torch.ops.cuda.nsc_detect import (
    DetectConsts, class_offset, nsc_detect_plain,
)
from chrono_tpu_torch.ops.cuda.nsc_sweep import (
    nsc_sweep_g_plain, nsc_sweep_u_plain,
)
from chrono_tpu_torch.solver import nsc_pencil as tn

import test_nsc_pencil as jt

R = jt.R
BLADE_WALLS = jt.TestRotatingBoxBlade.WALLS
# the tolerances the JAX package holds its backends to
X_ATOL, V_ATOL, W_ATOL = 2e-5, 2e-4, 2e-3
SWEEP_TOL = dict(rtol=1e-5, atol=1e-6)
MATH_TOL = dict(rtol=1e-6, atol=1e-6)


def _grid(n=5):
    return GridSpec(cell_size=2.1 * R, dims=(n, n, n))


def _jgrid(grid):
    return JGridSpec(origin=grid.origin, cell_size=grid.cell_size,
                     dims=grid.dims)


def _port_params(p):
    return nsc_params_from_numpy({f.name: getattr(p, f.name)
                                  for f in dataclasses.fields(p)})


# ------------------------------------------------------ 1. elementwise math


def _rand(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _close(got, ref, tol=MATH_TOL):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)


def test_pair_math_matches_jax():
    rng = np.random.default_rng(1)
    s, b = _rand(rng, (3, 512), 0.0, 0.2), _rand(rng, (3, 512), 0.0, 0.2)
    b[0, :8] = s[0, :8] + 0.95   # |n_x| > 0.9: the other tangent axis
    ts, tb = torch.from_numpy(s), torch.from_numpy(b)
    nhat, gap, arm, t1, t2 = tk.pair_geometry(*ts, *tb, R)
    ref = jk.pair_geometry(*jnp.asarray(s), *jnp.asarray(b), R)
    _close((*nhat, gap, arm, *t1, *t2),
           (*ref[0], ref[1], ref[2], *ref[3], *ref[4]))
    rt1, rt2 = jn._wall_tangents(tuple(jnp.asarray(x.numpy()) for x in nhat))
    _close((*t1, *t2), (*rt1, *rt2))
    _close([tk.contact_rhs(gap, 200.0, 1000.0, 0.5)],
           [jk.contact_rhs(jnp.asarray(gap.numpy()), 200.0, 1000.0, 0.5)])
    v = [torch.from_numpy(_rand(rng, (512,))) for _ in range(12)]
    got = tk.pair_velocity(nhat, t1, t2, arm, v[0:3], v[3:6], v[6:9],
                           v[9:12])
    jv = [jnp.asarray(x.numpy()) for x in v]
    ref = jk.pair_velocity(*(tuple(jnp.asarray(x.numpy()) for x in a)
                             for a in (nhat, t1, t2)),
                           jnp.asarray(arm.numpy()), jv[0:3], jv[3:6],
                           jv[6:9], jv[9:12])
    _close(got, ref)


def test_cone_projection_regimes_match_jax():
    rng = np.random.default_rng(2)
    gn = _rand(rng, (3000,), -2.0, 2.0)
    gu, gv = _rand(rng, (3000,)), _rand(rng, (3000,))
    gu[:4] = gv[:4] = 0.0
    mu = 0.4
    tnorm = np.sqrt(gu * gu + gv * gv)
    inside = tnorm <= mu * gn
    polar = mu * tnorm <= -gn
    assert inside.sum() > 100 and polar.sum() > 100
    assert (~inside & ~polar).sum() > 100
    got = tk.cone_project(*(torch.from_numpy(x) for x in (gn, gu, gv)), mu)
    _close(got, jk.cone_project(jnp.asarray(gn), jnp.asarray(gu),
                                jnp.asarray(gv), mu))


WALLS_UNDER_TEST = [
    ("plane", (0.0, 0.0, 1.0), 0.05, (0.1, 0.0, 0.0), 0.4),
    ("plane", (0.6, -0.8, 0.0), -0.1, (0.0, 0.0, 0.0), 0.2),
    ("cyl", 0, (0.0, 0.3, 0.3), 0.35, 3.0, 0.5),
    ("cyl", 1, (0.3, 0.0, 0.3), 0.35, -2.0, 0.5),
    ("cyl", 2, (0.3, 0.3, 0.0), 0.35, 1.0, 0.5),
    ("rotbox", 0, (0.3, 0.3, 0.3), (0.25, 0.04, 0.1), np.pi / 3, 0.4),
    ("rotbox", 1, (0.3, 0.3, 0.3), (0.2, 0.06, 0.15), 1.0, 0.4),
    ("rotbox", 2, (0.3, 0.3, 0.3), (0.25, 0.04, 0.1), -0.5, 0.4),
]


@pytest.mark.parametrize("theta", [0.0, 0.3])
@pytest.mark.parametrize("wall", WALLS_UNDER_TEST,
                         ids=lambda w: f"{w[0]}{w[1]}")
def test_wall_geometry_matches_jax(wall, theta):
    rng = np.random.default_rng(3)
    p = _rand(rng, (3, 600), 0.0, 0.6)
    if wall[0] == "rotbox":
        # bodies at the centre and on face centres: sign(0) = 0 there
        p[:, :3] = np.asarray(wall[2], np.float32)[:, None]
        p[wall[1], 1], p[(wall[1] + 1) % 3, 2] = 0.1, 0.1
    tp = torch.from_numpy(p)
    for spin in (None, 0.7):
        if wall[0] == "rotbox":
            cs = (np.float32(np.cos(theta)), np.float32(np.sin(theta)))
            if spin is not None:
                cs += (np.float32(spin),)
            tcs = tuple(torch.tensor(x) for x in cs)
            jcs = tuple(jnp.asarray(x) for x in cs)
        else:
            tcs = jcs = None
        nhat, gap, vs = tk.wall_geometry(wall, *tp, R, tcs)
        ref = jk.wall_geometry(wall, *jnp.asarray(p), R, jcs)
        _close((*nhat, gap, *vs), (*ref[0], ref[1], *ref[2]))
        t1, t2 = tk.tangents(*nhat)
        rt1, rt2 = jn._wall_tangents(ref[0])
        _close((*t1, *t2), (*rt1, *rt2))
    assert tk.wall_mu(wall) == (wall[4] if wall[0] == "plane" else wall[5])


def test_wall_masks_match_jax_geometry():
    """Sweep U's wall masks (their twin, ``wall_masks_plain``): bit w of a
    body's mask against the JAX package's ``wall_geometry`` gap < envelope,
    for every wall kind and axis, from bodies made from a seed; U's twin on
    the masks gives U's twin's bits."""
    rng = np.random.default_rng(41)
    n = 600
    pos = _rand(rng, (3, n), 0.0, 0.6)
    p = tn.NSCPencilParams(radius=R, mass=0.5, mu=0.3, dt=1e-3,
                           envelope=0.5 * R)
    c = tn.nsc_static_params(p, WALLS_UNDER_TEST)
    theta = 0.3
    rows = [(np.cos(theta), np.sin(theta), w[4]) for w in WALLS_UNDER_TEST
            if w[0] == "rotbox"]
    cs = torch.tensor(rows, dtype=torch.float32)
    tpos = torch.from_numpy(pos)
    masks = ns.wall_masks_plain(tpos, cs, c).numpy()
    for w, (wall, pose) in enumerate(zip(WALLS_UNDER_TEST,
                                         ns.wall_poses(c, cs))):
        jcs = None if pose is None else tuple(jnp.asarray(x.numpy())
                                              for x in pose)
        gap = np.asarray(jk.wall_geometry(wall, *jnp.asarray(pos), R,
                                          jcs)[1])
        held = gap < c.envelope
        sure = np.abs(gap - c.envelope) > 1e-6
        np.testing.assert_array_equal(((masks >> w) & 1)[sure] == 1,
                                      held[sure])
        assert held.any() and not held.all()
    partners = torch.full((n, 2), -1, dtype=torch.int32)
    g = torch.zeros((3, n, 2))
    wg = torch.from_numpy(_rand(rng, (3, n, len(WALLS_UNDER_TEST)), 0.0,
                                0.01))
    ufree = torch.zeros((6, n))
    args = (tpos, ufree, g, g, wg, wg, 0.3, partners, cs, c)
    assert torch.equal(nsc_sweep_u_plain(*args, torch.from_numpy(masks)),
                       nsc_sweep_u_plain(*args))


# ------------------------------------------------------------ 2. detection


def _detect_scene(n=24, seed=11):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.12, 0.42, (n, 3)).astype(np.float32)


def _to_cells(jg, pos, vel, om):
    return jax.jit(lambda *a: to_cells(jg, 8, *a))(pos, vel, om)


def _port_bin(grid, pos, capacity=8):
    order, cells, ovf = bin_to_cells(grid, capacity, torch.from_numpy(pos))
    return order, cells, int(ovf)


def _codes(partners, cells):
    """The port's partner table as ``detect_half``'s codes (nx, ny, nz, C,
    P): k·C + the partner's slot, −1 where empty."""
    part = partners.numpy()
    ijk, slot = _cell_slots(cells)
    C = cells.capacity
    out = np.full(tuple(cells.dims) + (C, part.shape[1]), -1.0, np.float32)
    classes = [class_offset(k) for k in range(13)]
    for i, p in zip(*np.nonzero(part >= 0)):
        j = part[i, p]
        d = tuple(int(x) for x in ijk[j] - ijk[i])
        k = 13 if d == (0, 0, 0) else classes.index(d)
        out[(*ijk[i], slot[i], p)] = k * C + slot[j]
    return out


@pytest.mark.parametrize("P", [12, 2])
def test_detection_matches_detect_half(P):
    """The same owners, partners in the same order, and the same overflow
    (P = 2 overflows)."""
    grid = _grid()
    pos = _detect_scene()
    env = 0.05 * R
    jg = _jgrid(grid)
    field = _to_cells(jg, jnp.asarray(pos), jnp.zeros((24, 3)),
                      jnp.zeros((24, 3)))
    codes, over = jax.jit(lambda x, m: detect_half(R, env, jg, x, m, P))(
        field.pos, field.mask)
    order, cells, ovf = _port_bin(grid, pos)
    assert ovf == 0 and int(field.overflow) == 0
    pos_s = torch.from_numpy(pos)[order].T.contiguous()
    partners, count = nsc_detect_plain(pos_s, cells, P,
                                       DetectConsts.of(R, env))
    np.testing.assert_array_equal(_codes(partners, cells), np.asarray(codes))
    assert max(int(count.max()) - P, 0) == int(over)
    assert (int(over) > 0) == (P == 2)
    assert int((partners >= 0).sum()) == int(np.sum(np.asarray(codes) >= 0))


# ------------------------------------------------------- 3. each sweep alone


def _sweep_scene():
    """The detection scene under the blade walls at θ = 0.3, with random
    velocities and random multipliers on the detected contacts and every
    wall row."""
    grid = _grid()
    pos = _detect_scene()
    p = jn.NSCPencilParams(radius=R, mass=0.5, mu=0.3, dt=1e-3,
                           envelope=0.05 * R)
    rng = np.random.default_rng(5)
    vel = rng.normal(0.0, 0.2, pos.shape).astype(np.float32)
    om = rng.normal(0.0, 2.0, pos.shape).astype(np.float32)
    order, cells, _ = _port_bin(grid, pos)
    pos_s = torch.from_numpy(pos)[order].T.contiguous()
    partners, _ = nsc_detect_plain(pos_s, cells, 12,
                                   DetectConsts.of(R, p.envelope))
    valid = (partners >= 0).numpy()
    n, W = len(pos), len(BLADE_WALLS)
    # impulses of the size a step's contacts carry (~m g dt to 10 m v)
    gams = [np.where(valid, rng.uniform(-0.005, 0.01, (3, n, 12)), 0.0)
            .astype(np.float32) for _ in range(2)]
    wgams = [rng.uniform(-0.005, 0.01, (3, n, W)).astype(np.float32)
             for _ in range(2)]
    return grid, p, pos, vel, om, order, cells, pos_s, partners, gams, wgams


def _port_consts(p, theta):
    t = torch.tensor([theta], dtype=torch.float32)
    cs = torch.stack([torch.cos(t), torch.sin(t),
                      torch.tensor([BLADE_WALLS[1][4]], dtype=torch.float32)],
                     1)
    return tn.nsc_static_params(_port_params(p), BLADE_WALLS), cs


def test_sweeps_match_dense_reference():
    """Sweep U and sweep G each against ``dense_sweep_u`` / ``dense_sweep_g``
    from the same multipliers, β = 0.3 (G from the reference's u)."""
    (grid, p, pos, vel, om, order, cells, pos_s, partners, gams,
     wgams) = _sweep_scene()
    beta, theta = 0.3, 0.3
    c, cs = _port_consts(p, theta)
    jg = _jgrid(grid)
    field = _to_cells(jg, jnp.asarray(pos), jnp.asarray(vel),
                      jnp.asarray(om))
    dense = [nsc_gamma_to_dense(g, w, partners, cells)
             for g, w in zip(gams, wgams)]
    cs_list = jn.wall_cs_list(BLADE_WALLS, jnp.asarray([theta], jnp.float32))
    jbeta = jnp.float32(beta)
    uv, uw = jax.jit(functools.partial(jn.dense_sweep_u, p, jg, BLADE_WALLS))(
        field.pos, field.vel, field.omega, field.mask, dense[0][0],
        dense[1][0], dense[0][1], dense[1][1], jbeta, cs_list)
    ufree = torch.from_numpy(np.concatenate([vel, om], 1))[order].T
    u = nsc_sweep_u_plain(pos_s, ufree.contiguous(), *map(torch.from_numpy, (
        gams[0], gams[1], wgams[0], wgams[1])), beta, partners, cs, c)
    ijk, slot = _cell_slots(cells)
    ref_u = np.concatenate([np.asarray(uv)[(*ijk.T, slot)],
                            np.asarray(uw)[(*ijk.T, slot)]], 1).T
    np.testing.assert_allclose(u.numpy(), ref_u, **SWEEP_TOL)
    assert np.abs(u.numpy() - ufree.numpy()).max() > 1e-3  # contacts act

    gout, wout = jax.jit(functools.partial(jn.dense_sweep_g, p, jg,
                                           BLADE_WALLS))(
        field.pos, uv, uw, field.mask, dense[0][0], dense[1][0], dense[0][1],
        dense[1][1], jbeta, cs_list)
    g, w = nsc_sweep_g_plain(pos_s, torch.from_numpy(ref_u), *map(
        torch.from_numpy, (gams[0], gams[1], wgams[0], wgams[1])), beta,
        partners, cs, c)
    got, wgot = nsc_gamma_to_dense(g, w, partners, cells)
    np.testing.assert_allclose(got, np.asarray(gout), **SWEEP_TOL)
    np.testing.assert_allclose(wgot, np.asarray(wout), **SWEEP_TOL)
    assert np.count_nonzero(np.asarray(wout)) > 0
    assert np.count_nonzero(got) == np.count_nonzero(np.asarray(gout))


def test_gamma_layout_round_trip():
    (_, _, _, _, _, _, cells, _, partners, gams, wgams) = _sweep_scene()
    dense, wdense = nsc_gamma_to_dense(gams[0], wgams[0], partners, cells)
    g, w = nsc_gamma_from_dense(dense, wdense, partners, cells)
    np.testing.assert_array_equal(g.numpy(), gams[0])
    np.testing.assert_array_equal(w.numpy(), wgams[0])
    # every contact twice, the partner's copy with γv negated
    assert np.count_nonzero(dense) == 2 * np.count_nonzero(gams[0])
    np.testing.assert_array_equal(np.sort(np.abs(dense[dense != 0])),
                                  np.sort(np.abs(np.repeat(
                                      gams[0][gams[0] != 0], 2))))


def test_params_from_numpy():
    p = jn.NSCPencilParams(radius=0.03, mass=0.2, mu=0.4,
                           gravity=(-9.81, 0.0, 0.0), dt=2e-3, n_iter=7,
                           envelope=0.003, omega=0.25, restart_every=3,
                           track_wall_reactions=True, blade_inertia=0.5,
                           blade_torque=1.5)
    q = _port_params(p)
    for f in dataclasses.fields(p):
        assert getattr(q, f.name) == getattr(p, f.name), f.name
    assert q.inertia == p.inertia
    consts = tn.nsc_static_params(q, ())
    assert dict(p.phys_tuple()) == {k: getattr(consts, k)
                                    for k, _ in p.phys_tuple()}


# -------------------------------------------------------- 4. whole advance


def _floor():
    rng = np.random.default_rng(7)
    n = 14
    p = jn.NSCPencilParams(radius=R, mass=0.5, mu=0.3, dt=1e-3, n_iter=6,
                           envelope=0.002 * R)
    pos = rng.uniform(0.12, 0.36, (n, 3))
    return p, _grid(4), jt.FLOOR, pos, rng.normal(0.0, 0.2, (n, 3)), 1, {}


def _blade():
    rng = np.random.default_rng(11)
    n = 14
    p = jn.NSCPencilParams(radius=R, mass=0.5, mu=0.3, dt=1e-3, n_iter=10,
                           envelope=0.002 * R)
    pos = rng.uniform(0.12, 0.45, (n, 3))
    return (p, _grid(5), BLADE_WALLS, pos, rng.normal(0.0, 0.2, (n, 3)), 2,
            dict(theta0=np.asarray([0.3])))


SCENES = {"floor": _floor, "blade": _blade}


def _both(p, grid, walls, pos, vel, steps, kw):
    pos, vel = (np.asarray(a, np.float32) for a in (pos, vel))
    z = np.zeros_like(pos)
    ref = jn.make_nsc_pencil_advance(p, _jgrid(grid), walls, backend="xla")(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(z), steps, **kw)
    got = tn.make_nsc_pencil_advance(_port_params(p), grid, walls,
                                     device="cpu")(pos, vel, z, steps, **kw)
    return got, ref


@pytest.mark.parametrize("scene", list(SCENES))
def test_advance_matches_dense_reference(scene):
    got, ref = _both(*SCENES[scene]())
    assert int(got[3]) == 0 and int(ref[3]) == 0
    for g, r, atol in zip(got[:3], ref[:3], (X_ATOL, V_ATOL, W_ATOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0.05   # contacts act


def test_advance_without_walls_conserves_momentum():
    """The head-on pair of tests/test_nsc_pencil.py with no walls and no
    gravity: the partner's reaction is exactly −force, so the linear
    momentum is kept to rounding, and the impact is inelastic."""
    p = tn.NSCPencilParams(radius=R, mass=0.5, mu=0.3,
                           gravity=(0.0, 0.0, 0.0), dt=1e-3, n_iter=40,
                           envelope=0.1 * R)
    adv = tn.make_nsc_pencil_advance(p, _grid(5), (), device="cpu")
    pos = np.asarray([[0.2, 0.25, 0.25], [0.2 + 2.05 * R, 0.25, 0.25]])
    vel = np.asarray([[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0]])
    out = adv(pos, vel, np.zeros((2, 3)), 30)
    assert int(out[3]) == 0
    np.testing.assert_allclose(out[1].sum(0).numpy(), 0.0, atol=1e-6)
    assert abs(float(out[1][1, 0] - out[1][0, 0])) < 0.15


# ------------------------------------------------------- 5. the β sequence


@pytest.mark.parametrize("restart_every", [0, 12])
def test_beta_sequence_matches_jax(restart_every):
    """The host's float32 θ/β recurrence equals the JAX package's, step
    for step."""
    p = jn.NSCPencilParams(n_iter=50, restart_every=restart_every)
    z = jnp.zeros(())
    st = jn.APGDState(gam=z, gprev=z, wgam=z, wgprev=z,
                      beta=jnp.zeros((), jnp.float32),
                      theta=jnp.ones((), jnp.float32))
    ref = []
    for k in range(p.n_iter):
        ref.append(float(st.beta))
        st, _ = jn._momentum_update(st, z, z, p, k)
    np.testing.assert_array_equal(tn.beta_sequence(50, restart_every),
                                  np.asarray(ref, np.float32))
    assert float(tn.theta_next(np.float32(1.0))) == float(
        jn.theta_next(jnp.float32(1.0)))
