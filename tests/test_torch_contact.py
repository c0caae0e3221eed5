"""Rigid-body contact: the port against the JAX package.

Scenes are built once through the JAX builder (seeded with numpy) and
carried across with ``convert``: a detection scene of 60 spheres (four of
them two to a body, at offsets) on rotated bodies, a floor box, a rotated
box on a moving body and an 8-triangle mesh, with a detection envelope;
``tests/test_contact.py``'s ``drop_scene`` with the spheres stacked in
touch; ``bench_suite.py``'s ``bench_mixer`` cut to 125 spheres.

- ``detect_contacts``, dense and with ``mesh_candidates``, and with a
  capacity below the count: the same active set in the same order (bodies
  to the bit), gap / normal / point within float32 rounding;
- the cell-slot table, ``topk_select``, ``contact_rows`` and
  ``rolling_rows``;
- one ``nsc_step`` per solver on ``drop_scene`` (the direct solver with an
  analytic contact from ``extra_contacts_fn``), and one with rolling
  friction: the North star's state tolerances (x rtol 1e-4 / atol 1e-5,
  v and ω rtol 1e-3 / atol 1e-4), the same iteration count;
- 3 steps of the 125-sphere mixer, whose port scene (``chip_smoke.py``'s
  ``general_mixer_scene``) must equal the converted one;
- ``smc_contact_forces`` for every force, adhesion and tangential model,
  and one ``smc_step``;
- convex shapes, once refused, carried by ``convert`` and detected as the
  JAX package detects them; the card by default; shafts, once refused,
  pass through both contact steps.

The JAX references are jitted once each (XLA's backend optimisations off);
both sides run in float32 on the CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu.collision import cell_list as jcl
from chrono_tpu.collision import pipeline as jpipe
from chrono_tpu.core import quaternion as JQ
from chrono_tpu.core.functions import FConst as JFConst
from chrono_tpu.physics import system as jsys
from chrono_tpu.physics import smc as jsmc
from chrono_tpu.physics.builder import SystemBuilder as JBuilder

from chrono_tpu_torch import convert
from chrono_tpu_torch.collision import cell_list as tcl
from chrono_tpu_torch.collision import pipeline as tpipe
from chrono_tpu_torch.physics import smc as tsmc
from chrono_tpu_torch.physics import shafts as tshafts
from chrono_tpu_torch.physics import system as tsys
from chrono_tpu_torch.physics.builder import SystemBuilder as TBuilder

import chip_smoke
from test_contact import drop_scene
from test_torch_mbs import assert_same_leaves, leaves

O0 = {"xla_backend_optimization_level": 0}
X_TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit(fn):
    return jax.jit(fn, compiler_options=O0)


def state_np(state):
    return {f: np.asarray(getattr(state, f)) for f in "xqvw"}


def carry(jmodel, jcoll, jstate):
    """The JAX scene as the port's, through ``convert``."""
    return (convert.mbs_model_from_numpy(leaves(jmodel), device="cpu"),
            convert.collision_model_from_numpy(leaves(jcoll), device="cpu"),
            convert.body_state_from_numpy(state_np(jstate), device="cpu"))


def contacts_np(c):
    return {f: np.asarray(getattr(c, f)) for f in c._fields}


def j64(tree):
    """A JAX pytree with its float leaves in float64 (call inside
    ``jax.enable_x64``)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.asarray(a).dtype.kind == "f" else a, tree)


def t64(obj):
    """The port's carriers with their float tensors in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: t64(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[t64(v) for v in obj])
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: t64(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


# ------------------------------------------------------------------ scenes

N_SPH = 60
R = 0.06


def detection_scene(mesh_candidates=0, max_contacts=256):
    """60 spheres on 58 bodies (two bodies carry two spheres at offsets),
    random positions and orientations and speeds, over a floor box, a
    rotated box on a moving body and an 8-triangle mesh (a square pyramid's
    four faces, its base, and a tilted quad), envelope 0.01."""
    rng = np.random.default_rng(7)
    bld = JBuilder()
    g = bld.add_ground()
    bodies, offsets = [], []
    for k in range(N_SPH - 2):
        axis = rng.normal(size=3)
        ang = rng.uniform(0, np.pi)
        q = np.concatenate([[np.cos(ang / 2)],
                            np.sin(ang / 2) * axis / np.linalg.norm(axis)])
        b = bld.add_body(mass=rng.uniform(0.5, 2.0),
                         inertia=(0.01, 0.012, 0.014),
                         pos=rng.uniform((0.05, 0.05, 0.03),
                                         (0.95, 0.95, 0.45)),
                         rot=q, vel=rng.normal(size=3) * 0.3,
                         omega_local=rng.normal(size=3))
        bodies.append(b)
        offsets.append((0.0, 0.0, 0.0))
    for b in bodies[:2]:                       # a second sphere on two bodies
        bodies.append(b)
        offsets.append((0.07, 0.02, -0.03))
    mover = bld.add_body(mass=5.0, inertia=(0.1, 0.1, 0.1),
                         pos=(0.5, 0.5, 0.25), vel=(0.1, 0.0, 0.0),
                         omega_local=(0.0, 0.0, 0.5))
    model, state = bld.finalize()
    spheres = jpipe.SphereShapes(
        body=jnp.asarray(bodies, jnp.int32), offset=jnp.asarray(offsets),
        radius=jnp.asarray(rng.uniform(0.8 * R, R, N_SPH).astype(np.float32)),
        mu=jnp.asarray(rng.uniform(0.2, 0.6, N_SPH).astype(np.float32)))
    rot = np.asarray(JQ.q_from_axis_angle(jnp.asarray([0.3, 0.2, 1.0]) /
                                          np.sqrt(1.13), 0.6))
    boxes = jpipe.BoxShapes(
        body=jnp.asarray([g, mover], jnp.int32),
        pos=jnp.asarray([[0.5, 0.5, -0.5], [0.0, 0.0, 0.0]]),
        rot=jnp.asarray([[1.0, 0, 0, 0], rot]),
        half=jnp.asarray([[2.0, 2.0, 0.5], [0.2, 0.05, 0.08]]),
        mu=jnp.asarray([0.5, 0.3]))
    verts = np.array([[0.2, 0.2, 0.0], [0.5, 0.2, 0.0], [0.5, 0.5, 0.0],
                      [0.2, 0.5, 0.0], [0.35, 0.35, 0.2],
                      [0.6, 0.6, 0.05], [0.95, 0.6, 0.15],
                      [0.95, 0.95, 0.15], [0.6, 0.95, 0.05]])
    faces = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4],
                      [0, 2, 1], [0, 3, 2], [5, 6, 7], [5, 7, 8]])
    meshes = jpipe.MeshShapes.from_mesh(g, verts, faces, mu=0.45)
    coll = jpipe.CollisionModel(
        spheres=spheres, boxes=boxes, meshes=meshes,
        grid=jcl.GridSpec(origin=(-0.2, -0.2, -0.2), cell_size=0.15,
                          dims=(10, 10, 7)),
        max_per_cell=8, max_contacts=max_contacts, envelope=0.01,
        mesh_candidates=mesh_candidates)
    return model, coll, state, (g, verts, faces)


@pytest.fixture(scope="module")
def detected():
    """The JAX contacts of the detection scene: dense with room for all,
    and with 3 mesh candidates a sphere and room for 20."""
    out = {}
    for key, kw in (("dense", {}),
                    ("candidates", dict(mesh_candidates=3,
                                        max_contacts=20))):
        jm, jc, js, mesh = detection_scene(**kw)
        ref = jit(lambda s: jpipe.detect_contacts(jc, s))(js)
        out[key] = (jm, jc, js, mesh, ref)
    return out


def assert_same_contacts(got, ref):
    ref = contacts_np(ref)
    assert int(got.count) == int(ref["count"])
    np.testing.assert_array_equal(got.active.numpy(), ref["active"])
    act = ref["active"]
    for f in ("body_a", "body_b"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[act],
                                      ref[f][act], err_msg=f)
    for f, atol in (("gap", 2e-6), ("normal", 2e-5), ("point", 2e-6),
                    ("mu", 0), ("r_eff", 1e-7)):
        np.testing.assert_allclose(getattr(got, f).numpy()[act],
                                   ref[f][act], rtol=1e-5, atol=atol,
                                   err_msg=f)


# --------------------------------------------------------------- detection

@pytest.mark.parametrize("key", ["dense", "candidates"])
def test_detect_contacts(key, detected):
    """The same active set in the same order: sphere–sphere, then
    sphere–box, then sphere–triangle; with room for 20 the first 20 of the
    same order, and the true count."""
    jm, jc, js, _, ref = detected[key]
    _, tc, ts = carry(jm, jc, js)
    occ = int(tcl.cell_occupancy_max(tc.grid, tpipe._sphere_world(
        tc.spheres, ts)))
    assert occ == int(jcl.cell_occupancy_max(
        jc.grid, jpipe._sphere_world(jc.spheres, js)))
    assert occ <= tc.max_per_cell          # JAX's table is defined here
    got = tpipe.detect_contacts(tc, ts)
    assert_same_contacts(got, ref)
    n_act = int(np.asarray(ref.active).sum())
    kinds = set(np.asarray(ref.body_b)[np.asarray(ref.active)].tolist())
    if key == "dense":
        # every segment met: sphere pairs, the floor and the mover, mesh
        assert n_act == int(ref.count) > 30 and {0, N_SPH - 1} <= kinds
    else:
        assert n_act == 20 < int(ref.count)


def test_feature_table_and_topk(detected):
    jm, jc, js, _, _ = detected["dense"]
    _, tc, ts = carry(jm, jc, js)
    centers = np.asarray(jpipe._sphere_world(jc.spheres, js))
    feat = np.random.default_rng(8).normal(size=(N_SPH, 5)).astype(
        np.float32)
    for K in (8, 2):
        ref, ref_ovf = jit(lambda c, f: jcl.build_feature_table(
            jc.grid, c, f, K))(jnp.asarray(centers), jnp.asarray(feat))
        got, ovf = tcl.build_feature_table(tc.grid, torch.tensor(centers),
                                           torch.tensor(feat), K)
        assert int(ovf) == int(ref_ovf)
        if K == 8:
            assert int(ovf) == 0
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            ijk = tcl.cell_ijk(tc.grid, torch.tensor(centers))
            nf, inr = tcl.neighbor_feature_rows(tc.grid, got, ijk, K, 5)
            rnf, rinr = jit(lambda tb, q: jcl.neighbor_feature_rows(
                jc.grid, tb, q, K, 5))(ref, jnp.asarray(ijk.numpy()))
            np.testing.assert_array_equal(nf.numpy(), np.asarray(rnf))
            np.testing.assert_array_equal(inr.numpy(), np.asarray(rinr))
        else:
            assert int(ovf) > 0
    rng = np.random.default_rng(9)
    for n, cap in ((50, 20), (50, 80)):
        ok = rng.uniform(size=n) > 0.5
        ref = jit(lambda o: jcl.topk_select(o, cap))(jnp.asarray(ok))
        got = tcl.topk_select(torch.tensor(ok), cap)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_contact_and_rolling_rows(detected):
    jm, jc, js, _, ref = detected["dense"]
    _, _, ts = carry(jm, jc, js)
    tcon = convert.contacts_from_numpy(contacts_np(ref), device="cpu")
    for jrows, trows in (
            (jpipe.contact_rows(ref, js, 2e-3, 0.2, 0.5),
             tpipe.contact_rows(tcon, ts, 2e-3, 0.2, 0.5)),
            (jpipe.rolling_rows(ref, js), tpipe.rolling_rows(tcon, ts))):
        for f in ("body_a", "body_b", "body_c", "active"):
            np.testing.assert_array_equal(getattr(trows, f).numpy(),
                                          np.asarray(getattr(jrows, f)), f)
        for f in ("Ja_v", "Ja_w", "Jb_v", "Jb_w", "Jc_w", "rhs"):
            np.testing.assert_allclose(getattr(trows, f).numpy(),
                                       np.asarray(getattr(jrows, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)


def test_mesh_from_mesh_and_conversions(detected):
    jm, jc, js, (g, verts, faces), ref = detected["dense"]
    mesh = tpipe.MeshShapes.from_mesh(g, verts, faces, mu=0.45,
                                      device="cpu")
    assert_same_leaves(mesh, convert._carrier(
        tpipe.MeshShapes, leaves(jc.meshes), "cpu"), "mesh")
    tc = convert.collision_model_from_numpy(leaves(jc), device="cpu")
    assert (tc.envelope, tc.max_contacts, tc.mesh_candidates,
            tc.grid.dims) == (0.01, 256, 0, (10, 10, 7))
    params = jsmc.SMCParams(youngs=2e6, force_model="flores",
                            adhesion_model="perko", tangential_model="none")
    tp = convert.smc_params_from_numpy(leaves(params))
    assert tp == tsmc.SMCParams(youngs=2e6, force_model="flores",
                                adhesion_model="perko",
                                tangential_model="none")


# ---------------------------------------------------------------- nsc_step

def touching_drop_scene(**kw):
    """``drop_scene(n_spheres=4)`` with the spheres lowered into touch: the
    lowest 1 mm into the floor, each of the others 1 cm into the one
    below, with random speeds."""
    jm, jc, js = drop_scene(n_spheres=4, **kw)
    x = np.asarray(js.x).copy()
    x[1:, 2] = 0.499 + 0.99 * np.arange(4)
    rng = np.random.default_rng(60)
    js = js.replace(x=jnp.asarray(x),
                    v=jnp.asarray(rng.normal(size=(5, 3)).astype(
                        np.float32) * 0.2).at[0].set(0.0),
                    w=jnp.asarray(rng.normal(size=(5, 3)).astype(
                        np.float32)).at[0].set(0.0))
    return jm, jc, js


def one_contact(Contacts, xp, body, point, normal):
    """An analytic contact of ``body`` with the ground (body 0) at
    ``point`` along ``normal`` (A→B), 2 mm deep, beside an inactive
    slot."""
    f32 = xp.float32

    def arr(v, dtype=f32):
        return xp.asarray(np.asarray(v), dtype=dtype) if xp is jnp \
            else torch.as_tensor(np.asarray(v), dtype=dtype)

    return Contacts(
        body_a=arr([body, body], xp.int32), body_b=arr([0, 0], xp.int32),
        point=arr([point, point]), normal=arr([normal] * 2),
        gap=arr([-0.002, 1.0]), mu=arr([0.3, 0.3]), r_eff=arr([0.1, 0.1]),
        active=arr([True, False], xp.bool_ if xp is jnp else torch.bool),
        count=arr(1, xp.int32))


def nsc_pair(solver, dtype):
    """One step of ``touching_drop_scene`` in both packages: ``(port,
    JAX)`` results.  ``"direct"`` falls back to APGD, here with an
    analytic contact appended through ``extra_contacts_fn``;
    ``"rolling"`` is APGD with rolling and spinning friction.  In float64
    both packages run on the float32 scene's values."""
    rolling = solver == "rolling"
    name = "apgd" if rolling else solver
    jm, jc, js = touching_drop_scene(
        **(dict(mu_roll=0.02, mu_spin=0.01) if rolling else {}))
    tm, tc, ts = carry(jm, jc, js)
    jcc = tcc = None
    if solver == "direct":
        # on the side of the second sphere, pushing it along −x
        p, n = (0.6, 0.07, 1.489), (1.0, 0.0, 0.0)
        jcc = one_contact(jpipe.Contacts, jnp, 2, p, n)
        tcc = one_contact(tpipe.Contacts, torch, 2, p, n)
    m = (64 + 2 * (jcc is not None)) * 3 * (2 if rolling else 1)
    gw = np.random.default_rng(61).normal(size=m).astype(np.float32) * 1e-3
    t = torch.tensor(0.0)
    # BB, projected Jacobi and ADMM converge inside 300 iterations at 1e-5
    kw = dict(solver=name, max_iter=60, tol=1e-6, stab_factor=0.2) \
        if name in ("apgd", "direct") else \
        dict(solver=name, max_iter=300, tol=1e-5, stab_factor=0.2)
    with jax.enable_x64(dtype == np.float64):
        if dtype == np.float64:
            jm, jc, js, jcc = j64(jm), j64(jc), j64(js), j64(jcc)
            tm, tc, ts, tcc = t64(tm), t64(tc), t64(ts), t64(tcc)
            t = t.double()
        ref = jit(lambda s, g: jpipe.nsc_step(
            jm, jc, s, 0.0, 5e-3, jsys.SolverSettings(**kw), gamma_warm=g,
            extra_contacts_fn=None if jcc is None else lambda _: jcc))(
                js, jnp.asarray(gw.astype(dtype)))
    got = tpipe.nsc_step(
        tm, tc, ts, t, 5e-3, tsys.SolverSettings(**kw),
        gamma_warm=torch.tensor(gw.astype(dtype)),
        extra_contacts_fn=None if tcc is None else lambda _: tcc)
    assert np.asarray(ref[0].x).dtype == dtype
    assert got[0].x.numpy().dtype == dtype
    return got, ref


def assert_same_step(got, ref, x_tol, v_tol):
    assert int(got[1].count) == int(ref[1].count) >= 4
    assert int(got[2].iterations) == int(ref[2].iterations)
    np.testing.assert_allclose(got[0].x.numpy(), np.asarray(ref[0].x),
                               **x_tol)
    np.testing.assert_allclose(got[0].q.numpy(), np.asarray(ref[0].q),
                               rtol=0, atol=x_tol["atol"] / 10)
    for f in "vw":
        np.testing.assert_allclose(getattr(got[0], f).numpy(),
                                   np.asarray(getattr(ref[0], f)),
                                   err_msg=f, **v_tol)


@pytest.mark.parametrize("solver", ["bb", "pjacobi", "admm"])
def test_nsc_step(solver):
    """BB, projected Jacobi and ADMM converge inside their iterations: the
    same count, the North star's state tolerances, in float32."""
    assert_same_step(*nsc_pair(solver, np.float32), X_TOL, V_TOL)


@pytest.mark.parametrize("solver", ["apgd", "direct", "rolling"])
def test_nsc_step_apgd(solver):
    """APGD, the direct solver's APGD fallback, and APGD with rolling
    friction, in float64 on both sides (the float32 scene's values): the
    same iteration count, the state within 1e-9.  In float32 APGD stalls on
    its rounding floor on this stack in both packages (residual 2e-5 to
    4e-4; 60 and 300 iterations end at the same best iterate), and which
    iterate the floor leaves best turns on the order of a sum, so there
    the velocities differ by up to 4e-4 m/s and 2e-3 rad/s."""
    got, ref = nsc_pair(solver, np.float64)
    assert_same_step(got, ref, dict(rtol=1e-9, atol=1e-11),
                     dict(rtol=1e-9, atol=1e-10))


# ------------------------------------------------------ the general mixer

def jax_mixer_scene(n_target):
    """``bench_suite.py:83-199`` ``bench_mixer``'s scene, JAX side (the
    bench builds it inside the function that times it)."""
    radius = chip_smoke.MIXER_R
    spacing = 2.2 * radius
    box = 0.08 + spacing * int(np.ceil(n_target ** (1 / 3)) + 1)
    bld = JBuilder()
    ground = bld.add_ground()
    from chrono_tpu.utils.samplers import grid_sample_box
    pts = grid_sample_box((0.07, 0.07, 0.07),
                          (box - 0.07, box - 0.07, 4 * box),
                          spacing, jitter=0.05, seed=2)[:n_target]
    first = None
    for p in pts:
        b = bld.add_body(mass=0.2, inertia=(2e-4,) * 3, pos=p)
        first = b if first is None else first
    stirrer = bld.add_body(mass=20.0, inertia=(0.5, 0.5, 0.5),
                           pos=(box / 2, box / 2, 1.5 * radius))
    bld.add_motor_rotation_speed(ground, stirrer,
                                 (box / 2, box / 2, 1.5 * radius), (0, 0, 1),
                                 JFConst(2.0))
    model, state = bld.finalize()
    n = len(pts)
    spheres = jpipe.SphereShapes(
        body=jnp.arange(first, first + n), offset=jnp.zeros((n, 3)),
        radius=jnp.full((n,), radius), mu=jnp.full((n,), 0.4))
    t_w = 0.05
    half = box / 2
    wall_def = [
        ((half, half, -t_w / 2), (half, half, t_w / 2)),
        ((-t_w / 2, half, 2 * box), (t_w / 2, half + t_w, 2 * box)),
        ((box + t_w / 2, half, 2 * box), (t_w / 2, half + t_w, 2 * box)),
        ((half, -t_w / 2, 2 * box), (half + t_w, t_w / 2, 2 * box)),
        ((half, box + t_w / 2, 2 * box), (half + t_w, t_w / 2, 2 * box)),
    ]
    boxes = jpipe.BoxShapes(
        body=jnp.concatenate([jnp.zeros((5,), jnp.int32),
                              jnp.asarray([stirrer], jnp.int32)]),
        pos=jnp.concatenate([jnp.asarray([w[0] for w in wall_def]),
                             jnp.asarray([[0.3 * half, 0.0, 0.0]])]),
        rot=jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (6, 1)),
        half=jnp.concatenate([jnp.asarray([w[1] for w in wall_def]),
                              jnp.asarray([[0.3 * half, 0.02,
                                            2 * radius]])]),
        mu=jnp.full((6,), 0.4))
    cell = 2.2 * 2 * radius
    grid = jcl.GridSpec(origin=(-t_w, -t_w, -t_w), cell_size=cell,
                        dims=(int(np.ceil((box + 2 * t_w) / cell)),) * 2
                        + (int(np.ceil(5 * box / cell)),))
    coll = jpipe.CollisionModel(spheres=spheres, boxes=boxes, grid=grid,
                                max_per_cell=16, max_contacts=int(12 * n))
    settings = jsys.SolverSettings(solver="apgd", max_iter=50, tol=1e-4,
                                   stab_factor=0.2, max_recovery_speed=0.5,
                                   valence_bound=32)
    return model, coll, state, settings


def mixer_steps(jm, jc, js, tm, tc, ts, settings, dtype, steps=3):
    """``steps`` mixer steps in both packages from one scene, the warm
    start carried as the bench carries it: per step ``(port, JAX)``."""
    h = 2e-3
    out = []
    with jax.enable_x64(dtype == np.float64):
        if dtype == np.float64:
            jm, jc, js = j64(jm), j64(jc), j64(js)
            tm, tc, ts = t64(tm), t64(tc), t64(ts)
        step = jit(lambda s, t, g: jpipe.nsc_step(jm, jc, s, t, h, settings,
                                                  gamma_warm=g))
        m = jc.max_contacts * 3 + chip_smoke.mixer_bilateral_rows(tm)
        jg, tg = jnp.zeros((m,), dtype), torch.zeros(m, dtype=ts.x.dtype)
        jt, tt = jnp.asarray(0.0, dtype), torch.zeros((), dtype=ts.x.dtype)
        for _ in range(steps):
            js, jcon, jinfo = step(js, jt, jg)
            ts, tcon, tinfo = tpipe.nsc_step(
                tm, tc, ts, tt, h, tsys.SolverSettings(
                    **dataclasses.asdict(settings)), gamma_warm=tg)
            jg, tg = jinfo.joint_reactions * h, tinfo.joint_reactions * h
            jt, tt = jt + h, tt + h
            out.append(((ts, tcon, tinfo), (js, jcon, jinfo)))
    return out


def test_general_mixer_125_spheres_3_steps():
    """The port's scene (``chip_smoke.general_mixer_scene``) equals the
    converted JAX scene, then 3 steps at the bench's settings in float64 on
    both sides (the float32 scene's values): the same contacts and
    iteration counts, the North star's state tolerances.

    In float32 the two packages' paths part: APGD's 50 iterations stop
    short of convergence on the stirrer's rows (a 20 kg body on a motor's
    6 rows among 0.2 kg spheres), and from about its 15th iteration the
    path turns on the sign of its restart test, which rounding flips (the
    float32 runs end 3 steps with v up to 5e-4 m/s apart and iteration
    counts 50, 21, 11 against 50, 21, 17).  ``chip_smoke.py`` holds the
    card to the port's CPU run on the same scene."""
    jm, jc, js, jset = jax_mixer_scene(125)
    tm, tc, ts = carry(jm, jc, js)
    pm, pc, pstate, pset, _, _ = chip_smoke.general_mixer_scene(125, "cpu")
    assert_same_leaves(pm, tm)
    assert_same_leaves(pc, tc, "coll")
    assert_same_leaves(pstate, ts, "state")
    assert dataclasses.asdict(pset) == {
        f.name: getattr(jset, f.name) for f in dataclasses.fields(jset)}
    for k, ((ts1, tcon, tinfo), (js1, jcon, jinfo)) in enumerate(
            mixer_steps(jm, jc, js, tm, tc, ts, jset, np.float64)):
        assert int(tcon.count) == int(jcon.count) > 0, k
        np.testing.assert_array_equal(tcon.body_b.numpy(),
                                      np.asarray(jcon.body_b))
        assert int(tinfo.iterations) == int(jinfo.iterations), k
        assert ts1.x.numpy().dtype == np.float64
        np.testing.assert_allclose(ts1.x.numpy(), np.asarray(js1.x),
                                   **X_TOL)
        np.testing.assert_allclose(ts1.v.numpy(), np.asarray(js1.v),
                                   **V_TOL)


# ---------------------------------------------------------------------- SMC

SMC_MODELS = [(f, a, t) for f in ("hertz", "hooke", "flores")
              for a in ("constant", "dmt", "perko")
              for t in ("none", "one_step")]


def test_smc_contact_forces_every_model(detected):
    """Every force × adhesion × tangential model on the detection scene's
    contacts (random speeds and spins), forces and body-frame torques."""
    jm, jc, js, _, ref = detected["dense"]
    tm, _, ts = carry(jm, jc, js)
    tcon = convert.contacts_from_numpy(contacts_np(ref), device="cpu")
    base = dict(youngs=1e6, poisson=0.3, restitution=0.4, adhesion=0.5,
                adhesion_mult_dmt=2.0, adhesion_s_perko=3.0, char_vel=0.5)
    for fm, am, tm_ in SMC_MODELS:
        kw = dict(base, force_model=fm, adhesion_model=am,
                  tangential_model=tm_)
        jf, jt = jsmc.smc_contact_forces(jsmc.SMCParams(**kw), jm, js, ref,
                                         1e-4)
        tf, tt = tsmc.smc_contact_forces(tsmc.SMCParams(**kw), tm, ts, tcon,
                                         1e-4)
        for g, r, what in ((tf, jf, "f"), (tt, jt, "tau")):
            r = np.asarray(r)
            np.testing.assert_allclose(
                g.numpy(), r, rtol=1e-4, atol=1e-5 * np.abs(r).max(),
                err_msg=f"{what} {fm} {am} {tm_}")


def test_smc_step(detected):
    jm, jc, js, _, _ = detected["dense"]
    tm, tc, ts = carry(jm, jc, js)
    params = dict(youngs=1e6, poisson=0.3, restitution=0.4)
    ref = jit(lambda s: jsmc.smc_step(jm, jc, s, 0.0, 1e-4,
                                      jsmc.SMCParams(**params)))(js)
    got = tsmc.smc_step(tm, tc, ts, torch.tensor(0.0), 1e-4,
                        tsmc.SMCParams(**params))
    assert int(got[1].count) == int(ref[1].count)
    np.testing.assert_allclose(got[0].x.numpy(), np.asarray(ref[0].x),
                               **X_TOL)
    for f in "vw":
        np.testing.assert_allclose(getattr(got[0], f).numpy(),
                                   np.asarray(getattr(ref[0], f)),
                                   err_msg=f, **V_TOL)


# ----------------------------------------------------------------- refusals

def test_refusals(detected):
    """Convex shapes, once refused, are carried and detected: a capsule on
    the moving body and a convex box on the ground added to the detection
    scene, carried by ``convert.collision_model_from_numpy`` and detected
    as the JAX package detects them (float64 on both sides: MPR's
    tolerance, gap 1e-5 and normal / point 1e-4; sphere–convex,
    convex–convex and convex–triangle rows in its segment order).  Shafts,
    the card by default and an unknown solver as before."""
    jm, jc, js, _, _ = detected["dense"]
    tm, tc, ts = carry(jm, jc, js)
    qy = np.array([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0])
    cv = {"body": np.asarray([jm.n_bodies - 1, 0], np.int32),
          "kind": np.asarray([2, 1], np.int32),          # capsule, box
          "pos": np.asarray([[0.12, 0.0, 0.0], [0.3, 0.6, -0.08]],
                            np.float32),
          "rot": np.asarray([qy, [1.0, 0, 0, 0]], np.float32),
          "data": np.asarray([[0.07, 0.1, 0.0], [0.25, 0.2, 0.1]],
                             np.float32),
          "verts": np.zeros((2, 8, 3), np.float32),
          "mu": np.asarray([0.4, 0.45], np.float32),
          "family": np.asarray([0, 0], np.int32)}
    lv = leaves(jc)
    lv["convex"] = cv
    tcv = convert.collision_model_from_numpy(lv, device="cpu")
    assert tcv.convex.n == 2
    for k, v in cv.items():
        np.testing.assert_array_equal(getattr(tcv.convex, k).numpy(), v)
    jcv = jc.replace(convex=jpipe.ConvexShapes(
        **{k: jnp.asarray(v) for k, v in cv.items()}))
    with jax.enable_x64(True):
        ref = contacts_np(jit(lambda s: jpipe.detect_contacts(
            j64(jcv), s))(j64(js)))
    got = tpipe.detect_contacts(t64(tcv), t64(ts))
    n_plain = int(detected["dense"][4].count)
    assert int(got.count) == int(ref["count"]) > n_plain
    np.testing.assert_array_equal(got.active.numpy(), ref["active"])
    act = ref["active"]
    for f in ("body_a", "body_b"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[act],
                                      ref[f][act], err_msg=f)
    convex_bodies = (ref["body_a"][act] == jm.n_bodies - 1) | (
        ref["body_b"][act] == jm.n_bodies - 1)
    assert convex_bodies.any()
    for f, atol in (("gap", 1e-5), ("normal", 1e-4), ("point", 1e-4),
                    ("mu", 0), ("r_eff", 1e-7)):
        np.testing.assert_allclose(getattr(got, f).numpy()[act],
                                   ref[f][act], rtol=1e-5, atol=atol,
                                   err_msg=f)
    # shafts, once refused here, are taken: a zero torque pair leaves both
    # contact steps as they were (tests/test_torch_shafts.py holds shafts
    # to the JAX package)
    zero_pair = tm.replace(shaft_elements=tshafts.ShaftTorqueElements(
        shaft_a=torch.tensor([0], dtype=torch.int32),
        shaft_b=torch.tensor([1], dtype=torch.int32),
        kind=torch.tensor([2], dtype=torch.int32), k=torch.zeros(1),
        c=torch.zeros(1), rest=torch.zeros(1)))
    t0 = torch.tensor(0.0)
    for step in (tpipe.nsc_step, tsmc.smc_step):
        got, ref = step(zero_pair, tc, ts, t0, 1e-3)[0], \
            step(tm, tc, ts, t0, 1e-3)[0]
        for f in "xqvw":
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    with pytest.raises(ValueError, match="unknown solver"):
        tpipe.nsc_step(tm, tc, ts, torch.tensor(0.0), 1e-3,
                       tsys.SolverSettings(solver="psor"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.MeshShapes.from_mesh(0, np.eye(3), [[0, 1, 2]])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TBuilder()
