"""PyTorch port (chrono_tpu_torch) vs the JAX package: convex contact.

- MPR: every case of tests/test_mpr.py (support functions, the analytic
  pairs, a separated pair) in float32, and its batch with 240 random pairs
  over the five kinds (sphere, box, capsule, z-cylinder, padded hull),
  rotated, touching and separated, in float64 on both sides.  Tolerance: gap atol
  1e-5, normal and point atol 1e-4 (unit-size shapes).  MPR ends in a
  compass search and a support-point choice that break ties by rounding
  (``argmin`` of near-equal support heights, ``sign`` of a zero direction
  component, the ``spread`` comparison of two near-equal sums), so some
  pairs are ill-conditioned: the JAX package's own answer moves beyond the
  tolerance when the pair's float64 positions move by ~1e-9.  Those pairs
  are listed and excluded; they must stay a minority.
- ``convex_triangle_batch`` on the ramp of tests/test_mesh_contact.py:93
  (a cylinder over two triangles) at random poses, float32.
- ``detect_contacts`` and 10 ``nsc_step``s on the capsule–box scene of
  tests/test_contact.py's ``TestConvexNSC``, the cylinder on the mesh
  ramp and a sphere-on-convex scene: the rows at step 0 (same active set
  and order, bodies to the bit, gap / normal / point within the MPR
  tolerance) and the states within the North star's tolerances, widened
  only where the JAX run's own response to ~1e-7 perturbations of its
  start is larger (then to twice that response).
- ``profile_circle_contacts`` and 20 steps of tests/test_profile2d.py's
  pin in a slot; the ray tests of tests/test_ray.py and a chunked
  triangle soup; tests/test_decomp.py's meshes through ``voxelize`` and
  ``decompose_boxes`` (numpy on both sides: equal) and the parts as
  ``ConvexShapes``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu.collision import decomp as jdecomp
from chrono_tpu.collision import mpr as jm
from chrono_tpu.collision import pipeline as jpipe
from chrono_tpu.collision import profile2d as jp2d
from chrono_tpu.collision import ray as jray
from chrono_tpu.physics.builder import SystemBuilder as JBuilder
from chrono_tpu.physics.system import SolverSettings as JSettings

from chrono_tpu_torch import convert
from chrono_tpu_torch.collision import decomp as tdecomp
from chrono_tpu_torch.collision import mpr as tm
from chrono_tpu_torch.collision import pipeline as tpipe
from chrono_tpu_torch.collision import profile2d as tp2d
from chrono_tpu_torch.collision import ray as tray
from chrono_tpu_torch.physics.system import SolverSettings as TSettings

O0 = {"xla_backend_optimization_level": 0}
GAP_ATOL, N_ATOL, P_ATOL = 1e-5, 1e-4, 1e-4
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


def leaves(obj):
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: leaves(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [leaves(v) for v in obj]
    if dataclasses.is_dataclass(obj):
        return {f.name: leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def shapes(kind, pos, rot, data, verts, dtype=np.float32):
    """The same shapes for both packages from numpy arrays."""
    arrs = (np.asarray(kind, np.int32), np.asarray(pos, dtype),
            np.asarray(rot, dtype), np.asarray(data, dtype),
            np.asarray(verts, dtype))
    return (jm.ConvexShape(*(jnp.asarray(a) for a in arrs)),
            tm.ConvexShape(*(torch.as_tensor(a) for a in arrs)))


def bad_pairs(got, ref):
    """Pairs outside the tolerance (any of gap, normal, point)."""
    eg = np.abs(got[0] - ref[0]).reshape(len(ref[0]), -1).max(1) \
        if np.ndim(ref[0]) else np.abs(got[0] - ref[0])[None]
    en = np.abs(got[1] - ref[1]).reshape(eg.shape[0], -1).max(1)
    ep = np.abs(got[2] - ref[2]).reshape(eg.shape[0], -1).max(1)
    return (eg > GAP_ATOL) | (en > N_ATOL) | (ep > P_ATOL)


def self_response(run, state_like, scale, n=2, seed=7):
    """The largest change of each output leaf of the JAX ``run`` when its
    input's float leaves move by ~``scale`` (relative) in ``n`` random
    ways: the reference's own sensitivity to rounding of its input."""
    rng = np.random.default_rng(seed)
    base = jax.tree_util.tree_map(np.asarray, run(state_like))
    out = jax.tree_util.tree_map(lambda a: np.zeros((), np.float64), base)
    for _ in range(n):
        pert = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) * (1.0 + scale * rng.normal(
                size=np.shape(a))), np.asarray(a).dtype)
            if np.asarray(a).dtype.kind == "f" else a, state_like)
        got = jax.tree_util.tree_map(np.asarray, run(pert))
        out = jax.tree_util.tree_map(
            lambda r, g, b: np.maximum(r, np.abs(g.astype(np.float64)
                                                 - b).max(initial=0.0))
            if b.dtype.kind == "f" else r, out, got, base)
    return base, out


# --------------------------------------------------------- tests/test_mpr

def _one(kind, pos, rot=(1.0, 0, 0, 0), data=(0.0, 0.0, 0.0), verts=None):
    v = np.zeros((8, 3)) if verts is None else np.concatenate(
        [verts, np.repeat(np.asarray(verts)[-1:], 8 - len(verts), 0)])
    return kind, pos, rot, data, v


Q45 = (np.cos(np.pi / 8), 0, np.sin(np.pi / 8), 0)
D45 = np.array([np.sin(np.pi / 4), 0, np.cos(np.pi / 4)])
MPR_CASES = {
    "sphere_sphere": (_one(jm.SPHERE, (0, 0, 0), data=(0.5, 0, 0)),
                      _one(jm.SPHERE, (0.8, 0, 0), data=(0.5, 0, 0))),
    "box_sphere": (_one(jm.BOX, (0, 0, 0), data=(1.0, 1.0, 1.0)),
                   _one(jm.SPHERE, (0, 0, 1.3), data=(0.5, 0, 0))),
    "box_box": (_one(jm.BOX, (0, 0, 0), data=(1.0, 1.0, 1.0)),
                _one(jm.BOX, (0, 0, 1.9), data=(1.0, 1.0, 1.0))),
    "cylinder_plane": (_one(jm.BOX, (0, 0, -1.0), data=(5.0, 5.0, 1.0)),
                       _one(jm.CYLINDER, (0, 0, 0.45), data=(0.3, 0.5, 0))),
    "rotated_box_sphere": (_one(jm.BOX, (0, 0, 0), rot=Q45,
                                data=(1.0, 1.0, 1.0)),
                           _one(jm.SPHERE, tuple(1.2 * D45),
                                data=(0.5, 0, 0))),
    "separated": (_one(jm.SPHERE, (0, 0, 0), data=(0.5, 0, 0)),
                  _one(jm.SPHERE, (2.0, 0, 0), data=(0.5, 0, 0))),
}


@pytest.fixture(scope="module")
def jmpr():
    return jit(jm.mpr_contact)


def test_support_functions():
    """tests/test_mpr.py::test_support_functions' shapes and directions,
    and a hull, on both sides (float32 rounding)."""
    cases = [_one(jm.SPHERE, (1, 2, 3), data=(0.5, 0, 0)),
             _one(jm.BOX, (0, 0, 0), data=(1.0, 2.0, 3.0)),
             _one(jm.CYLINDER, (0, 0, 0), data=(0.5, 1.0, 0)),
             _one(jm.CAPSULE, (0, 1, 0), rot=Q45, data=(0.3, 0.7, 0)),
             _one(jm.HULL, (0, 0, 0),
                  verts=[[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])]
    dirs = np.asarray([[0.0, 0.0, 1.0], [1.0, -1.0, 1.0], [1.0, 0.0, 0.5],
                       [0.3, -0.2, -0.9], [0.0, 1.0, 0.0]], np.float32)
    for case in cases:
        js, ts = shapes(*case)
        for d in dirs:
            ref = np.asarray(jm.support(js, jnp.asarray(d)))
            got = tm.support(ts, torch.as_tensor(d)).numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(MPR_CASES))
def test_mpr_cases(case, jmpr):
    """Each pair of tests/test_mpr.py in float32.  A smooth minimum (two
    curved shapes) fixes the normal only to ~√eps32 ≈ 3e-4: where the JAX
    answer itself moves past the tolerance when the positions move by
    ~1e-6 relative, that field is held within twice that move."""
    (ja, ta), (jb, tb) = (shapes(*c) for c in MPR_CASES[case])
    ref, resp = self_response(lambda ab: jmpr(*ab), (ja, jb), 1e-6)
    got = [x.numpy() for x in tm.mpr_contact(ta, tb)]
    for k, tol in enumerate((GAP_ATOL, N_ATOL, P_ATOL)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=max(tol, 2.0 * float(resp[k])),
                                   err_msg=f"{case} output {k}")


def random_pairs(n, seed):
    rng = np.random.default_rng(seed)
    kind = np.tile(np.arange(5, dtype=np.int32), (2, n // 5 + 1))[:, :n]
    kind[1] = rng.permutation(kind[1])
    pos = rng.uniform(-1.0, 1.0, (2, n, 3))
    q = rng.normal(size=(2, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    data = rng.uniform(0.3, 0.8, (2, n, 3))
    verts = rng.uniform(-0.6, 0.6, (2, n, 8, 3))
    return kind, pos, q, data, verts


def test_random_pairs_float64():
    """tests/test_mpr.py::test_batched_vmap's three sphere pairs and 240
    random pairs over all five kinds (each kind against each), as one
    batch in float64 on both sides; the ill-conditioned pairs (the JAX
    answer moves beyond the tolerance when the positions move by ~1e-9 or
    ~1e-7 in two random ways each) are excluded and listed."""
    kind, pos, q, data, verts = random_pairs(240, seed=0)
    # tests/test_mpr.py::test_batched_vmap: spheres 0.6, 0.8, 0.95 apart
    pos[:, :3] = 0.0
    pos[1, :3, 0] = [0.6, 0.8, 0.95]
    kind[:, :3] = jm.SPHERE
    data[:, :3] = [0.5, 0.0, 0.0]
    n = kind.shape[1]
    rng = np.random.default_rng(1)
    with jax.enable_x64(True):
        f = jit(jm.mpr_contact_batch)

        def jrun(p):
            a = jm.ConvexShape(*(jnp.asarray(x[0]) for x in
                                 (kind, p, q, data, verts)))
            b = jm.ConvexShape(*(jnp.asarray(x[1]) for x in
                                 (kind, p, q, data, verts)))
            return [np.asarray(x) for x in f(a, b)]

        ref = jrun(pos)
        ill = np.zeros(n, bool)
        for scale in (1e-9, 1e-9, 1e-7, 1e-7):
            ill |= bad_pairs(jrun(pos + scale * rng.normal(size=pos.shape)),
                             ref)
    ta = tm.ConvexShape(*(torch.as_tensor(x[0]) for x in
                          (kind, pos, q, data, verts)))
    tb = tm.ConvexShape(*(torch.as_tensor(x[1]) for x in
                          (kind, pos, q, data, verts)))
    got = [x.numpy() for x in tm.mpr_contact(ta, tb)]
    assert got[0].dtype == np.float64
    bad = bad_pairs(got, ref)
    touching = ref[0] < 0
    assert 0.25 * n < touching.sum() < 0.75 * n
    assert ill.sum() < 0.2 * n, f"{ill.sum()} ill-conditioned pairs"
    assert not (bad & ~ill).any(), (
        f"pairs {np.nonzero(bad & ~ill)[0].tolist()} differ; "
        f"ill-conditioned (excluded): {np.nonzero(ill)[0].tolist()}")
    assert not ill[:3].any()
    np.testing.assert_allclose(got[0][:3], [-0.4, -0.2, -0.05], atol=6e-3)


# ------------------------------------------------- convex vs triangle ramp

def ramp_mesh():
    """tests/test_mesh_contact.py:93's ramp: a square tilted 15° about y,
    two triangles."""
    ang = np.deg2rad(15)
    ca, sa = np.cos(ang), np.sin(ang)
    verts = [(x * ca, y, -x * sa)
             for (x, y) in [(-1.5, -1), (1.5, -1), (1.5, 1), (-1.5, 1)]]
    return np.asarray(verts, np.float32), np.asarray([(0, 1, 2), (0, 2, 3)])


QX = np.array([np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0])


def test_convex_triangle_ramp():
    """The cylinder of the ramp test (r 0.3, half length 0.4, axis along
    world y) at 60 random poses over and across both triangles' edges,
    against each triangle: the five manifold rows a pair."""
    verts, faces = ramp_mesh()
    rng = np.random.default_rng(2)
    n = 60
    pos = np.stack([rng.uniform(-1.8, 1.8, n), rng.uniform(-1.3, 1.3, n),
                    rng.uniform(0.0, 0.6, n)], 1)
    tilt = rng.normal(size=(n, 4)) * 0.15
    tilt[:, 0] = 1.0
    tilt /= np.linalg.norm(tilt, axis=1, keepdims=True)
    rot = np.asarray([[a[0] * b[0] - a[1:] @ b[1:],
                       *(a[0] * b[1:] + b[0] * a[1:]
                         + np.cross(a[1:], b[1:]))]
                      for a, b in zip(tilt, [QX] * n)])
    P = 2 * n
    idx = np.repeat(np.arange(n), 2)
    tri = np.tile(np.arange(2), n)
    js, ts = shapes(np.full(P, jm.CYLINDER), pos[idx], rot[idx],
                    np.tile([0.3, 0.4, 0.0], (P, 1)), np.zeros((P, 8, 3)))
    v = [verts[faces[tri, i]] for i in range(3)]
    ref = [np.asarray(x) for x in jit(jm.convex_triangle_batch)(
        js, *(jnp.asarray(a) for a in v))]
    got = [x.numpy() for x in tm.convex_triangle_batch(
        ts, *(torch.as_tensor(a) for a in v))]
    np.testing.assert_array_equal(got[3], ref[3])
    assert ref[3].any() and not ref[3].all()
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=GAP_ATOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=N_ATOL)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=P_ATOL)
    assert tm.N_TRI_MANIFOLD == jm.N_TRI_MANIFOLD == got[0].shape[1]


# ------------------------------------------------------- pipeline scenes

def _no_spheres():
    return jpipe.SphereShapes(body=jnp.zeros((0,), jnp.int32),
                              offset=jnp.zeros((0, 3)),
                              radius=jnp.zeros((0,)), mu=jnp.zeros((0,)))


def capsule_box_scene():
    """tests/test_contact.py's TestConvexNSC: a capsule (axis along world
    x) over a ground box, sunk to z = 0.2 (< r)."""
    b = JBuilder()
    g = b.add_ground()
    cap = b.add_body(mass=2.0, inertia=(0.1, 0.15, 0.15),
                     pos=(0.0, 0.0, 0.2))
    model, state = b.finalize()
    qy = np.array([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0])
    convex = jpipe.ConvexShapes(
        body=jnp.asarray([g, cap], jnp.int32),
        kind=jnp.asarray([jm.BOX, jm.CAPSULE], jnp.int32),
        pos=jnp.asarray([[0.0, 0.0, -0.5], [0.0, 0.0, 0.0]]),
        rot=jnp.asarray([[1.0, 0, 0, 0], qy], jnp.float32),
        data=jnp.asarray([[10.0, 10.0, 0.5], [0.25, 0.3, 0.0]]),
        verts=jnp.zeros((2, 8, 3)), mu=jnp.asarray([0.5, 0.5]))
    coll = jpipe.CollisionModel(
        spheres=_no_spheres(), boxes=None, convex=convex,
        grid=jpipe.GridSpec(origin=(-12.0, -12.0, -2.0), cell_size=1.2,
                            dims=(20, 20, 8)),
        max_per_cell=8, max_contacts=16)
    return model, coll, state, dict(solver="apgd", max_iter=120,
                                    stab_factor=0.2), 2e-3


def ramp_scene():
    """tests/test_mesh_contact.py's cylinder on the mesh ramp (its convex
    shape, its mesh, envelope 0.01), the cylinder just touching."""
    b = JBuilder()
    g = b.add_ground()
    cyl = b.add_body(mass=2.0, inertia=(0.1, 0.1, 0.1), pos=(0.0, 0.0, 0.3))
    model, state = b.finalize()
    verts, faces = ramp_mesh()
    meshes = jpipe.MeshShapes.from_mesh(g, verts, faces, mu=0.1)
    convex = jpipe.ConvexShapes(
        body=jnp.asarray([cyl], jnp.int32),
        kind=jnp.asarray([jm.CYLINDER], jnp.int32),
        pos=jnp.zeros((1, 3)), rot=jnp.asarray([QX], jnp.float32),
        data=jnp.asarray([[0.3, 0.4, 0.0]]), verts=jnp.zeros((1, 8, 3)),
        mu=jnp.asarray([0.1]))
    coll = jpipe.CollisionModel(
        spheres=_no_spheres(), boxes=None, convex=convex, meshes=meshes,
        grid=jpipe.GridSpec(origin=(-4, -4, -2), cell_size=1.2,
                            dims=(8, 8, 6)),
        max_contacts=32, envelope=0.01)
    return model, coll, state, dict(solver="apgd", max_iter=100), 1e-3


def sphere_convex_scene():
    """Two spheres dropping onto a ground box and onto a hull (a
    tetrahedron) resting on it: sphere–convex and convex–convex pairs."""
    b = JBuilder()
    g = b.add_ground()
    s1 = b.add_body(mass=1.0, inertia=(0.01,) * 3, pos=(-0.5, 0.0, 0.19))
    s2 = b.add_body(mass=1.0, inertia=(0.01,) * 3, pos=(0.52, 0.03, 0.62))
    tet = b.add_body(mass=3.0, inertia=(0.05,) * 3, pos=(0.5, 0.0, 0.0))
    model, state = b.finalize()
    tv = [[0.0, 0.0, -0.01], [0.4, 0.0, -0.01], [0.0, 0.4, -0.01],
          [0.1, 0.1, 0.4]]
    verts = np.zeros((2, 8, 3), np.float32)
    verts[1] = np.concatenate([tv, np.repeat([tv[-1]], 4, 0)]) - [0.1, 0.1,
                                                                 0.0]
    convex = jpipe.ConvexShapes(
        body=jnp.asarray([g, tet], jnp.int32),
        kind=jnp.asarray([jm.BOX, jm.HULL], jnp.int32),
        pos=jnp.asarray([[0.0, 0.0, -0.5], [0.0, 0.0, 0.0]]),
        rot=jnp.asarray([[1.0, 0, 0, 0]] * 2, jnp.float32),
        data=jnp.asarray([[5.0, 5.0, 0.5], [0.0, 0.0, 0.0]]),
        verts=jnp.asarray(verts), mu=jnp.asarray([0.4, 0.6]))
    spheres = jpipe.SphereShapes(
        body=jnp.asarray([s1, s2], jnp.int32), offset=jnp.zeros((2, 3)),
        radius=jnp.asarray([0.2, 0.15]), mu=jnp.asarray([0.5, 0.5]))
    coll = jpipe.CollisionModel(
        spheres=spheres, boxes=None, convex=convex,
        grid=jpipe.GridSpec(origin=(-2, -2, -1), cell_size=0.5,
                            dims=(8, 8, 6)),
        max_contacts=32)
    return model, coll, state, dict(solver="apgd", max_iter=100,
                                    stab_factor=0.2), 2e-3


SCENES = {"capsule_box": capsule_box_scene, "mesh_ramp": ramp_scene,
          "sphere_convex": sphere_convex_scene}


def carry(jmodel, jcoll, jstate):
    return (convert.mbs_model_from_numpy(leaves(jmodel), device="cpu"),
            convert.collision_model_from_numpy(leaves(jcoll), device="cpu"),
            convert.body_state_from_numpy(
                {f: np.asarray(getattr(jstate, f)) for f in "xqvw"},
                device="cpu"))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pipeline_scene(scene):
    jmodel, jcoll, jstate, kw, h = SCENES[scene]()
    n = 10

    def run(s):
        c0 = jpipe.detect_contacts(jcoll, s)

        def body(carry, _):
            s, t = carry
            s, _, _ = jpipe.nsc_step(jmodel, jcoll, s, t, h, JSettings(**kw))
            return (s, t + h), None

        (s, _), _ = jax.lax.scan(body, (s, jnp.asarray(0.0)), None,
                                 length=n)
        return c0, s

    (jc0, js), (_, resp) = self_response(jit(run), jstate, 1e-7)
    tmodel, tcoll, ts = carry(jmodel, jcoll, jstate)
    assert tcoll.convex is not None and tcoll.convex.n > 0
    tc0 = tpipe.detect_contacts(tcoll, ts)
    np.testing.assert_array_equal(tc0.active.numpy(), jc0.active)
    assert int(tc0.count) == int(jc0.count) > 0
    act = jc0.active
    for f in ("body_a", "body_b"):
        np.testing.assert_array_equal(getattr(tc0, f).numpy()[act],
                                      getattr(jc0, f)[act])
    np.testing.assert_allclose(tc0.gap.numpy()[act], jc0.gap[act], rtol=0,
                               atol=GAP_ATOL)
    np.testing.assert_allclose(tc0.normal.numpy()[act], jc0.normal[act],
                               rtol=0, atol=N_ATOL)
    np.testing.assert_allclose(tc0.point.numpy()[act], jc0.point[act],
                               rtol=0, atol=P_ATOL)
    t = torch.tensor(0.0)
    for _ in range(n):
        ts, _, _ = tpipe.nsc_step(tmodel, tcoll, ts, t, h, TSettings(**kw))
        t = t + h
    assert_state_within(ts, js, resp, scene)


def assert_state_within(ts, js, resp, what):
    """The North star's tolerances, each field's atol widened to twice the
    JAX run's own response to ~1e-7 perturbations of its start where that
    is larger (a contact's friction solve stops at its iteration cap, and
    a resting body's residual spin is what the solve leaves)."""
    for f, tol in (("x", X_TOL), ("q", X_TOL), ("v", V_TOL), ("w", V_TOL)):
        np.testing.assert_allclose(
            getattr(ts, f).numpy(), getattr(js, f), rtol=tol["rtol"],
            atol=max(tol["atol"], 2.0 * float(getattr(resp, f))),
            err_msg=f"{what} {f} (JAX's own response "
                    f"{float(getattr(resp, f)):.2e})")


# ----------------------------------------------------------- 2-D profiles

def slot_profile(pkg, body, as_tensor):
    """tests/test_profile2d.py's slot: two wall segments and two concave
    end arcs in the world x–z plane."""
    half_len, half_w = 0.2, 0.03
    fr = (np.cos(-np.pi / 4), np.sin(-np.pi / 4), 0.0, 0.0)
    a = lambda x: as_tensor(np.asarray(x, np.float32))
    return pkg.Profile2D(
        body=body, frame_rot=fr, frame_pos=(0.0, 0.0, 0.0),
        seg_a=a([[-half_len, half_w], [-half_len, -half_w]]),
        seg_b=a([[half_len, half_w], [half_len, -half_w]]),
        arc_c=a([[half_len, 0.0], [-half_len, 0.0]]),
        arc_r=a([half_w, half_w]), arc_a0=a([-np.pi / 2, np.pi / 2]),
        arc_a1=a([np.pi / 2, 3 * np.pi / 2]), arc_convex=a([-1.0, -1.0]))


def test_profile_pin_in_slot():
    bld = JBuilder()
    bld.set_gravity((2.0, 0.0, -9.81))
    g = bld.add_ground()
    pin = bld.add_body(mass=0.5, inertia=(1e-3,) * 3, pos=(0.0, 0.0, 0.0))
    model, state = bld.finalize()
    jprof = slot_profile(jp2d, g, jnp.asarray)
    jcirc = jp2d.ProfileCircles(body=jnp.asarray([pin], jnp.int32),
                                offset=jnp.zeros((1, 2)),
                                radius=jnp.asarray([0.02]),
                                mu=jnp.asarray([0.1]))
    tprof = convert.profile2d_from_numpy(jprof._asdict(), device="cpu")
    tcirc = convert.profile_circles_from_numpy(jcirc._asdict(),
                                               device="cpu")
    coll = jpipe.CollisionModel(spheres=_no_spheres(), boxes=None,
                                grid=jpipe.GridSpec(origin=(-2, -2, -2),
                                                    cell_size=1.0,
                                                    dims=(4, 4, 4)),
                                max_contacts=8)
    # the contacts at pin positions over the slot and its pockets
    rng = np.random.default_rng(3)
    xs = np.stack([rng.uniform(-0.26, 0.26, 40), rng.uniform(-0.1, 0.1, 40),
                   rng.uniform(-0.05, 0.05, 40)], 1).astype(np.float32)
    for x in xs:
        st = {f: np.asarray(getattr(state, f)).copy() for f in "xqvw"}
        st["x"][pin] = x
        ref = jp2d.profile_circle_contacts(
            jprof, jcirc, state.replace(**{f: jnp.asarray(a)
                                           for f, a in st.items()}))
        got = tp2d.profile_circle_contacts(
            tprof, tcirc, convert.body_state_from_numpy(st, device="cpu"))
        assert bool(got.active[0]) == bool(ref.active[0])
        for f in ("gap", "normal", "point"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
    # 20 steps of the pin falling into the slot's +x pocket
    kw, h, n = dict(solver="apgd", max_iter=120), 1e-3, 20

    def run(s):
        def body(carry, _):
            s, t = carry
            s, _, _ = jpipe.nsc_step(
                model, coll, s, t, h, JSettings(**kw),
                extra_contacts_fn=lambda q: jp2d.profile_circle_contacts(
                    jprof, jcirc, q))
            return (s, t + h), None
        return jax.lax.scan(body, (s, jnp.asarray(0.0)), None, length=n)[0][0]

    js, resp = self_response(jit(run), state, 1e-7)
    tmodel, tcoll, ts = carry(model, coll, state)
    t = torch.tensor(0.0)
    for _ in range(n):
        ts, _, _ = tpipe.nsc_step(
            tmodel, tcoll, ts, t, h, TSettings(**kw),
            extra_contacts_fn=lambda q: tp2d.profile_circle_contacts(
                tprof, tcirc, q))
        t = t + h
    assert_state_within(ts, js, resp, "pin in slot")


# ------------------------------------------------------------------ rays

def _pair(*arrays):
    return ([jnp.asarray(np.asarray(a, np.float32)) for a in arrays],
            [torch.as_tensor(np.asarray(a, np.float32)) for a in arrays])


def assert_hits(got, ref):
    tg, ng = (x.numpy() for x in got)
    tr, nr = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(np.isfinite(tg), np.isfinite(tr))
    hit = np.isfinite(tr)
    np.testing.assert_allclose(tg[hit], tr[hit], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ng[hit], nr[hit], rtol=0, atol=1e-6)


def test_rays():
    """tests/test_ray.py's spheres, oriented box, triangle and planes, then
    256 random rays against a soup of 300 triangles in chunks of 64 (the
    JAX scan's order), and ``combine``."""
    j, t = _pair([[0.0, 0, 0], [0, 0, 0], [5, 5, 5]],
                 [[1.0, 0, 0], [0, 1, 0], [1, 0, 0]], [[3.0, 0, 0]], [1.0])
    assert_hits(tray.ray_spheres(*t), jray.ray_spheres(*j))
    c = np.cos(np.pi / 4)
    j, t = _pair([[-5.0, 0, 0]], [[1.0, 0, 0]], [[0.0, 0, 0]],
                 [[[c, -c, 0.0], [c, c, 0.0], [0.0, 0.0, 1.0]]],
                 [[1.0, 1.0, 1.0]])
    assert_hits(tray.ray_boxes(*t), jray.ray_boxes(*j))
    j, t = _pair([[-2.0, 0, 0], [-2, 0, 5]], [[1.0, 0, 0], [1, 0, 0]],
                 [[0.0, -1, -1]], [[0.0, 1, -1]], [[0.0, 0, 1.5]])
    assert_hits(tray.ray_triangles(*t), jray.ray_triangles(*j))
    j, t = _pair([[-2.0, 0, 0], [-2, 0, 5]], [[1.0, 0, 0], [1, 0, 0]],
                 [[3.0, 0, 0]], [[1.0, 0, 0]])
    assert_hits(tray.ray_planes(*t), jray.ray_planes(*j))

    rng = np.random.default_rng(4)
    R, T = 256, 300
    o = rng.uniform(-2, 2, (R, 3))
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c0 = rng.uniform(-1.5, 1.5, (T, 3))
    tri = [c0 + rng.normal(size=(T, 3)) * 0.3 for _ in range(3)]
    j, t = _pair(o, d, *tri)
    ref = jray.ray_triangles(*j, chunk=64)
    got = tray.ray_triangles(*t, chunk=64)
    assert_hits(got, ref)
    assert np.isfinite(np.asarray(ref[0])).sum() > R // 4
    centers = rng.uniform(-2, 2, (5, 3))
    js, ts = _pair(o, d, centers, rng.uniform(0.2, 0.5, 5))
    jp, tp = _pair(o, d, [[0, 0, -3.0]], [[0, 0, 1.0]])
    assert_hits(tray.combine(got, tray.ray_spheres(*ts), tray.ray_planes(*tp)),
                jray.combine(ref, jray.ray_spheres(*js), jray.ray_planes(*jp)))


# ------------------------------------------------------ box decomposition

def test_decomposition():
    """tests/test_decomp.py's box and L meshes: the port's copy of the
    numpy decomposition gives the JAX package's voxels and parts exactly,
    and the parts become BOX ``ConvexShapes`` on their body."""
    from test_decomp import _box_mesh, _l_mesh

    v, f = _box_mesh((0, 0, 0), (1.0, 0.5, 0.25))
    occ_t, lo_t = tdecomp.voxelize(v, f, pitch=0.05)
    occ_j, lo_j = jdecomp.voxelize(v, f, pitch=0.05)
    np.testing.assert_array_equal(occ_t, occ_j)
    np.testing.assert_array_equal(lo_t, lo_j)
    v, f = _l_mesh()
    parts_t = tdecomp.decompose_boxes(v, f, pitch=0.05, max_parts=16)
    parts_j = jdecomp.decompose_boxes(v, f, pitch=0.05, max_parts=16)
    assert len(parts_t) == len(parts_j) >= 2
    for (ct, ht), (cj, hj) in zip(parts_t, parts_j):
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(ht, hj)
    cv = tdecomp.decomposition_shapes(parts_t, body=3, mu=0.4, device="cpu")
    assert cv.n == len(parts_t)
    assert (cv.kind == tm.BOX).all() and (cv.body == 3).all()
    np.testing.assert_allclose(cv.data.numpy(),
                               np.asarray([h for _, h in parts_t]),
                               rtol=1e-7)
