"""PyTorch port (chrono_tpu_torch) vs the JAX package: the vehicle on CRM
terrain (config #5) and the pieces under it.

The rigid-body BCE pieces of ``fsi/bce.py``, ``fsi/active.py``, the rigid
markers of the terrain state, the suspension templates of
``vehicle/suspension.py``, the demo's vehicle (demos/demo_vehicle_crm.py:42)
and the coupled step on the single-wheel mini bed of
tests/test_crm_terrain.py:171-205 (4,636 markers, 140 on the wheel), each
held to the JAX package on the same inputs.  The JAX references run jitted
on its gather backend, computed once a module; the interpret-mode TPU
kernels are not run.  On the CPU the port's kernels run their plain twins.
The persistent advance is held to the port's own per-outer step, as
tests/test_crm_terrain.py holds the JAX one.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu.fsi import active as j_active
from chrono_tpu.fsi import bce as j_bce
from chrono_tpu.fsi import crm_terrain as j_ct
from chrono_tpu.fsi.sph.crm import CRMParams as JCRMParams
from chrono_tpu.fsi.sph.state import SPHParams as JSPHParams
from chrono_tpu.physics import system as jsys
from chrono_tpu.physics.builder import SystemBuilder as JBuilder
from chrono_tpu.vehicle import suspension as j_susp

import chip_smoke
from chrono_tpu_torch import convert
from chrono_tpu_torch.fsi import active as t_active
from chrono_tpu_torch.fsi import bce as t_bce
from chrono_tpu_torch.fsi import crm_terrain as t_ct
from chrono_tpu_torch.fsi.sph.state import RIGID_BCE
from chrono_tpu_torch.fsi.sph.system import make_sph_state
from chrono_tpu_torch.physics import system as tsys
from chrono_tpu_torch.physics.builder import SystemBuilder as TBuilder
from chrono_tpu_torch.vehicle import suspension as t_susp

N_SUB, N_OUTER = 2, 4
# the terrain after a few outer steps, as tests/test_torch_crm.py holds 3
# cycles against the gather backend: x atol 1e-6 m, v 1e-3·max|v|, ρ
# 0.05 kg/m³, σ 1e-3·max|σ| (rtol 1e-6, 1e-4, 2e-5, 1e-4)
# the bodies at tests/test_crm_terrain.py:234-239 (x rtol 1e-5 / atol
# 1e-6, v rtol 1e-4 / atol 1e-5)
BODY_X_TOL = dict(rtol=1e-5, atol=1e-6)
BODY_V_TOL = dict(rtol=1e-4, atol=1e-5)
MBS_X_ATOL = 2e-4           # tests/test_mbs.py:246, chip_smoke phase 11
O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def threads():
    """The twins' chunks run on 4 threads; the multibody step's tiny
    LAPACK calls would pay for a larger pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _leaves(obj, skip=()):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name not in skip}


def model_leaves(obj):
    """A JAX pytree dataclass as the numpy leaves ``convert`` reads."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: model_leaves(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [model_leaves(v) for v in obj]
    if dataclasses.is_dataclass(obj):
        return {f.name: model_leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def assert_same_leaves(got, ref, path="model"):
    """Leaf by leaf: integers to the bit, floats within 1e-7."""
    if dataclasses.is_dataclass(ref):
        assert type(got) is type(ref), path
        for f in dataclasses.fields(ref):
            assert_same_leaves(getattr(got, f.name), getattr(ref, f.name),
                               f"{path}.{f.name}")
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            assert_same_leaves(got[k], ref[k], f"{path}[{k}]")
    elif isinstance(ref, torch.Tensor):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        if ref.dtype.is_floating_point:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-7, err_msg=path)
        else:
            np.testing.assert_array_equal(got.numpy(), ref.numpy(),
                                          err_msg=path)
    else:
        assert got == ref, path


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ BCE pieces


@pytest.mark.parametrize("shape", ["sphere", "box", "cylinder", "wheel"])
def test_marker_builders_match_jax(shape):
    """The rigid-body marker shells, bit for bit."""
    args = {"sphere": ("sphere_body_markers", (0.11, 0.02)),
            "box": ("box_body_markers", ((0.1, 0.07, 0.05), 0.02)),
            "cylinder": ("cylinder_body_markers", (0.08, 0.12, 0.02))}
    if shape == "wheel":
        ref = j_ct.wheel_bce_markers(0.16, 0.12, 0.05)
        got = t_ct.wheel_bce_markers(0.16, 0.12, 0.05)
    else:
        name, a = args[shape]
        ref, got = getattr(j_bce, name)(*a), getattr(t_bce, name)(*a)
    assert len(ref) > 50
    np.testing.assert_array_equal(got, ref)


def _seeded_markers(seed=5, n=3000, n_bodies=5):
    rng = np.random.default_rng(seed)
    kind = rng.choice([0, 1, 2], n, p=[0.5, 0.2, 0.3]).astype(np.int32)
    body = np.where(kind == 2, rng.integers(0, n_bodies, n), -1
                    ).astype(np.int32)
    q = rng.normal(size=(n_bodies, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    f32 = np.float32
    return dict(
        pos=rng.uniform(-1, 1, (n, 3)).astype(f32),
        vel=rng.normal(size=(n, 3)).astype(f32), kind=kind, body_id=body,
        bce_local=rng.uniform(-0.2, 0.2, (n, 3)).astype(f32),
        body_x=rng.uniform(-1, 1, (n_bodies, 3)).astype(f32),
        body_q=q.astype(f32), body_v=rng.normal(size=(n_bodies, 3))
        .astype(f32), body_w=rng.normal(size=(n_bodies, 3)).astype(f32),
        dv=rng.normal(0, 5, (n, 3)).astype(f32))


def test_update_rigid_markers_matches_jax():
    """Seeded markers of three kinds on five bodies: the rigid ones move to
    x_b + R ξ with v_b + ω × R ξ as JAX moves them (float32 rounding:
    2e-6 of the largest value), the others keep theirs bit for bit."""
    m = _seeded_markers()
    keys = ("pos", "vel", "kind", "body_id", "bce_local", "body_x",
            "body_q", "body_v", "body_w")
    ref = j_bce.update_rigid_markers(*(jnp.asarray(m[k]) for k in keys))
    got = t_bce.update_rigid_markers(*(torch.from_numpy(m[k])
                                       for k in keys))
    rigid = m["kind"] == RIGID_BCE
    for g, r, orig in zip(got, ref, (m["pos"], m["vel"])):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=2e-6 * np.abs(r).max())
        np.testing.assert_array_equal(g.numpy()[~rigid], orig[~rigid])
        assert np.abs(r[rigid] - orig[rigid]).max() > 0.1


def test_rigid_body_forces_matches_jax():
    """The reduction of a seeded reaction to five bodies: JAX scatters
    with ``.at[b].add``, the port sums each body's markers in marker order
    (a stable sort by body); equal within float32 summation rounding
    (rtol 1e-5, atol 1e-5 of the largest)."""
    m = _seeded_markers()
    params = JSPHParams(d0=jnp.asarray(0.02), h=jnp.asarray(0.024),
                        rho0=jnp.asarray(1700.0), mu=jnp.asarray(0.0),
                        c_s=jnp.asarray(40.0),
                        gravity=jnp.asarray([0.0, 0.0, -9.81]),
                        dt=jnp.asarray(1e-4))
    tp = convert.sph_params_from_numpy(_leaves(params))
    ref = j_bce.rigid_body_forces(
        params, jnp.asarray(m["dv"]), jnp.asarray(m["kind"]),
        jnp.asarray(m["body_id"]), jnp.asarray(m["pos"]),
        jnp.asarray(m["body_x"]), 5)
    got = t_bce.rigid_body_forces(
        tp, torch.from_numpy(m["dv"]), torch.from_numpy(m["kind"]),
        torch.from_numpy(m["body_id"]), torch.from_numpy(m["pos"]),
        torch.from_numpy(m["body_x"]), 5)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == (5, 3)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


# ----------------------------------------------------- the mini wheel bed


def _jax_wheel_params():
    """tests/test_crm_terrain.py:23-35."""
    d0 = 0.03
    params = JSPHParams(
        d0=jnp.asarray(d0), h=jnp.asarray(1.2 * d0),
        rho0=jnp.asarray(1700.0), mu=jnp.asarray(0.0),
        c_s=jnp.asarray(40.0), gravity=jnp.asarray([0.0, 0.0, -9.81]),
        dt=jnp.asarray(1e-4), alpha_visc=jnp.asarray(0.1),
        kernel="cubic", max_neighbors=96, max_per_cell=64, rebuild_every=4)
    crm = JCRMParams(youngs=jnp.asarray(2e6), poisson=jnp.asarray(0.3),
                     friction_angle=jnp.asarray(0.7),
                     cohesion=jnp.asarray(0.0))
    return params, crm


@functools.cache
def _jax_wheel_scene():
    """tests/test_crm_terrain.py:171-205 on the JAX package."""
    params, crm = _jax_wheel_params()
    d0 = float(params.d0)
    bed, depth, r_wheel, w_wheel, sink0 = (0.45, 0.24), 0.12, 0.08, 0.09, \
        0.02
    local = j_ct.wheel_bce_markers(r_wheel, w_wheel, d0)
    x0 = np.array([0.18, bed[1] / 2, depth + r_wheel + 0.5 * d0 - sink0])

    def carve(pts):
        dxz = pts[:, [0, 2]] - x0[[0, 2]]
        in_r = np.linalg.norm(dxz, axis=1) < (r_wheel + d0)
        in_y = np.abs(pts[:, 1] - x0[1]) < (w_wheel / 2 + d0)
        return ~(in_r & in_y)

    bld = JBuilder()
    bld.set_gravity((0, 0, -9.81))
    wheel = bld.add_body(mass=10.0, inertia=(0.05, 0.08, 0.05), pos=x0)
    model, bodies = bld.finalize()
    terrain, grid = j_ct.make_crm_terrain_state(
        params, crm, bed, depth, rigid_pts=local + x0,
        rigid_body_ids=[wheel] * len(local), rigid_local=local,
        carve_fn=carve)

    def drive(t, b):
        tau = jnp.zeros((model.n_bodies, 3)).at[wheel, 1].set(3.0)
        return jnp.zeros((model.n_bodies, 3)), tau

    state = j_ct.CRMFSIState(bodies=bodies, terrain=terrain,
                             time=jnp.zeros(()))
    return params, crm, grid, model, state, wheel, drive


def _port_wheel_scene():
    return chip_smoke.crm_wheel_scene("cpu")


def _to_port(state):
    """A JAX CRMFSIState as the port's, on the CPU."""
    return convert.crm_fsi_state_from_numpy(
        {"bodies": _leaves(state.bodies),
         "terrain": _leaves(state.terrain, ("nbr",)),
         "time": np.asarray(state.time)}, device="cpu")


def test_terrain_with_a_carved_wheel_matches_jax():
    """The mini bed with its wheel: the same markers in the same order
    (fluid, walls, then the wheel's), kinds, bodies and local offsets bit
    for bit, the stress as test_terrain_state_matches_jax holds it, the
    same grid; and the converter carries the JAX state across unchanged."""
    _, _, grid, _, state, wheel, _ = _jax_wheel_scene()
    sc = _port_wheel_scene()
    got, ref = sc["state"].terrain, state.terrain
    for f in ("pos", "vel", "rho", "kind", "body_id", "bce_local", "tau_o"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(got.tau_d.numpy(), np.asarray(ref.tau_d),
                               rtol=1e-6, atol=1e-3)
    rigid = got.kind == RIGID_BCE
    assert int(rigid.sum()) == sc["n_rigid"] == 140
    assert bool((got.body_id[rigid] == wheel).all())
    assert bool(rigid[-sc["n_rigid"]:].all())
    assert sc["grid"].dims == tuple(grid.dims)
    conv = _to_port(state)
    for f in ("pos", "kind", "body_id", "bce_local", "tau_d"):
        np.testing.assert_array_equal(getattr(conv.terrain, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    assert torch.equal(conv.bodies.x, sc["state"].bodies.x)


def test_active_domain_functions_match_jax():
    """``activity_masks``, ``compact_indices`` (with the buffer one marker
    short: an overflow of 1), ``gather_state``, ``scatter_state`` and
    ``relocate_patch_x`` on the mini bed with two anchors, bit for bit."""
    _, _, _, _, state, _, _ = _jax_wheel_scene()
    params = _jax_wheel_params()[0]
    crm = _jax_wheel_params()[1]
    terrain = state.terrain
    port = _to_port(state).terrain
    anchors = np.array([[0.18, 0.12, 0.2], [0.33, 0.05, 0.1]], np.float32)
    leaves = {"box": np.array([0.08, 0.06, 0.3], np.float32),
              "margin": np.array([0.05, 0.05, 0.05], np.float32),
              "capacity": 0}
    jspec = j_active.ActiveDomainSpec(box=jnp.asarray(leaves["box"]),
                                      margin=jnp.asarray(leaves["margin"]),
                                      capacity=0)
    tspec = convert.active_spec_from_numpy(leaves, device="cpu")
    j_strict, j_ext = j_active.activity_masks(jspec, terrain.pos,
                                              terrain.kind,
                                              jnp.asarray(anchors))
    t_strict, t_ext = t_active.activity_masks(tspec, port.pos, port.kind,
                                              torch.from_numpy(anchors))
    np.testing.assert_array_equal(t_strict.numpy(), np.asarray(j_strict))
    np.testing.assert_array_equal(t_ext.numpy(), np.asarray(j_ext))
    count = int(np.asarray(j_ext).sum())
    assert 112 < count < terrain.n // 2
    cap = count - 1
    jspec = dataclasses.replace(jspec, capacity=cap)
    tspec = dataclasses.replace(tspec, capacity=cap)
    j_idx, j_count, j_ovf = j_active.compact_indices(jspec, j_ext)
    t_idx, t_count, t_ovf = t_active.compact_indices(tspec, t_ext)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert int(t_count) == int(j_count) == count
    assert int(t_ovf) == int(j_ovf) == 1
    j_sub = j_active.gather_state(terrain, j_idx, j_strict)
    t_sub = t_active.gather_state(port, t_idx, t_strict)
    assert int((t_sub.kind == 4).sum()) > 0           # FROZEN neighbours
    for f in ("pos", "vel", "rho", "kind", "body_id", "bce_local", "tau_d",
              "tau_o"):
        np.testing.assert_array_equal(getattr(t_sub, f).numpy(),
                                      np.asarray(getattr(j_sub, f)), f)
    rng = np.random.default_rng(8)
    moved = rng.normal(size=(cap, 3)).astype(np.float32)
    j_sub = j_sub.replace(vel=jnp.asarray(moved), time=jnp.float32(0.5))
    t_sub = t_sub.replace(vel=torch.from_numpy(moved),
                          time=torch.tensor(0.5))
    j_full = j_active.scatter_state(terrain, j_sub, j_idx)
    t_full = t_active.scatter_state(port, t_sub, t_idx)
    for f in ("pos", "vel", "kind", "tau_d", "time"):
        np.testing.assert_array_equal(getattr(t_full, f).numpy(),
                                      np.asarray(getattr(j_full, f)), f)
    tp = convert.sph_params_from_numpy(_leaves(params))
    tc = convert.crm_params_from_numpy(_leaves(crm))
    j_rel, j_n = j_active.relocate_patch_x(terrain, jnp.asarray(0.5), 0.2,
                                           0.12, params, crm)
    t_rel, t_n = t_active.relocate_patch_x(port, torch.tensor(0.5), 0.2,
                                           0.12, tp, tc)
    assert int(t_n) == int(j_n) > 100
    for f in ("pos", "vel", "rho", "tau_d", "tau_o"):
        np.testing.assert_array_equal(getattr(t_rel, f).numpy(),
                                      np.asarray(getattr(j_rel, f)), f)


# --------------------------------------------------------- the suspension


def _spec():
    """A generic corner: a trailing arm on a chassis revolute, a TSDA,
    an RSDA and a steered spindle with its tie rod."""
    return {"bodies": {"arm": {"mass": 12.0, "inertia": [0.2, 0.2, 0.3],
                               "pos": [0.2, -0.2, 0.3]}},
            "joints": [{"kind": "revolute", "body1": "arm",
                        "body2": "chassis", "pos": [0.45, -0.4, 0.3],
                        "axis": [0.2, 1.0, 0.0]}],
            "distances": [{"body1": "arm", "body2": "chassis",
                           "point1": [0.0, -0.1, 0.5],
                           "point2": [0.0, -0.5, 0.55]}],
            "tsdas": [{"body1": "chassis", "body2": "arm",
                       "point1": [0.0, -0.15, 0.8],
                       "point2": [0.0, -0.15, 0.35], "k": 1e5, "c": 5e3}],
            "rsdas": [{"body1": "arm", "body2": "chassis",
                       "axis": [0, 1, 0], "k": 50.0, "c": 2.0}],
            "spindle": {"attachment": "arm", "pos": [0.0, 0.0, 0.35],
                        "mass": 40.0, "inertia": [1.5, 2.5, 1.5],
                        "steered": True,
                        "tierod": {"arm": [0.2, -0.1, 0.35],
                                   "rack": [0.25, -0.4, 0.35]}}}


TEMPLATES = {
    "double_wishbone": lambda m, b, c: m.add_double_wishbone_corner(
        b, c, (1.0, 0.5, 0.0), m.WishboneHardpoints(), side=+1),
    "double_wishbone_right_steered": lambda m, b, c:
        m.add_double_wishbone_corner(b, c, (1.0, -0.5, 0.0),
                                     m.WishboneHardpoints(), side=-1,
                                     steered_rack_body=c),
    "macpherson": lambda m, b, c: m.add_macpherson_corner(
        b, c, (1.0, 0.5, 0.0), m.WishboneHardpoints()),
    "solid_axle": lambda m, b, c: m.add_solid_axle(
        b, c, (-1.0, 0.0, 0.0), m.SolidAxleHardpoints()),
    "semi_trailing_arm": lambda m, b, c: m.add_semi_trailing_arm_corner(
        b, c, (-1.0, 0.6, 0.0), side=-1),
    "five_link": lambda m, b, c: m.add_five_link_corner(b, c,
                                                        (1.0, 0.5, 0.0)),
    "single_wishbone": lambda m, b, c: m.add_single_wishbone_corner(
        b, c, (1.0, 0.5, 0.0)),
    "double_wishbone_reduced": lambda m, b, c:
        m.add_double_wishbone_reduced_corner(b, c, (1.0, 0.5, 0.0)),
    "leafspring": lambda m, b, c: m.add_leafspring_axle(b, c, (0, 0, 0)),
    "leafspring_toebar": lambda m, b, c: m.add_leafspring_axle(
        b, c, (0, 0, 0), toebar=True),
    "sae_leafspring": lambda m, b, c: m.add_sae_leafspring_axle(
        b, c, (0, 0, 0)),
    "dedion_toebar": lambda m, b, c: m.add_dedion_axle(b, c, (0, 0, 0),
                                                       toebar=True),
    "pushpipe": lambda m, b, c: m.add_pushpipe_axle(b, c, (0, 0, 0)),
    "rigid_panhard_toebar": lambda m, b, c: m.add_rigid_panhard_axle(
        b, c, (0, 0, 0), toebar=True),
    "rigid_pinned": lambda m, b, c: m.add_rigid_pinned_axle(b, c,
                                                            (0, 0, 0)),
    "rigid": lambda m, b, c: m.add_rigid_suspension(b, c, (0, 0, 0)),
    "three_link_bellcrank": lambda m, b, c: m.add_solid_three_link_axle(
        b, c, (0, 0, 0), bellcrank=True),
    "three_link_irs": lambda m, b, c: m.add_three_link_irs_corner(
        b, c, (-1.0, 0.6, 0.0)),
    "hendrickson": lambda m, b, c: m.add_hendrickson_primaxx(b, c,
                                                             (0, 0, 0)),
    "generic_json": lambda m, b, c: m.add_generic_corner(
        b, c, (1.0, 0.5, 0.0), m.load_generic_suspension_json(
            _spec_file()), side=-1),
}


@functools.cache
def _spec_file():
    import json
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(_spec(), f)
        return f.name


def _build_template(name, module, builder):
    bld = builder()
    bld.set_gravity((0, 0, -9.81))
    chassis = bld.add_body(mass=500.0, inertia=(100.0, 300.0, 350.0),
                           pos=(0.0, 0.0, 0.6))
    out = TEMPLATES[name](module, bld, chassis)
    return out, bld.finalize()


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_suspension_template_matches_jax(name):
    """Each template built by both packages' builders: the port's model
    equals the JAX model carried across by ``convert.mbs_model_from_numpy``
    (integers to the bit, floats within 1e-7), and both return the same
    body indices."""
    j_out, (jm, js) = _build_template(name, j_susp, JBuilder)
    t_out, (tm, ts) = _build_template(
        name, t_susp, lambda: TBuilder(device="cpu"))
    assert repr(t_out) == repr(j_out)
    model = convert.mbs_model_from_numpy(model_leaves(jm), device="cpu")
    state = convert.body_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in "xqvw"}, device="cpu")
    assert_same_leaves(tm, model)
    assert_same_leaves(ts, state, "state")
    assert tm.n_bodies >= 2


def test_wheel_camber_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for side in (+1, -1):
        ref = np.asarray(j_susp.wheel_camber(jnp.asarray(q), side))
        got = t_susp.wheel_camber(torch.from_numpy(q), side).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- the demo vehicle


@functools.cache
def _demo_vehicles():
    """demos/demo_vehicle_crm.py:42 ``build_vehicle`` on the JAX builder,
    and its port ``chip_smoke.crm_vehicle`` on the port's, at the demo's
    start pose."""
    from demos.demo_vehicle_crm import build_vehicle

    pos0 = (0.6, 0.6, 0.15 + 0.16 + 0.025 - 0.02 + 0.15)
    out = []
    for build, bld in ((build_vehicle, JBuilder()),
                       (chip_smoke.crm_vehicle, TBuilder(device="cpu"))):
        bld.set_gravity((0, 0, -9.81))
        chassis, corners = build(bld, pos0)
        out.append((chassis, corners) + bld.finalize())
    return out


def test_demo_vehicle_steps_match_jax():
    """The demo's 17-body vehicle: the port's build equals the converted
    JAX model, and 100 steps of ``step_euler_implicit_linearized`` (h =
    4e-4, the coupled step's outer step, the direct solver) with the
    drive's 14 N·m on every wheel and no terrain, the vehicle falling
    under gravity, keep x within 2e-4 of the JAX steps (phase 11's
    bound)."""
    (jc, jcorners, jm, js), (tc, tcorners, tm, ts) = _demo_vehicles()
    assert jc == tc and repr(jcorners) == repr(tcorners)
    assert tm.n_bodies == 17
    assert_same_leaves(
        tm, convert.mbs_model_from_numpy(model_leaves(jm), device="cpu"))
    wheels = [c.wheel for c in tcorners.values()]
    h = 4e-4
    tau = np.zeros((17, 3), np.float32)
    tau[wheels, 1] = 14.0
    settings = jsys.SolverSettings(solver="direct")
    jstep = jax.jit(lambda s, t: jsys.step_euler_implicit_linearized(
        jm, s, t, h, settings, tau_ext=jnp.asarray(tau))[0],
        compiler_options=O0)
    tsettings = tsys.SolverSettings(solver="direct")
    tt = torch.from_numpy(tau)
    t = 0.0
    for _ in range(100):
        js = jstep(js, jnp.float32(t))
        ts = tsys.step_euler_implicit_linearized(
            tm, ts, torch.tensor(t), h, tsettings, tau_ext=tt)[0]
        t += h
    err = np.abs(ts.x.numpy() - np.asarray(js.x)).max()
    assert err <= MBS_X_ATOL, err
    assert float(ts.w[wheels, 1].min()) > 1.0     # the drive spins them
    assert float(ts.x[tc, 2]) < float(_demo_vehicles()[1][3].x[tc, 2])


def test_vehicle_float32_floor():
    """What phase 13's ``VEHICLE_V_TOL`` and ``VEHICLE_W_TOL`` stand on:
    the demo's vehicle falling freely through the port's step (h = 4e-4,
    the direct solver) in float32 against float64 moves ω by ~5e-4 rad/s
    and v by ~4e-5 m/s within 10–40 steps (the true ω is 0), so the
    tolerances sit ten times and more above the float32 step's own floor,
    and the North star's atol (1e-4) is below it for ω."""
    states = {}
    for dtype in (torch.float32, torch.float64):
        bld = TBuilder(device="cpu", dtype=dtype)
        bld.set_gravity((0, 0, -9.81))
        chip_smoke.crm_vehicle(bld, (0.6, 0.6, 0.455))
        model, st = bld.finalize()
        settings = tsys.SolverSettings(solver="direct")
        for k in range(40):
            st = tsys.step_euler_implicit_linearized(
                model, st, torch.tensor(0.0, dtype=dtype), 4e-4,
                settings)[0]
            if k + 1 in (10, 40):
                states[dtype, k + 1] = st
    for n in (10, 40):
        a, b = states[torch.float32, n], states[torch.float64, n]
        dw = float((a.w.double() - b.w).abs().max())
        dv = float((a.v.double() - b.v).abs().max())
        assert float(b.w.abs().max()) < 1e-9          # falls without turning
        assert 1e-4 < dw < chip_smoke.VEHICLE_W_TOL["atol"] / 5, (n, dw)
        assert dv < chip_smoke.VEHICLE_V_TOL["atol"] / 10, (n, dv)


# ------------------------------------------------------ the coupled step


@functools.cache
def _jax_fsi_step():
    params, crm, grid, model, _, wheel, drive = _jax_wheel_scene()
    return jax.jit(lambda s: j_ct.crm_fsi_step(
        model, params, crm, grid, s, N_SUB, [wheel], f_ext_fn=drive)[:2])


@functools.cache
def _jax_four_outer():
    state = _jax_wheel_scene()[4]
    step = _jax_fsi_step()
    for _ in range(N_OUTER):
        state, ovf = step(state)
        assert int(ovf) == 0
    return state


@functools.cache
def _port_four_outer():
    sc = _port_wheel_scene()
    return chip_smoke.fsi_per_outer(sc, torch.device("cpu"), N_OUTER, N_SUB)


def _terrain_close(got, ref):
    v_scale = float(np.abs(np.asarray(ref.vel)).max())
    s_scale = float(np.abs(np.asarray(ref.tau_d)).max())
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(ref.vel),
                               rtol=1e-4, atol=1e-3 * v_scale)
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho),
                               rtol=2e-5, atol=0.05)
    for f in ("tau_d", "tau_o"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-4, atol=1e-3 * s_scale)
    return v_scale


def _bodies_close(got, ref, x_tol=BODY_X_TOL, v_tol=BODY_V_TOL):
    for f, tol in (("x", x_tol), ("q", x_tol), ("v", v_tol), ("w", v_tol)):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(ref, f)), err_msg=f, **tol)


def test_crm_fsi_step_matches_jax_gather():
    """4 outer steps of 2 substeps on the mini bed: the port's
    ``crm_fsi_step`` on the pencil engine (the twins) against JAX's on its
    gather backend.  The terrain is held as test_three_cycles_match_gather_
    backend holds 3 cycles (the gather list has no skin), the wheel at
    tests/test_crm_terrain.py:234-239's tolerances; the wheel is pushed
    (its speed above the velocity atol) and the time advanced alike."""
    ref, got = _jax_four_outer(), _port_four_outer()
    v_scale = _terrain_close(got.terrain, ref.terrain)
    assert v_scale > 0.1
    _bodies_close(got.bodies, ref.bodies)
    assert float(np.abs(np.asarray(ref.bodies.v)).max()) > 1e-3
    assert float(got.time) == pytest.approx(float(ref.time), rel=1e-6)


def test_active_domain_advance_matches_jax():
    """The per-outer advance over an active box around the wheel (the
    buffer large enough), 4 outer steps: the port's pencil engine against
    JAX's gather engine at the same tolerances, and the markers outside
    the extended box untouched in both."""
    params, crm, grid, model, state, wheel, drive = _jax_wheel_scene()
    box, margin = np.array([0.12, 0.2, 0.3]), np.array([0.08, 0.08, 0.08])
    ext = np.all(np.abs(np.asarray(state.terrain.pos) - np.asarray(
        state.bodies.x[wheel])) <= box + margin, axis=1) | (
        np.asarray(state.terrain.kind) == RIGID_BCE)
    cap = int(ext.sum()) + 64
    jspec = j_active.ActiveDomainSpec(box=jnp.asarray(box, jnp.float32),
                                      margin=jnp.asarray(margin,
                                                         jnp.float32),
                                      capacity=cap)
    ref, ovf = j_ct.make_crm_fsi_advance_fn(
        model, params, crm, grid, N_SUB, [wheel], active=jspec,
        f_ext_fn=drive)(state, N_OUTER)
    assert int(ovf) == 0
    sc = _port_wheel_scene()
    tspec = convert.active_spec_from_numpy(
        {"box": box, "margin": margin, "capacity": cap}, device="cpu")
    adv = t_ct.make_crm_fsi_advance_fn(
        sc["model"], sc["params"], sc["soil"], sc["grid"], N_SUB,
        sc["wheels"], active=tspec, f_ext_fn=sc["drive"], engine="pencil",
        pencil_capacity=32, device="cpu")
    got, t_ovf = adv(sc["state"], N_OUTER)
    assert int(t_ovf) == 0
    _terrain_close(got.terrain, ref.terrain)
    _bodies_close(got.bodies, ref.bodies)
    far = torch.from_numpy(~ext)
    assert int(far.sum()) > 1000
    assert torch.equal(got.terrain.pos[far], sc["state"].terrain.pos[far])
    assert torch.equal(got.terrain.vel[far], sc["state"].terrain.vel[far])


@functools.cache
def _persistent_run(rebuild_outer, dv_mode, whole_outer):
    """(state after 4 outer steps, the scene, whose drive recorded the
    bodies of the last outer step)."""
    sc = _port_wheel_scene()
    got, ovf = chip_smoke.fsi_persistent(
        sc, torch.device("cpu"), rebuild_outer, dv_mode, whole_outer,
        N_SUB)(sc["state"], N_OUTER)
    assert int(ovf) == 0
    return got, sc


def _persistent(rebuild_outer, dv_mode, whole_outer):
    return _persistent_run(rebuild_outer, dv_mode, whole_outer)[0]


def test_persistent_at_rebuild_1_matches_the_per_outer_step():
    """tests/test_crm_terrain.py:234-242 for the port: the persistent
    advance at ``rebuild_outer`` 1, dv "fresh", against the per-outer
    step: bodies x rtol 1e-5 / atol 1e-6, v rtol 1e-4 / atol 1e-5, the
    terrain's x rtol 1e-6 / atol 1e-7."""
    ref, got = _port_four_outer(), _persistent(1, "fresh", False)
    _bodies_close(got.bodies, ref.bodies)
    np.testing.assert_allclose(got.terrain.pos.numpy(),
                               ref.terrain.pos.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_persistent_at_rebuild_3_stays_on_the_trajectory():
    """tests/test_crm_terrain.py:252-253: at ``rebuild_outer`` 3 with dv
    "last" (the remainder chunk of 1 included) the bodies stay within
    |Δx| < 2e-3 of the per-outer step, and the terrain is finite."""
    ref, got = _port_four_outer(), _persistent(3, "last", False)
    dx = (got.bodies.x - ref.bodies.x).abs().max()
    assert float(dx) < 2e-3
    assert bool(torch.isfinite(got.terrain.pos).all())


def test_crm_outer_twin_matches_the_per_sweep_twins():
    """``whole_outer`` (the ``crm_outer`` twin, dv "last") against the
    per-sweep twins in dv "last", rebuild 3: on the CPU both are the same
    sweeps in the same order, so bit for bit."""
    a, b = _persistent(3, "last", True), _persistent(3, "last", False)
    for f in "xqvw":
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f))
    for f in ("pos", "vel", "rho", "tau_d", "tau_o"):
        assert torch.equal(getattr(a.terrain, f), getattr(b.terrain, f))


def test_rigid_markers_follow_their_bodies():
    """After the persistent advance (``whole_outer``, rebuild 3, so the
    last chunk is the remainder of 1) the wheel's markers sit at
    x_b + R ξ of the bodies its last outer step moved them to (the drive
    records them), to float32 rounding; walls unmoved bit for bit, every
    granular stress inside the cone, finite (``chip_smoke.vehicle_check``,
    phase 13's check)."""
    got, sc = _persistent_run(3, "last", True)
    rigid_err, on_cone, _ = chip_smoke.vehicle_check(sc, got, "cpu")
    assert rigid_err <= 4 * np.finfo(np.float32).eps * 0.3
    assert on_cone > 0.0
    moved = got.terrain.pos[got.terrain.kind == RIGID_BCE] \
        - sc["state"].terrain.pos[sc["state"].terrain.kind == RIGID_BCE]
    assert float(moved.abs().max()) > 1e-6      # the wheel has turned


# ------------------------------------------------------------ refusals


def test_refusals():
    """Flexible markers name ROADMAP item 8; an unknown dv_mode or engine
    is an error.  The gather engine (the JAX default, and a step without
    substeps) runs: tests/test_torch_crm_gather.py holds it to JAX."""
    sc = _port_wheel_scene()
    args = (sc["model"], sc["params"], sc["soil"], sc["grid"])
    t_ct.make_crm_fsi_advance_fn(*args, N_SUB, sc["wheels"], device="cpu")
    with pytest.raises(ValueError):
        t_ct.make_crm_fsi_advance_fn(*args, N_SUB, sc["wheels"],
                                     engine="flat", device="cpu")
    with pytest.raises(ValueError, match="dv_mode"):
        t_ct.make_crm_fsi_advance_persistent(*args, N_SUB, sc["wheels"],
                                             dv_mode="stale", device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        make_sph_state(sc["params"], np.zeros((4, 3)),
                       flex_pts=np.ones((2, 3)), device="cpu")
