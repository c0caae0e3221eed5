"""The multibody core's pieces in the port against the JAX package.

Quaternions and frames, every ``MotionFunction`` (value, deriv, deriv2),
``joint_rows`` for each of the 17 joint kinds, the four couplers, the four
constraint-motor kinds and the two load motors, the force elements, the
descriptor operators and the compensated arithmetic of the direct solve.
Inputs come from a numpy seed; both sides run in float32 on the CPU.  The
JAX references of each group are traced and compiled once (module-scoped
fixtures, one jitted function each, compiled without XLA's backend
optimisations to keep the compile short).

Tolerances: rtol 1e-5 with atol 1e-6 for values of order one (the two
sides round their float32 sums in other orders), the same for the rows' C
and all five Jacobian blocks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu.core import frame as jframe
from chrono_tpu.core import functions as JF
from chrono_tpu.core import quaternion as JQ
from chrono_tpu.physics import force_elements as jfe
from chrono_tpu.physics import joints as jjoints
from chrono_tpu.physics import motors as jmotors
from chrono_tpu.physics.constraints import ConstraintRows as JRows
from chrono_tpu.solver import descriptor as jdesc
from chrono_tpu.solver import direct as jdirect

from chrono_tpu_torch import convert
from chrono_tpu_torch.core import frame as tframe
from chrono_tpu_torch.core import quaternion as TQ
from chrono_tpu_torch.physics import force_elements as tfe
from chrono_tpu_torch.physics import joints as tjoints
from chrono_tpu_torch.physics import motors as tmotors
from chrono_tpu_torch.physics.body import BodyState as TBodyState
from chrono_tpu_torch.physics.constraints import ConstraintRows as TRows
from chrono_tpu_torch.solver import descriptor as tdesc
from chrono_tpu_torch.solver import direct as tdirect

TOL = dict(rtol=1e-5, atol=1e-6)
N_BODIES, N_JOINTS = 5, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny LAPACK calls cost milliseconds each with a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit_once(fn, *args):
    """``fn`` traced and compiled once for ``args``, then run on them."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def leaves(obj):
    """A JAX pytree dataclass as the numpy leaves ``convert`` reads."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: leaves(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [leaves(v) for v in obj]
    if dataclasses.is_dataclass(obj):
        out = {f.name: leaves(getattr(obj, f.name))
               for f in dataclasses.fields(obj)}
        if isinstance(obj, JF.MotionFunction):
            out["class"] = type(obj).__name__
        return out
    return np.asarray(obj)


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def close(got, ref, what, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), err_msg=what, **tol)


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


# --------------------------------------------------------------- quaternions

def test_quaternion_and_frame_functions():
    rng = np.random.default_rng(0)
    a, b = unit_quats(rng, 8), unit_quats(rng, 8)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    w_small = (1e-7 * rng.normal(size=(8, 3))).astype(np.float32)
    rpy = rng.uniform(-2, 2, size=(8, 3)).astype(np.float32)
    axis = v / np.linalg.norm(v, axis=1, keepdims=True)
    ang = rng.uniform(-3, 3, size=8).astype(np.float32)
    m = np.asarray(JQ.q_to_matrix(jnp.asarray(a)))

    calls = [
        ("qmul", (a, b)), ("qconj", (a,)), ("qnormalize", (3.0 * a,)),
        ("qrotate", (a, v)), ("qrotate_inv", (a, v)),
        ("q_to_matrix", (a,)), ("q_from_matrix", (m,)),
        ("q_from_axis_angle", (axis, ang)), ("q_from_euler_xyz", (rpy,)),
        ("qexp_half", (v,)), ("qexp_half", (w_small,)),
        ("qlog2", (a * np.sign(a[:, :1]),)),
        ("qdot_from_local_omega", (a, v)),
        ("integrate_quat", (a, v, np.float32(1e-3)))]

    def frames(M, Fr):
        f = Fr(pos=v, rot=a)
        g = Fr(pos=2 * v, rot=b)
        return [getattr(f, name)(-v) for name in (
            "transform_point", "transform_dir", "inv_transform_point",
            "inv_transform_dir")] + [f.compose(g).pos, f.inverse().rot,
                                     M.skew(v)]

    def evaluate(a, b, v):
        return ([getattr(JQ, name)(*args) for name, args in calls],
                frames(jframe, jframe.Frame))

    refs, frame_refs = jit_once(evaluate, a, b, v)
    for (name, args), ref in zip(calls, refs):
        close(getattr(TQ, name)(*map(t32, args)), ref, name)
    close(TQ.qidentity((3,)), JQ.qidentity((3,)), "qidentity")
    a, b, v = t32(a), t32(b), t32(v)
    for got, ref in zip(frames(tframe, tframe.Frame), frame_refs):
        close(got, ref, "frame")


# ------------------------------------------------------------ motion functions

def _functions():
    """One JAX instance of every MotionFunction subclass."""
    f32 = jnp.float32
    sine = JF.FSine(amp=f32(0.7), freq=f32(0.9), phase=f32(0.3))
    ramp = JF.FRamp(y0=f32(0.2), slope=f32(-1.3))
    poly = JF.FPoly(coeffs=jnp.asarray([0.5, -1.0, 0.25, 0.125], f32))
    return {
        "FConst": JF.FConst(c=f32(1.5)),
        "FRamp": ramp,
        "FSine": sine,
        "FPoly": poly,
        "FInterp": JF.FInterp(ts=jnp.asarray([0.0, 0.5, 1.2, 2.0, 3.5], f32),
                              ys=jnp.asarray([0.0, 1.0, -0.5, 0.7, 0.2],
                                             f32)),
        "FConstAcc": JF.FConstAcc(end=f32(2.0), duration=f32(3.0), aw1=0.25,
                                  aw2=0.6),
        "FCycloidal": JF.FCycloidal(height=f32(0.8), width=f32(2.5)),
        "FPoly345": JF.FPoly345(height=f32(1.1), width=f32(2.5)),
        "FPoly23": JF.FPoly23(height=f32(-0.6), width=f32(2.5)),
        "FSineStep": JF.FSineStep(t1=f32(0.2), y1=f32(-0.4), t2=f32(2.6),
                                  y2=f32(1.3)),
        "FBSpline": JF.FBSpline(ctrl=jnp.asarray([0.0, 0.4, 1.5, 0.2, -0.3,
                                                  0.8], f32),
                                t0=f32(0.1), dt=f32(0.6)),
        "FMirror": JF.FMirror(inner=sine, t_mirror=f32(1.0)),
        "FDerivative": JF.FDerivative(inner=poly),
        "FIntegral": JF.FIntegral(inner=sine, tmax=f32(3.0), c0=f32(0.1),
                                  samples=64),
        "FRepeat": JF.FRepeat(inner=ramp, width=f32(0.7)),
        "FSequence": JF.FSequence(fns=(sine, ramp),
                                  weights=jnp.asarray([0.5, 2.0], f32)),
    }


# away from every knot, clip edge and mirror point, where a derivative jumps
TIMES = np.asarray([0.03, 0.37, 0.81, 1.37, 1.9, 2.33], np.float32)


@pytest.fixture(scope="module")
def function_refs():
    fns = _functions()

    def evaluate(ts):
        return {name: [jax.vmap(getattr(f, m))(ts)
                       for m in ("value", "deriv", "deriv2")]
                for name, f in fns.items()}

    return fns, jit_once(evaluate, jnp.asarray(TIMES))


@pytest.mark.parametrize("name", sorted(_functions()))
def test_motion_function(name, function_refs):
    fns, refs = function_refs
    port = convert.motion_function_from_numpy(leaves(fns[name]),
                                              device="cpu")
    assert type(port).__name__ == name
    for m, ref in zip(("value", "deriv", "deriv2"), refs[name]):
        got = torch.stack([torch.as_tensor(getattr(port, m)(
            torch.tensor(t))).to(torch.float32) for t in TIMES])
        close(got, ref, f"{name}.{m}")


# ---------------------------------------------------------- rows: the scene

def _scene(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_BODIES, 3)).astype(np.float32)
    q = unit_quats(rng, N_BODIES)
    v = rng.normal(size=(N_BODIES, 3)).astype(np.float32)
    w = rng.normal(size=(N_BODIES, 3)).astype(np.float32)
    pairs = np.asarray([[0, 1], [2, 1], [3, 4]], np.int32)

    def frames():
        return dict(
            body_a=pairs[:, 0], body_b=pairs[:, 1],
            fa_pos=rng.normal(size=(N_JOINTS, 3)).astype(np.float32),
            fa_rot=unit_quats(rng, N_JOINTS),
            fb_pos=rng.normal(size=(N_JOINTS, 3)).astype(np.float32),
            fb_rot=unit_quats(rng, N_JOINTS))

    joint = dict(frames(), aux=rng.uniform(0.5, 1.5, N_JOINTS)
                 .astype(np.float32))
    motor = frames()
    k = rng.uniform(10, 100, N_JOINTS).astype(np.float32)
    tsda = dict(body_a=pairs[:, 0], body_b=pairs[:, 1],
                pa_loc=motor["fa_pos"], pb_loc=motor["fb_pos"], k=k,
                c=k / 10, rest_len=np.float32(1.2) + 0 * k, f_act=k / 7)
    rsda = dict(body_a=pairs[:, 0], body_b=pairs[:, 1],
                fa_rot=motor["fa_rot"], fb_rot=motor["fb_rot"], k=k,
                c=k / 10, rest_angle=np.float32(0.4) + 0 * k, t_act=k / 7)
    bushing = dict(motor, k_t=rng.uniform(1e3, 1e4, (N_JOINTS, 3)),
                   c_t=rng.uniform(10, 100, (N_JOINTS, 3)),
                   k_r=rng.uniform(100, 1e3, (N_JOINTS, 3)),
                   c_r=rng.uniform(1, 10, (N_JOINTS, 3)))
    bushing = {k_: np.asarray(v_, np.float32 if v_.dtype.kind == "f"
                              else np.int32) for k_, v_ in bushing.items()}
    return dict(x=x, q=q, v=v, w=w, joint=joint, motor=motor, tsda=tsda,
                rsda=rsda, bushing=bushing)


F32 = jnp.float32
MOTOR_PROFILES = {  # kind -> one JAX profile per motor (stacked by kind)
    "rot_speed": [JF.FSine(amp=F32(0.5 + i), freq=F32(0.7), phase=F32(0.1))
                  for i in range(N_JOINTS)],
    "rot_angle": [JF.FSineStep(t1=F32(0.0), y1=F32(0.1 * i), t2=F32(2.0),
                               y2=F32(1.0 + i)) for i in range(N_JOINTS)],
    "lin_speed": [JF.FRamp(y0=F32(0.2 * i), slope=F32(0.5))
                  for i in range(N_JOINTS)],
    "lin_pos": [JF.FSineStep(t1=F32(0.1), y1=F32(-0.2), t2=F32(1.5),
                             y2=F32(0.3 * i)) for i in range(N_JOINTS)],
    "rot_torque": [JF.FConst(c=F32(2.0 + i)) for i in range(N_JOINTS)],
    "lin_force": [JF.FRamp(y0=F32(1.0), slope=F32(i)) for i in
                  range(N_JOINTS)],
}
T_MOTOR, H, STAB = 0.77, 1e-2, 0.3


def _jax_motor(sc, kind):
    prof = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                  *MOTOR_PROFILES[kind])
    return jmotors.MotorData(**{k: jnp.asarray(v) for k, v in
                                sc["motor"].items()}, profile=prof)


def _port_motor(sc, kind):
    prof = convert.motion_function_from_numpy(
        leaves(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                      *MOTOR_PROFILES[kind])), device="cpu")
    return tmotors.MotorData(**{k: torch.as_tensor(v) for k, v in
                                sc["motor"].items()}, profile=prof)



@pytest.fixture(scope="module")
def row_refs():
    """Every rows / loads / forces result of the JAX package for the
    seeded scene, from one compiled function."""
    sc = _scene()
    jd = jjoints.JointData(**{k: jnp.asarray(v)
                              for k, v in sc["joint"].items()})
    motors = {kind: _jax_motor(sc, kind) for kind in MOTOR_PROFILES}
    state = dict(x=jnp.asarray(sc["x"]), q=jnp.asarray(sc["q"]),
                 v=jnp.asarray(sc["v"]), w=jnp.asarray(sc["w"]))

    def evaluate(st):
        x, q = st["x"], st["q"]
        out = {f"joint/{kind}": _rows_np_j(jjoints.joint_rows(
            kind, jd, x, q, H, STAB)) for kind in jjoints.JOINT_TYPES}
        out["joint/revolute/deadband"] = _rows_np_j(jjoints.joint_rows(
            "revolute", jd, x, q, H, STAB, deadband=0.05))
        out.update({f"violation/{kind}": jjoints.joint_violation(
            kind, jd, x, q) for kind in ("revolute", "distance")})
        out.update({f"coupler/{kind}": _rows_np_j(jjoints.coupler_rows(
            kind, jd, x, q)) for kind in jjoints.COUPLER_TYPES})
        for kind in ("rot_speed", "rot_angle", "lin_speed", "lin_pos"):
            out[f"motor/{kind}"] = _rows_np_j(jmotors.motor_rows(
                kind, motors[kind], x, q, T_MOTOR, H, STAB))
        out["motor/lin_pos/projection"] = _rows_np_j(jmotors.motor_rows(
            "lin_pos", motors["lin_pos"], x, q, T_MOTOR, 1.0, 1.0,
            vel_scale=0.0))
        for kind in ("rot_torque", "lin_force"):
            out[f"load/{kind}"] = jmotors.motor_loads(
                kind, motors[kind], x, q, T_MOTOR)
        bs = _JState(**st)
        zero = jnp.zeros((N_BODIES, 3), jnp.float32)
        out["tsda"] = jfe.accumulate_tsda(
            jfe.TSDAData(**{k: jnp.asarray(v) for k, v in
                            sc["tsda"].items()}), bs, zero, zero)
        out["rsda"] = jfe.accumulate_rsda(
            jfe.RSDAData(**{k: jnp.asarray(v) for k, v in
                            sc["rsda"].items()}), bs, zero, zero)
        out["bushing"] = jfe.accumulate_bushing(
            jfe.BushingData(**{k: jnp.asarray(v) for k, v in
                               sc["bushing"].items()}), bs, zero, zero)
        out["tsda_length"] = jfe.tsda_length(
            jfe.TSDAData(**{k: jnp.asarray(v) for k, v in
                            sc["tsda"].items()}), bs)
        return out

    return sc, jit_once(evaluate, state)


def _rows_np_j(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


class _JState:
    def __init__(self, x, q, v, w):
        self.x, self.q, self.v, self.w = x, q, v, w


def _port_state(sc):
    return TBodyState(x=t32(sc["x"]), q=t32(sc["q"]), v=t32(sc["v"]),
                      w=t32(sc["w"]))


def _port_joints(sc):
    return tjoints.JointData(**{k: torch.as_tensor(v)
                                for k, v in sc["joint"].items()})


def check_rows(got: TRows, ref: dict, what):
    for f in ("body_a", "body_b", "body_c", "active"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f],
                                      err_msg=f"{what} {f}")
    for f in ("Ja_v", "Ja_w", "Jb_v", "Jb_w", "Jc_w", "rhs"):
        close(getattr(got, f), ref[f], f"{what} {f}")


@pytest.mark.parametrize("kind", sorted(jjoints.JOINT_TYPES))
def test_joint_rows(kind, row_refs):
    sc, refs = row_refs
    st = _port_state(sc)
    check_rows(tjoints.joint_rows(kind, _port_joints(sc), st.x, st.q, H,
                                  STAB), refs[f"joint/{kind}"], kind)


def test_joint_rows_deadband_and_violation(row_refs):
    sc, refs = row_refs
    st, jd = _port_state(sc), _port_joints(sc)
    check_rows(tjoints.joint_rows("revolute", jd, st.x, st.q, H, STAB,
                                  deadband=0.05),
               refs["joint/revolute/deadband"], "revolute, deadband")
    for kind in ("revolute", "distance"):
        close(tjoints.joint_violation(kind, jd, st.x, st.q),
              refs[f"violation/{kind}"], f"violation {kind}")


@pytest.mark.parametrize("kind", sorted(jjoints.COUPLER_TYPES))
def test_coupler_rows(kind, row_refs):
    sc, refs = row_refs
    st = _port_state(sc)
    check_rows(tjoints.coupler_rows(kind, _port_joints(sc), st.x, st.q),
               refs[f"coupler/{kind}"], kind)


@pytest.mark.parametrize("kind", ["rot_speed", "rot_angle", "lin_speed",
                                  "lin_pos"])
def test_motor_rows(kind, row_refs):
    sc, refs = row_refs
    st = _port_state(sc)
    md = _port_motor(sc, kind)
    check_rows(tmotors.motor_rows(kind, md, st.x, st.q,
                                  torch.tensor(T_MOTOR), H, STAB),
               refs[f"motor/{kind}"], kind)
    if kind == "lin_pos":
        check_rows(tmotors.motor_rows(kind, md, st.x, st.q,
                                      torch.tensor(T_MOTOR), 1.0, 1.0,
                                      vel_scale=0.0),
                   refs["motor/lin_pos/projection"], "lin_pos, projection")


@pytest.mark.parametrize("kind", ["rot_torque", "lin_force"])
def test_motor_loads(kind, row_refs):
    sc, refs = row_refs
    st = _port_state(sc)
    got = tmotors.motor_loads(kind, _port_motor(sc, kind), st.x, st.q,
                              torch.tensor(T_MOTOR))
    for g, r in zip(got, refs[f"load/{kind}"]):
        close(g, r, kind)


@pytest.mark.parametrize("kind", ["tsda", "rsda", "bushing"])
def test_force_elements(kind, row_refs):
    sc, refs = row_refs
    st = _port_state(sc)
    cls = {"tsda": tfe.TSDAData, "rsda": tfe.RSDAData,
           "bushing": tfe.BushingData}[kind]
    data = cls(**{k: torch.as_tensor(v) for k, v in sc[kind].items()})
    fn = getattr(tfe, f"accumulate_{kind}")
    zero = torch.zeros((N_BODIES, 3))
    for g, r, what in zip(fn(data, st, zero, zero), refs[kind],
                          ("force", "torque")):
        # forces of order k·m: the tolerance scales with them
        close(g, r, f"{kind} {what}", dict(rtol=1e-5,
                                           atol=1e-6 * np.abs(r).max()))
    if kind == "tsda":
        close(tfe.tsda_length(data, st), refs["tsda_length"], "tsda_length")


# ------------------------------------------------- descriptor and direct

def _random_rows(seed=3, m=11):
    rng = np.random.default_rng(seed)
    r = dict(body_a=rng.integers(0, N_BODIES, m).astype(np.int32),
             body_b=rng.integers(0, N_BODIES, m).astype(np.int32),
             body_c=rng.integers(0, N_BODIES, m).astype(np.int32),
             **{f: rng.normal(size=(m, 3)).astype(np.float32)
                for f in ("Ja_v", "Ja_w", "Jb_v", "Jb_w", "Jc_w")},
             rhs=rng.normal(size=m).astype(np.float32),
             active=rng.uniform(size=m) > 0.2)
    u = rng.normal(size=(2, N_BODIES, 3)).astype(np.float32)
    gamma = rng.normal(size=m).astype(np.float32)
    minv = rng.uniform(0.1, 2.0, size=(N_BODIES, 4)).astype(np.float32)
    return r, u, gamma, minv


def test_descriptor_operators():
    r, u, gamma, minv = _random_rows()
    jr = JRows(**{k: jnp.asarray(v) for k, v in r.items()})
    tr = TRows(**{k: torch.as_tensor(v) for k, v in r.items()})
    from chrono_tpu.physics.body import BodyProps as JProps
    from chrono_tpu_torch.physics.body import BodyProps as TProps
    jp = JProps(inv_mass=jnp.asarray(minv[:, 0]),
                inertia=1.0 / jnp.asarray(minv[:, 1:]),
                inv_inertia=jnp.asarray(minv[:, 1:]))
    tp = TProps(inv_mass=t32(minv[:, 0]), inertia=1.0 / t32(minv[:, 1:]),
                inv_inertia=t32(minv[:, 1:]))

    def evaluate(g, v, w):
        pk = jdesc.pack_rows(jr)
        m8 = jdesc.pack_minv(jp)
        u8 = jdesc.pack_u(v, w)
        return dict(
            Ja=pk.Ja, Jc=pk.Jc, rhs=pk.rhs, minv8=m8, u8=u8,
            D_packed=jdesc.apply_D_packed(pk, u8),
            DT_packed=jdesc.apply_DT_packed(pk, g, N_BODIES),
            schur_rhs=jdesc.schur_rhs_packed(pk, u8),
            vel=jdesc.velocity_update_packed(pk, m8, g, u8),
            DT=jdesc.apply_DT(jr, g, N_BODIES), D=jdesc.apply_D(jr, v, w),
            dense=jdesc.dense_D(jr, N_BODIES),
            comp_rhs=jdirect.compensated_schur_rhs(jr, v, w))

    ref = jit_once(evaluate, jnp.asarray(gamma), jnp.asarray(u[0]),
                   jnp.asarray(u[1]))
    g, v, w = t32(gamma), t32(u[0]), t32(u[1])
    pk = tdesc.pack_rows(tr)
    m8 = tdesc.pack_minv(tp)
    u8 = tdesc.pack_u(v, w)
    got = dict(
        Ja=pk.Ja, Jc=pk.Jc, rhs=pk.rhs, minv8=m8, u8=u8,
        D_packed=tdesc.apply_D_packed(pk, u8),
        DT_packed=tdesc.apply_DT_packed(pk, g, N_BODIES),
        schur_rhs=tdesc.schur_rhs_packed(pk, u8),
        vel=tdesc.velocity_update_packed(pk, m8, g, u8),
        DT=tdesc.apply_DT(tr, g, N_BODIES), D=tdesc.apply_D(tr, v, w),
        dense=tdesc.dense_D(tr, N_BODIES),
        comp_rhs=tdirect.compensated_schur_rhs(tr, v, w))
    for k, rv in ref.items():
        gv = got[k]
        for a, b in (zip(gv, rv) if isinstance(gv, tuple) else [(gv, rv)]):
            close(a, b, k)
    # the dense D's transpose product is the scatter form's Dᵀγ
    imp = tdesc.apply_DT_dense(got["dense"], g)
    f, tau = got["DT"]
    close(imp, torch.cat([f, tau], dim=1).numpy(), "apply_DT_dense")


def test_error_free_arithmetic():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    p, e = tdirect._two_prod(t32(a), t32(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.numpy().astype(np.float64)
                                  + e.numpy().astype(np.float64), exact)
    # cancelling terms: the compensated sums recover what plain float32 loses
    terms = [np.float32(1e8), np.float32(1.0), np.float32(-1e8),
             np.float32(3.0)]
    P = np.asarray([terms * 3], np.float32)
    (jp, je), (js, jc) = jit_once(
        lambda a, b, P: (jdirect._two_prod(a, b),
                         jdirect._comp_sum_axis(P, axis=1)), a, b, P)
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_array_equal(e.numpy(), je)
    s, c = tdirect._comp_sum([torch.tensor(t) for t in terms])
    assert float(s) + float(c) == 4.0
    s, c = tdirect._comp_sum_axis(torch.from_numpy(P), axis=1)
    assert float(s[0]) + float(c[0]) == 12.0
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(c.numpy(), jc)
