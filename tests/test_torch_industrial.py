"""PyTorch port (chrono_tpu_torch) vs the JAX package: the industrial arms.

- ``fk_6r`` and ``ik_6r`` batched over seeded random joint vectors, both
  elbow branches, a gimbal-locked wrist and an offset, turned base;
  ``fk_scara`` / ``ik_scara``: rtol 1e-5 / atol 1e-6;
- ``ik_newton`` from perturbed starts: the same ``converged`` and the same
  iteration count (the smallest ``max_iter`` that converges), the same
  joint vector;
- ``make_trajectory`` / ``traj_eval`` at the knots, between them and past
  both ends, and ``joint_programs_from_trajectory`` (the demo's 49 IK
  samples, unwrapped);
- ``create_arm_6dof`` against the JAX builder field for field (integer
  leaves to the bit, floats within 1e-7), and the converters of the arm,
  SCARA and trajectory carriers;
- 100 running steps of the demo's arm after its 200 settling steps
  (direct solver, h = 2 ms): each JAX state stepped once by the port at
  ``test_torch_mbs.py``'s ``STEP_TOL`` (the port's model built from the
  JAX joint programs carried across), and the port's own run (its own
  programs) within x atol 2e-4 of the JAX run.

Both sides run in float32 on the CPU; the JAX step and Newton loop are
jitted once each (XLA's backend optimisations off).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu.core import quaternion as JQ
from chrono_tpu.models import industrial as J
from chrono_tpu.physics import system as jsys

from chrono_tpu_torch import convert
from chrono_tpu_torch.models import industrial as T
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics import system as tsys

import chip_smoke
from test_torch_mbs import STEP_TOL, assert_same_leaves, leaves

O0 = {"xla_backend_optimization_level": 0}
KIN_TOL = dict(rtol=1e-5, atol=1e-6)
X_ATOL_RUN = 2e-4
ARM = dict(H=0.4, L1=0.6, L2=0.5, L3=0.15)
N_STEPS = 100


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arms(**kw):
    return J.Arm6R.make(**ARM, **kw), T.Arm6R.make(**ARM, **kw,
                                                   device="cpu")


def close(got, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **(tol or KIN_TOL))


def random_q(rng, n, elbow=(0.3, 2.4)):
    """Joint samples away from singularities (tests/test_industrial.py)."""
    return np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-1.2, 1.2, n),
                     rng.uniform(*elbow, n), rng.uniform(-np.pi, np.pi, n),
                     rng.uniform(0.15, np.pi - 0.15, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


def test_fk_6r_batched():
    ja, ta = arms()
    q = random_q(np.random.default_rng(0), 64)
    jp, jr = J.fk_6r(ja, jnp.asarray(q))
    tp, tr = T.fk_6r(ta, torch.tensor(q))
    close(tp, jp)
    close(tr, jr)


@pytest.mark.parametrize("elbow_up", [True, False])
def test_ik_6r_batched_branches(elbow_up):
    """Both elbow branches on 64 reachable targets (batched over the
    leading axis); the port's joint vector reaches the target pose."""
    ja, ta = arms()
    q = random_q(np.random.default_rng(1), 64)
    jp, jr = J.fk_6r(ja, jnp.asarray(q))
    ref = J.ik_6r(ja, jp, jr, elbow_up=elbow_up)
    got = T.ik_6r(ta, torch.tensor(np.asarray(jp)),
                  torch.tensor(np.asarray(jr)), elbow_up=elbow_up)
    close(got, ref)
    assert bool((got[:, 2] >= 0).all()) == elbow_up
    p2, _ = T.fk_6r(ta, got)
    close(p2, jp, rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", ["gimbal_lock", "offset_base",
                                  "unreachable"])
def test_ik_6r_special_poses(case):
    """th5 = 0 (the gimbal-lock branch), a base moved and turned about z,
    and targets past the workspace (clamped to the straight arm)."""
    kw = {}
    if case == "offset_base":
        kw = dict(base_pos=(1.0, -0.5, 0.2),
                  base_rot=np.asarray(JQ.q_from_axis_angle(
                      jnp.asarray([0.0, 0.0, 1.0]), jnp.asarray(0.9))))
    ja, ta = arms(**kw)
    q = np.asarray([[0.7, 0.4, 1.1, 0.3, 0.0, 0.5],
                    [-1.2, 0.2, 0.6, -0.8, 0.0, 0.1],
                    [0.3, 0.5, 1.0, -0.4, 0.8, 1.2]], np.float32)
    jp, jr = J.fk_6r(ja, jnp.asarray(q))
    if case == "unreachable":
        jp = jp * 3.0
    ref = J.ik_6r(ja, jp, jr)
    got = T.ik_6r(ta, torch.tensor(np.asarray(jp)),
                  torch.tensor(np.asarray(jr)))
    close(got, ref)


def test_scara_fk_ik():
    ja = J.ArmSCARA.make(H=0.5, L1=0.35, L2=0.25, D=0.08)
    for right in (True, False):
        ta = T.ArmSCARA.make(H=0.5, L1=0.35, L2=0.25, D=0.08,
                             right_elbow=right, device="cpu")
        jr = ja.replace(right_elbow=right)
        rng = np.random.default_rng(2)
        u = np.stack([rng.uniform(-2, 2, 16), rng.uniform(0.3, 2.6, 16),
                      rng.uniform(-2, 2, 16), rng.uniform(0.0, 0.2, 16)],
                     1).astype(np.float32)
        jp, jrot = J.fk_scara(jr, jnp.asarray(u))
        tp, trot = T.fk_scara(ta, torch.tensor(u))
        close(tp, jp)
        close(trot, jrot)
        yaw = u[:, 0] + u[:, 1] + u[:, 2]
        close(T.ik_scara(ta, tp, torch.tensor(yaw)),
              J.ik_scara(jr, jp, jnp.asarray(yaw)))


@pytest.fixture(scope="module")
def jax_newton():
    """The JAX ``ik_newton`` on the demo's arm, jitted once with
    ``max_iter`` traced (it enters only the loop's test)."""
    ja, _ = arms()
    return jax.jit(lambda q0, p, r, n: J.ik_newton(
        lambda q: J.fk_6r(ja, q), q0, p, r, tol=1e-4, max_iter=n),
        compiler_options=O0)


def newton_count(run, limit=12):
    """The smallest ``max_iter`` at which ``run(max_iter)`` converges, and
    the joint vector then."""
    for n in range(1, limit + 1):
        q, ok = run(n)
        if bool(ok):
            return n, np.asarray(q)
    return None, np.asarray(q)


@pytest.mark.parametrize("case", range(4))
def test_ik_newton_same_iterations(case, jax_newton):
    """From a start 0.3 rad (σ) off the true joints: both converge at the
    same iteration to the same joint vector; one fewer iteration leaves
    both unconverged."""
    ja, ta = arms()
    rng = np.random.default_rng(10 + case)
    q = random_q(rng, 1)[0]
    jp, jr = J.fk_6r(ja, jnp.asarray(q))
    q0 = (q + rng.normal(0, 0.3, 6)).astype(np.float32)
    tp, tr = torch.tensor(np.asarray(jp)), torch.tensor(np.asarray(jr))
    n_j, q_j = newton_count(lambda n: jax_newton(
        jnp.asarray(q0), jp, jr, jnp.int32(n)))
    n_t, q_t = newton_count(lambda n: T.ik_newton(
        lambda qq: T.fk_6r(ta, qq), torch.tensor(q0), tp, tr, tol=1e-4,
        max_iter=n))
    assert n_j is not None and n_t == n_j
    np.testing.assert_allclose(q_t, q_j, rtol=1e-5, atol=1e-5)
    _, ok = T.ik_newton(lambda qq: T.fk_6r(ta, qq), torch.tensor(q0), tp, tr,
                        tol=1e-4, max_iter=n_t - 1)
    assert not bool(ok)


# --------------------------------------------------------------- trajectory

@pytest.fixture(scope="module")
def trajectories():
    """The demo's trajectory in both packages and its 49-sample joint
    programs: (JAX arm, port arm, JAX trajectory, port trajectory, JAX
    programs, port programs)."""
    ja, ta = arms()
    poses = [J.fk_6r(ja, jnp.asarray(q, jnp.float32))
             for q in chip_smoke.ARM_WAYPOINTS]
    pos = np.stack([np.asarray(p) for p, _ in poses])
    rot = np.stack([np.asarray(r) for _, r in poses])
    jt = J.make_trajectory(jnp.asarray(pos), jnp.asarray(rot),
                           total_time=chip_smoke.ARM_T, law="poly345")
    tt = T.make_trajectory(pos, rot, total_time=chip_smoke.ARM_T,
                           law="poly345", device="cpu")
    return (ja, ta, jt, tt,
            J.joint_programs_from_trajectory(ja, jt, n_samples=49),
            T.joint_programs_from_trajectory(ta, tt, n_samples=49))


@pytest.mark.parametrize("law", ["poly345", "cycloidal", "linear"])
def test_traj_eval_knots_and_between(law, trajectories):
    _, _, jt, tt, _, _ = trajectories
    jt, tt = jt.replace(law=law), tt.replace(law=law)
    assert torch.equal(tt.t_cum, torch.tensor(np.asarray(jt.t_cum)))
    knots = np.asarray(jt.t_cum)
    ts = np.concatenate([knots, np.linspace(-0.2, 1.7, 39),
                         knots[1:] - 1e-4, knots[:-1] + 1e-4, [0.7]]
                        ).astype(np.float32)
    jp, jr = jax.jit(jax.vmap(lambda t: J.traj_eval(jt, t)),
                     compiler_options=O0)(jnp.asarray(ts))
    tp, tr = T.traj_eval(tt, torch.tensor(ts))
    close(tp, jp)
    close(tr, jr)
    for got, ref in zip(T.traj_eval(tt, 0.7), (jp[-1], jr[-1])):
        assert got.shape == ref.shape          # a scalar time
        close(got, ref)


def test_trajectory_and_programs_convert(trajectories):
    """The trajectory's converter, and the demo's 49 IK samples into six
    unwrapped ``FInterp`` programs."""
    ja, ta, jt, tt, jprog, tprog = trajectories
    assert_same_leaves(tt, convert.trajectory_from_numpy(leaves(jt),
                                                         device="cpu"))
    assert_same_leaves(ta, convert.arm6r_from_numpy(leaves(ja),
                                                    device="cpu"))
    js = J.ArmSCARA.make(H=0.5, L1=0.35, L2=0.25, D=0.08, right_elbow=False)
    assert_same_leaves(
        T.ArmSCARA.make(H=0.5, L1=0.35, L2=0.25, D=0.08, right_elbow=False,
                        device="cpu"),
        convert.arm_scara_from_numpy(leaves(js), device="cpu"))
    for a, b in zip(jprog, tprog, strict=True):
        np.testing.assert_array_equal(b.ts.numpy(), np.asarray(a.ts))
        close(b.ys, a.ys)


# ------------------------------------------------------------- dynamic arm

@pytest.fixture(scope="module")
def arm_models(trajectories):
    """The demo's arm in both packages: the JAX build, the port's build
    from the JAX joint programs carried across (the same input, for the
    field-for-field check and the one-step checks), and the port's build
    from its own programs (for the free run)."""
    ja, ta, _, _, jprog, tprog = trajectories
    jm = J.create_arm_6dof(ja, jprog)
    same = T.create_arm_6dof(ta, [convert.motion_function_from_numpy(
        leaves(p), device="cpu") for p in jprog], device="cpu")
    own = T.create_arm_6dof(ta, tprog, device="cpu")
    return jm, same, own


def test_create_arm_6dof_field_for_field(arm_models):
    (jmodel, jstate, jtool, joff), (tmodel, tstate, ttool, toff), _ = \
        arm_models
    assert_same_leaves(tmodel, convert.mbs_model_from_numpy(
        leaves(jmodel), device="cpu"))
    for f in "xqvw":
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)))
    assert ttool == jtool
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))


def test_arm_100_steps(arm_models):
    """The demo's first 100 running steps after its 200 settling steps
    (the JAX package settles; the first settling steps snap the straight
    arm onto the start pose at up to 1,000 rad/s, where float32 rounding
    of the solve alone moves a step's output by 1e-3): each JAX state
    stepped once by the port (``STEP_TOL``), and the port's own run from
    the settled state within x atol 2e-4 of the JAX run."""
    (jmodel, jstate, _, _), (tmodel, _, _, _), (own, _, _, _) = arm_models
    settings = dict(solver="direct")
    h = chip_smoke.ARM_H
    jstep = jax.jit(lambda s, t: jsys.step_euler_implicit_linearized(
        jmodel, s, t, h, jsys.SolverSettings(**settings))[0],
        compiler_options=O0)
    tsettings = tsys.SolverSettings(**settings)
    js = jstate
    for _ in range(chip_smoke.ARM_SETTLE):
        js = jstep(js, jnp.float32(0.0))
    settled = js

    def port(s):
        return BodyState(**{f: torch.tensor(np.asarray(getattr(s, f)))
                            for f in "xqvw"})

    ts = port(settled)
    t = torch.zeros(())
    for k in range(N_STEPS):
        nxt = jstep(js, jnp.float32(k * h))
        one = tsys.step_euler_implicit_linearized(
            tmodel, port(js), torch.tensor(k * h, dtype=torch.float32), h,
            tsettings)[0]
        for f in "xqvw":
            np.testing.assert_allclose(getattr(one, f).numpy(),
                                       np.asarray(getattr(nxt, f)),
                                       err_msg=f"step {k} {f}", **STEP_TOL)
        ts = tsys.step_euler_implicit_linearized(own, ts, t, h,
                                                 tsettings)[0]
        t = t + h
        js = nxt
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=X_ATOL_RUN)
    assert np.abs(np.asarray(js.x) - np.asarray(settled.x)).max() > 1e-3


def test_arm_defaults_to_the_card():
    """Without ``device`` the builders go to the card, and raise here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Arm6R.make(**ARM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.make_trajectory(np.zeros((2, 3)), np.tile([1.0, 0, 0, 0], (2, 1)),
                          total_time=1.0)
