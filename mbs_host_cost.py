"""Host cost of the multibody core's eager step, on the CPU.

    python3 mbs_host_cost.py

Builds ``bench_suite.py``'s ``bench_mbs`` (config #1) with the port's
builder on the CPU, with one torch thread, and prints:

- the eager step's time (ms, over 50 steps after a warm-up);
- the top-level ops of one step under ``torch.profiler``, by name;
- the joint lowering's time for the scene's three joint kinds two ways:
  the port's one forward-mode pass on the dual numbers of ``core/dual.py``
  and ``torch.func.vmap(torch.func.jacfwd(...))`` of the same gap
  functions, whose Jacobians must agree.

These are CPU numbers: the host's share of an eager step, not a device
time.  Imports nothing of JAX.
"""

from __future__ import annotations

import time
from collections import Counter

import torch

from chip_smoke import mbs_bench_scene
from chrono_tpu_torch.core.quaternion import qmul
from chrono_tpu_torch.physics.joints import JOINT_TYPES, _params, joint_rows
from chrono_tpu_torch.physics.system import (
    SolverSettings, step_euler_implicit_linearized,
)

H = 1e-3


def per_call_ms(fn, reps):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def jacfwd_rows(kind, data, x, q):
    """The JAX package's lowering, ``vmap`` of ``jacfwd`` over the joints:
    (C (J, n), J (J, n, 12))."""
    gap, _ = JOINT_TYPES[kind]
    e4 = torch.zeros(4)

    def one(xa, qa, xb, qb, p, u0):
        def lifted(u):
            za = torch.cat([e4[:1], u[3:6]])
            zb = torch.cat([e4[:1], u[9:12]])
            return gap(xa + u[0:3], qa + 0.5 * qmul(qa, za),
                       xb + u[6:9], qb + 0.5 * qmul(qb, zb), p)

        return gap(xa, qa, xb, qb, p), torch.func.jacfwd(lifted)(u0)

    a, b = data.body_a, data.body_b
    return torch.func.vmap(one, in_dims=(0, 0, 0, 0, 0, None))(
        x[a], q[a], x[b], q[b], _params(data), torch.zeros(12))


def main():
    torch.set_num_threads(1)
    model, state = mbs_bench_scene("cpu")
    settings = SolverSettings(solver="direct")
    t = torch.tensor(0.0)

    def step():
        return step_euler_implicit_linearized(model, state, t, H, settings)

    print(f"eager step on the CPU (one thread): {per_call_ms(step, 50):.3f} "
          "ms")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    top = [e.name for e in prof.events() if e.cpu_parent is None]
    print(f"one step: {len(top)} top-level ops; "
          + ", ".join(f"{k} {v}" for k, v in Counter(top).most_common(12)))

    dual = jac = 0.0
    for kind, data in model.joints.items():
        rows = joint_rows(kind, data, state.x, state.q, 1.0, 1.0)
        C, J = jacfwd_rows(kind, data, state.x, state.q)
        n = J.shape[1]
        ref = J.reshape(-1, 12)
        got = torch.cat([rows.Ja_v, rows.Ja_w, rows.Jb_v, rows.Jb_w], dim=1)
        err = float((got - ref).abs().max())
        assert err < 1e-6 and float((rows.rhs + C.reshape(-1)).abs().max()) \
            < 1e-7, kind
        dual += per_call_ms(lambda: joint_rows(kind, data, state.x, state.q,
                                               1.0, 1.0), 20)
        jac += per_call_ms(lambda: jacfwd_rows(kind, data, state.x, state.q),
                           5)
        print(f"{kind} ({data.n} joints, {n} rows each): Jacobians agree to "
              f"{err:.1e}")
    print(f"joint lowering of the scene: dual numbers {dual:.3f} ms, "
          f"vmap(jacfwd) {jac:.3f} ms")


if __name__ == "__main__":
    main()
