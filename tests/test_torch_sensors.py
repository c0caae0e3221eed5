"""PyTorch port (chrono_tpu_torch) vs the JAX package: the dynamic and ray
sensors and the signal filters.

- IMU (accelerometer, gyroscope, magnetometer at a lever arm), GPS and
  tachometer read noise-free from seeded random body states: rtol 1e-5 /
  atol 1e-6; the sensor carriers against ``convert``'s copies of the JAX
  ones;
- noisy reads from a seeded ``torch.Generator``: the white noise's mean
  and σ within 4 σ/√n, the drift a random walk of the stated step, the
  same reads again from the same seed;
- ``lidar_scan`` and ``depth_image`` on a small scene of each family
  (triangles, spheres, boxes, planes) and on all four together: ranges
  rtol 1e-5 / atol 1e-5;
- ``Biquad`` (Butterworth low- and high-pass) against JAX's
  ``Biquad.filter``, ``running_average`` and ``PID`` on a seeded signal:
  rtol 1e-5 / atol 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu import sensors as JS
from chrono_tpu.core import quaternion as JQ
from chrono_tpu.physics.body import BodyState as JState
from chrono_tpu.utils import filters as JF

from chrono_tpu_torch import convert
from chrono_tpu_torch import sensors as TS
from chrono_tpu_torch.physics.body import BodyState as TState
from chrono_tpu_torch.utils import filters as TF

from test_torch_mbs import assert_same_leaves, leaves

O0 = {"xla_backend_optimization_level": 0}
TOL = dict(rtol=1e-5, atol=1e-6)
RANGE_TOL = dict(rtol=1e-5, atol=1e-5)
H = 1e-3


def close(got, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **(tol or TOL))


def random_states(seed, n=3):
    """Two consecutive states of ``n`` bodies (the second a small step on
    from the first), in both packages."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    dv = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    dw = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    prev = dict(x=x, q=q, v=v, w=w)
    cur = dict(x=x + H * v, q=q, v=v + dv, w=w + dw)
    j = [JState(**{k: jnp.asarray(a) for k, a in s.items()})
         for s in (prev, cur)]
    t = [TState(**{k: torch.tensor(a) for k, a in s.items()})
         for s in (prev, cur)]
    return j, t


IMU_KW = dict(mount_pos=(0.1, -0.05, 0.2), gravity=(0, 0, -9.81),
              mag_field=(0.2, 0.0, -0.4))


@pytest.mark.parametrize("body", [0, 2])
def test_imu_gps_tachometer_noise_free(body):
    (jp, jc), (tp, tc) = random_states(body)
    jimu = JS.make_imu(body, **IMU_KW)
    timu = TS.make_imu(body, **IMU_KW, device="cpu")
    assert_same_leaves(timu, convert.imu_from_numpy(leaves(jimu),
                                                    device="cpu"))
    assert_same_leaves(timu.accel_noise, convert.noise_model_from_numpy(
        leaves(jimu.accel_noise), device="cpu"))
    ref = JS.imu_read(jimu, jc, jp, H, jax.random.PRNGKey(0))
    got = TS.imu_read(timu, tc, tp, H, torch.Generator().manual_seed(0))
    for f in ("accel", "gyro", "mag", "accel_drift", "gyro_drift"):
        close(getattr(got, f), getattr(ref, f))
    jgps = JS.make_gps(body, ref=(45.0, 7.5, 120.0))
    tgps = TS.make_gps(body, ref=(45.0, 7.5, 120.0), device="cpu")
    assert_same_leaves(tgps, convert.gps_from_numpy(leaves(jgps),
                                                    device="cpu"))
    rg = JS.gps_read(jgps, jc, jax.random.PRNGKey(1))
    tg = TS.gps_read(tgps, tc, torch.Generator().manual_seed(1))
    for f in ("lat", "lon", "alt", "drift"):
        close(getattr(tg, f), getattr(rg, f))
    for axis in range(3):
        close(TS.tachometer_read(tc, body, axis),
              JS.tachometer_read(jc, body, axis))


def test_noise_moments_and_drift():
    """Seeded white noise of σ = 0.3 and 0.02 and GPS noise of 2 m: mean
    and σ within 4 σ/√n over 2,000 reads; a drift of step 0.01 after k
    reads spreads as 0.01·√k; the same seed gives the same reads."""
    (_, _), (tp, tc) = random_states(5)
    imu = TS.make_imu(1, accel_sigma=0.3, gyro_sigma=0.02, device="cpu")
    clean = TS.imu_read(TS.make_imu(1, device="cpu"), tc, tp, H,
                        torch.Generator())
    gen = torch.Generator().manual_seed(3)
    n = 2000
    reads = [TS.imu_read(imu, tc, tp, H, gen) for _ in range(n)]
    for f, s in (("accel", 0.3), ("gyro", 0.02)):
        e = (torch.stack([getattr(r, f) for r in reads])
             - getattr(clean, f)).double()
        bar = 4 * s / np.sqrt(e.numel())
        assert abs(float(e.mean())) <= bar, f
        assert abs(float(e.std()) - s) <= bar, f
    again = TS.imu_read(imu, tc, tp, H, torch.Generator().manual_seed(3))
    assert torch.equal(again.accel, reads[0].accel)
    gps = TS.make_gps(1, sigma=2.0, device="cpu")
    g = [TS.gps_read(gps, tc, gen).alt for _ in range(n)]
    alt = torch.stack(g).double() - float(TS.gps_read(
        TS.make_gps(1, device="cpu"), tc, gen).alt)
    assert abs(float(alt.mean())) <= 4 * 2.0 / np.sqrt(n)
    assert abs(float(alt.std()) - 2.0) <= 4 * 2.0 / np.sqrt(n)
    walk = TS.make_imu(1, gyro_drift=0.01, device="cpu")
    k, ends = 16, []
    for _ in range(200):
        drift = None
        for _ in range(k):
            r = TS.imu_read(walk, tc, tp, H, gen, drifts=(None, drift))
            drift = r.gyro_drift
        ends.append(drift)
    spread = float(torch.stack(ends).double().std())
    # σ of a σ estimate from 600 samples: σ/√1200
    assert abs(spread - 0.01 * np.sqrt(k)) <= 4 * 0.01 * np.sqrt(k) / np.sqrt(
        1200)


# ------------------------------------------------------------- ray sensors

def scene_arrays(seed, families):
    """A small scene of the given families, numpy float32."""
    rng = np.random.default_rng(seed)
    out = {}
    if "tri" in families:
        n = 6
        xs = np.linspace(-4, 4, n + 1)
        X, Y = np.meshgrid(xs, xs, indexing="ij")
        V = np.stack([X, Y, 0.3 * rng.normal(size=X.shape) - 0.5],
                     -1).reshape(-1, 3)
        k = (np.arange(n)[:, None] * (n + 1) + np.arange(n)).reshape(-1)
        tri = np.concatenate([np.stack([k, k + n + 1, k + 1], 1),
                              np.stack([k + 1, k + n + 1, k + n + 2], 1)])
        out.update(tri_v0=V[tri[:, 0]], tri_v1=V[tri[:, 1]],
                   tri_v2=V[tri[:, 2]])
    if "sph" in families:
        out.update(sph_c=rng.uniform(-3, 3, (4, 3)),
                   sph_r=rng.uniform(0.3, 0.8, 4))
    if "box" in families:
        q = rng.normal(size=(3, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        out.update(box_c=rng.uniform(-3, 3, (3, 3)),
                   box_R=np.asarray(JQ.q_to_matrix(jnp.asarray(
                       q, jnp.float32))),
                   box_h=rng.uniform(0.2, 0.7, (3, 3)))
    if "pln" in families:
        out.update(pln_p=np.asarray([[0.0, 0.0, -1.5], [6.0, 0.0, 0.0]]),
                   pln_n=np.asarray([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0]]))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


FAMILIES = ["tri", "sph", "box", "pln", "tri+sph+box+pln"]


@pytest.mark.parametrize("families", FAMILIES)
def test_lidar_and_depth(families):
    arrays = scene_arrays(len(families), families.split("+"))
    jscene = JS.RayScene(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tscene = TS.RayScene(**{k: torch.tensor(v) for k, v in arrays.items()})
    assert_same_leaves(tscene, convert.ray_scene_from_numpy(
        leaves(jscene), device="cpu"))
    px = np.asarray([0.2, -0.3, 0.4], np.float32)
    pq = np.asarray(JQ.q_from_axis_angle(jnp.asarray([0.3, 0.2, 1.0]) /
                                         np.sqrt(1.13), jnp.asarray(0.7)))
    hits = {}
    for name, kw in (("lidar_scan", dict(n_horizontal=90, n_vertical=8)),
                     ("depth_image", dict(width=24, height=16))):
        ref = jax.jit(lambda sc, x, q: getattr(JS, name)(sc, x, q, **kw),
                      compiler_options=O0)(jscene, jnp.asarray(px),
                                           jnp.asarray(pq))
        got = getattr(TS, name)(tscene, torch.tensor(px), torch.tensor(pq),
                                **kw)
        assert got.shape == ref.shape
        close(got, ref, **RANGE_TOL)
        hits[name] = float((got < 100.0).float().mean())
    assert hits["lidar_scan"] > 0.02          # the full turn sees the scene


def test_empty_scene_refused():
    with pytest.raises(ValueError, match="empty RayScene"):
        TS.lidar_scan(TS.RayScene(), torch.zeros(3),
                      torch.tensor([1.0, 0, 0, 0]))


# ----------------------------------------------------------------- filters

def signal(n=400, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 200.0
    return (np.sin(2 * np.pi * 3 * t) + 0.3 * rng.normal(size=n)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["lowpass", "highpass"])
def test_butterworth_biquad(kind):
    xs = signal()
    jf = getattr(JF, f"butterworth_{kind}")(10.0, 200.0)
    tf = getattr(TF, f"butterworth_{kind}")(10.0, 200.0, device="cpu")
    close(tf.b, jf.b)
    close(tf.a, jf.a)
    close(tf.filter(torch.tensor(xs)), jf.filter(jnp.asarray(xs)))
    y, tf2 = tf.step(torch.tensor(xs[0]))
    yj, jf2 = jf.step(jnp.asarray(xs[0]))
    close(y, yj)
    close(tf2.s, jf2.s)


@pytest.mark.parametrize("window", [1, 5, 16])
def test_running_average(window):
    xs = signal()
    close(TF.running_average(torch.tensor(xs), window),
          JF.running_average(jnp.asarray(xs), window))


def test_pid():
    xs = signal(100)
    kw = dict(kp=2.0, ki=0.5, kd=0.01)
    jp = JF.PID(**{k: jnp.float32(v) for k, v in kw.items()})
    tp = TF.PID(**{k: torch.tensor(v) for k, v in kw.items()})
    for e in xs:
        yj, jp = jp.step(jnp.float32(e), 5e-3)
        yt, tp = tp.step(torch.tensor(e), 5e-3)
        close(yt, yj)
    close(tp.integral, jp.integral)
