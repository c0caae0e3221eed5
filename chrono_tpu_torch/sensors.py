"""Dynamic sensors (IMU, GPS, tachometer) with noise models, and ray-cast
sensors (lidar, depth camera).

Counterpart of ``chrono_tpu/sensors.py`` (the reference's non-render
sensor stack: accelerometer, gyroscope, magnetometer, GPS and tachometer
with normal and drifting noise; and the geometric half of its lidar and
depth camera, without the shading pipeline).  Each reading is a function
of the body state and a noise draw; noise takes an explicit
``torch.Generator`` on the tensors' device where the JAX package takes a
key, so a seeded run repeats.

Conventions: readings are in the SENSOR frame (body-local, offset by a
mount pose); the accelerometer measures proper acceleration (kinematic −
gravity).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.collision import ray as _ray
from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.core.functions import linspace
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.tree import static_field, tensor_dataclass


def _t(v, device) -> Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


@tensor_dataclass
class NoiseModel:
    """Gaussian noise + random-walk drift (reference ChNoiseNormalDrift)."""

    sigma: Tensor = 0.0        # white noise std
    drift_sigma: Tensor = 0.0  # per-update random-walk increment std


def _apply_noise(generator, noise: NoiseModel, value: Tensor, drift: Tensor):
    white = noise.sigma * torch.randn(value.shape, generator=generator,
                                      dtype=value.dtype, device=value.device)
    drift = drift + noise.drift_sigma * torch.randn(
        value.shape, generator=generator, dtype=value.dtype,
        device=value.device)
    return value + white + drift, drift


@tensor_dataclass
class IMUSensor:
    """Accelerometer + gyroscope + magnetometer on a body at a mount
    offset."""

    body: int = static_field(default=0)
    mount_pos: Tensor = None           # (3,) body-local lever arm
    accel_noise: NoiseModel = None
    gyro_noise: NoiseModel = None
    gravity: Tensor = None             # world gravity (for proper accel)
    mag_field: Tensor = None           # world magnetic field vector


class IMUReading(NamedTuple):
    accel: Tensor       # (3,) sensor-frame proper acceleration
    gyro: Tensor        # (3,) sensor-frame angular velocity
    mag: Tensor         # (3,) sensor-frame magnetic field
    accel_drift: Tensor
    gyro_drift: Tensor


def make_imu(body, mount_pos=(0, 0, 0), accel_sigma=0.0, gyro_sigma=0.0,
             accel_drift=0.0, gyro_drift=0.0, gravity=(0, 0, -9.81),
             mag_field=(0.2, 0.0, -0.4), *, device=None) -> IMUSensor:
    """An IMU on ``body``, its tensors on ``device`` (the card unless told
    otherwise)."""
    device = resolve_device(device, "make_imu")
    return IMUSensor(
        body=body, mount_pos=_t(mount_pos, device),
        accel_noise=NoiseModel(sigma=_t(accel_sigma, device),
                               drift_sigma=_t(accel_drift, device)),
        gyro_noise=NoiseModel(sigma=_t(gyro_sigma, device),
                              drift_sigma=_t(gyro_drift, device)),
        gravity=_t(gravity, device), mag_field=_t(mag_field, device))


def imu_read(imu: IMUSensor, state, state_prev, h, generator,
             drifts=(None, None)) -> IMUReading:
    """One IMU sample from consecutive body states (acceleration by
    differencing the mount-point velocity, as the reference's keyframed
    accelerometer does).  ``generator`` draws the noise: the accelerometer's
    white and drift terms, then the gyroscope's."""
    b = imu.body
    q = state.q[b]

    def mount_vel(st):
        w_world = Q.qrotate(st.q[b], st.w[b])
        return st.v[b] + torch.linalg.cross(
            w_world, Q.qrotate(st.q[b], imu.mount_pos), dim=-1)

    a_world = (mount_vel(state) - mount_vel(state_prev)) / h
    a_proper = Q.qrotate_inv(q, a_world - imu.gravity)
    gyro = state.w[b]                       # already body-local
    mag = Q.qrotate_inv(q, imu.mag_field)

    zeros = torch.zeros(3, dtype=q.dtype, device=q.device)
    d_a = zeros if drifts[0] is None else drifts[0]
    d_g = zeros if drifts[1] is None else drifts[1]
    accel, d_a = _apply_noise(generator, imu.accel_noise, a_proper, d_a)
    gyro, d_g = _apply_noise(generator, imu.gyro_noise, gyro, d_g)
    return IMUReading(accel=accel, gyro=gyro, mag=mag, accel_drift=d_a,
                      gyro_drift=d_g)


@tensor_dataclass
class GPSSensor:
    """Cartesian → geodetic GPS (reference ChGPSSensor + Cartesian2GPS)."""

    body: int = static_field(default=0)
    ref_lat: Tensor = 43.07        # deg (the reference's default: Madison)
    ref_lon: Tensor = -89.4
    ref_alt: Tensor = 260.0
    noise: NoiseModel = None


class GPSReading(NamedTuple):
    lat: Tensor
    lon: Tensor
    alt: Tensor
    drift: Tensor


_EARTH_R = 6371000.0


def make_gps(body, ref=(43.07, -89.4, 260.0), sigma=0.0, drift=0.0, *,
             device=None) -> GPSSensor:
    """A GPS on ``body``, its tensors on ``device`` (the card unless told
    otherwise)."""
    device = resolve_device(device, "make_gps")
    return GPSSensor(body=body, ref_lat=_t(ref[0], device),
                     ref_lon=_t(ref[1], device), ref_alt=_t(ref[2], device),
                     noise=NoiseModel(sigma=_t(sigma, device),
                                      drift_sigma=_t(drift, device)))


def gps_read(gps: GPSSensor, state, generator, drift=None) -> GPSReading:
    pos = state.x[gps.body]
    d0 = torch.zeros_like(pos) if drift is None else drift
    pos_n, d0 = _apply_noise(generator, gps.noise, pos, d0)
    deg = 180.0 / np.pi
    lat = gps.ref_lat + deg * pos_n[1] / _EARTH_R
    lon = gps.ref_lon + deg * pos_n[0] / (
        _EARTH_R * torch.cos(gps.ref_lat * np.pi / 180.0))
    alt = gps.ref_alt + pos_n[2]
    return GPSReading(lat=lat, lon=lon, alt=alt, drift=d0)


def tachometer_read(state, body: int, axis: int = 2) -> Tensor:
    """Shaft or wheel speed about a body-local axis [rad/s] (reference
    ChTachometerSensor)."""
    return state.w[body, axis]


# ---------------------------------------------------------------------------
# ray-cast sensors (lidar / depth camera): batched ray fans against
# analytic shapes and triangle soups (collision.ray)
# ---------------------------------------------------------------------------


@tensor_dataclass
class RayScene:
    """A static scene for ray sensors (None = family absent)."""

    tri_v0: Tensor = None     # (T, 3)
    tri_v1: Tensor = None
    tri_v2: Tensor = None
    sph_c: Tensor = None      # (S, 3)
    sph_r: Tensor = None
    box_c: Tensor = None      # (B, 3)
    box_R: Tensor = None      # (B, 3, 3)
    box_h: Tensor = None
    pln_p: Tensor = None      # (P, 3)
    pln_n: Tensor = None


def ray_scene_cast(scene: RayScene, origins, dirs):
    """(t, n) against every populated family of the scene."""
    hits = []
    if scene.tri_v0 is not None:
        hits.append(_ray.ray_triangles(origins, dirs, scene.tri_v0,
                                       scene.tri_v1, scene.tri_v2))
    if scene.sph_c is not None:
        hits.append(_ray.ray_spheres(origins, dirs, scene.sph_c,
                                     scene.sph_r))
    if scene.box_c is not None:
        hits.append(_ray.ray_boxes(origins, dirs, scene.box_c, scene.box_R,
                                   scene.box_h))
    if scene.pln_p is not None:
        hits.append(_ray.ray_planes(origins, dirs, scene.pln_p,
                                    scene.pln_n))
    if not hits:
        raise ValueError("empty RayScene")
    return _ray.combine(*hits) if len(hits) > 1 else hits[0]


def _cast(scene, pose_x, pose_q, d_loc, max_range, shape):
    d_world = Q.qrotate(pose_q[None, :], d_loc)
    o = pose_x.expand(d_world.shape)
    t, _ = ray_scene_cast(scene, o, d_world)
    return torch.clamp_max(t, max_range).reshape(shape)


def lidar_scan(scene: RayScene, pose_x, pose_q, *, n_horizontal=360,
               n_vertical=16, fov_vertical=(-0.26, 0.26), max_range=100.0):
    """Spinning-lidar range image (n_vertical, n_horizontal) [m] from a
    body pose (the reference's lidar parameters: hfov 2π, channels,
    vfov)."""
    dev = pose_x.device
    az = linspace(-np.pi, np.pi, n_horizontal, endpoint=False, device=dev)
    el = linspace(fov_vertical[0], fov_vertical[1], n_vertical, device=dev)
    E, A = torch.meshgrid(el, az, indexing="ij")
    d_loc = torch.stack([torch.cos(E) * torch.cos(A),
                         torch.cos(E) * torch.sin(A), torch.sin(E)],
                        dim=-1).reshape(-1, 3)
    return _cast(scene, pose_x, pose_q, d_loc, max_range,
                 (n_vertical, n_horizontal))


def depth_image(scene: RayScene, pose_x, pose_q, *, width=64, height=48,
                hfov=1.2, max_range=100.0):
    """Pinhole depth camera (height, width) [m along the ray].  The camera
    looks along body +x, image x → body −y, image y → body −z (the
    reference's camera convention)."""
    dev = pose_x.device
    f = 0.5 * width / torch.tan(torch.tensor(0.5 * hfov, dtype=torch.float32,
                                             device=dev))
    xs = (torch.arange(width, device=dev) - (width - 1) / 2.0) / f
    ys = (torch.arange(height, device=dev) - (height - 1) / 2.0) / f
    V, U = torch.meshgrid(ys, xs, indexing="ij")
    d_loc = torch.stack([torch.ones_like(U), -U, -V], dim=-1).reshape(-1, 3)
    d_loc = d_loc / torch.linalg.norm(d_loc, dim=-1, keepdim=True)
    return _cast(scene, pose_x, pose_q, d_loc, max_range, (height, width))
