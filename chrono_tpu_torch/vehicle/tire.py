"""Handling tire models: TMeasy, Fiala, Pacejka 89 and 2002, TMsimple, as
pure batched functions.

Counterpart of ``chrono_tpu/vehicle/tire.py``: slip-based semi-empirical
force models evaluated for every wheel at once, as functions of (wheel
state, terrain query, params) → (force, spin torque, normal load), with no
per-tire objects and no host reads.  The five models share the contact
kinematics (``_contact``) and the assembly of the world force and spin
torque (``_assemble``); each has its own force law.

Conventions: the wheel's spin axis is its local y; the terrain supplies the
height under each wheel centre; forces are returned in the world frame at
the wheel centre, with the rolling-resistance and tire-reaction torque
about the spin axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.utils.tree import fields_as_tensors, tensor_dataclass


@tensor_dataclass
class TMeasyParams:
    """TMeasy coefficient set (degressive force against slip).

    Nominal values at the rated load Fz0; the force curves scale linearly
    with load between 1·Fz0 and 2·Fz0 (the standard TMeasy structure).
    """

    radius: Tensor = 0.35          # unloaded radius [m]
    width: Tensor = 0.25
    Fz0: Tensor = 3000.0           # rated vertical load [N]
    cz: Tensor = 250000.0          # vertical stiffness [N/m]
    dz: Tensor = 3000.0            # vertical damping [N s/m]
    # longitudinal characteristic at Fz0 / 2·Fz0
    dfx0_1: Tensor = 80000.0       # initial slope dFx/dsx
    fxm_1: Tensor = 3500.0         # peak force
    fxs_1: Tensor = 3100.0         # sliding force
    sxm_1: Tensor = 0.12           # slip at peak
    sxs_1: Tensor = 0.7            # slip at full sliding
    dfx0_2: Tensor = 160000.0
    fxm_2: Tensor = 6800.0
    fxs_2: Tensor = 6000.0
    sxm_2: Tensor = 0.14
    sxs_2: Tensor = 0.8
    # lateral characteristic
    dfy0_1: Tensor = 50000.0
    fym_1: Tensor = 3200.0
    fys_1: Tensor = 2800.0
    sym_1: Tensor = 0.25
    sys_1: Tensor = 0.9
    dfy0_2: Tensor = 95000.0
    fym_2: Tensor = 6100.0
    fys_2: Tensor = 5400.0
    sym_2: Tensor = 0.28
    sys_2: Tensor = 1.0
    rolling_resistance: Tensor = 0.015


class _Contact(NamedTuple):
    e_lon: Tensor      # (N, 3) forward = spin × up
    e_lat: Tensor      # (N, 3) up × forward
    up: Tensor         # (3,)
    e_spin: Tensor     # (N, 3)
    pen: Tensor        # (N,) > 0 in contact
    fz: Tensor         # (N,) spring-damper normal load, ≥ 0
    in_contact: Tensor
    v_lon: Tensor
    v_lat: Tensor
    omega: Tensor      # spin rate about local y
    r_eff: Tensor
    v_ref: Tensor      # low-speed regularised |v_lon|


def _contact(p, wheel_x, wheel_q, wheel_v, wheel_w_local,
             terrain_height_fn) -> _Contact:
    """The contact geometry and slip kinematics every model shares."""
    z_terrain = terrain_height_fn(wheel_x[..., :2])
    e_spin = Q.q_to_matrix(wheel_q)[..., :, 1]          # local y = spin
    up = torch.eye(3, dtype=wheel_x.dtype, device=wheel_x.device)[2]
    e_lon = torch.linalg.cross(e_spin, up.expand_as(e_spin), dim=-1)
    e_lon = e_lon / torch.clamp_min(
        torch.linalg.norm(e_lon, dim=-1, keepdim=True), 1e-9)
    e_lat = torch.linalg.cross(up.expand_as(e_lon), e_lon, dim=-1)
    pen = (p.radius + z_terrain) - wheel_x[..., 2]
    fz = torch.clamp_min(p.cz * pen - p.dz * wheel_v[..., 2], 0.0)
    v_lon = torch.sum(wheel_v * e_lon, dim=-1)
    return _Contact(
        e_lon=e_lon, e_lat=e_lat, up=up, e_spin=e_spin, pen=pen, fz=fz,
        in_contact=pen > 0, v_lon=v_lon,
        v_lat=torch.sum(wheel_v * e_lat, dim=-1),
        omega=wheel_w_local[..., 1], r_eff=p.radius - pen / 3.0,
        v_ref=torch.clamp_min(torch.abs(v_lon), 1.0))


def _assemble(p, c: _Contact, fx, fy):
    """World force at the wheel centre, spin torque (tire reaction +
    rolling resistance) and the normal load, all zero off contact."""
    zero = torch.zeros_like(c.fz)
    fx = torch.where(c.in_contact, fx, zero)
    fy = torch.where(c.in_contact, fy, zero)
    fzc = torch.where(c.in_contact, c.fz, zero)
    force = (fx[..., None] * c.e_lon + fy[..., None] * c.e_lat
             + fzc[..., None] * c.up)
    t_spin = -fx * c.r_eff - torch.where(
        c.in_contact,
        p.rolling_resistance * fzc * c.r_eff * torch.tanh(2.0 * c.omega),
        zero)
    return force, t_spin, fzc


def _tmeasy_curve(s, dfx0, fm, fs, sm, ss):
    """TMeasy master curve: a rational rise to the peak, a smooth decay to
    the sliding level (branch-free)."""
    s = torch.abs(s)
    sigma = s / torch.clamp_min(sm, 1e-6)
    denom = 1.0 + sigma * (sigma + dfx0 * sm / torch.clamp_min(fm, 1e-6)
                           - 2.0)
    f_rise = dfx0 * sm * sigma / torch.clamp_min(denom, 1e-6)
    a = torch.clamp((s - sm) / torch.clamp_min(ss - sm, 1e-6), 0.0, 1.0)
    f_fall = fm - (fm - fs) * a * a * (3.0 - 2.0 * a)
    return torch.where(s <= sm, f_rise, f_fall)


def _load_interp(fz, v1, v2, Fz0):
    """TMeasy two-point load scaling (linear between Fz0 and 2 Fz0,
    clamped)."""
    t = torch.clamp(fz / Fz0 - 1.0, -0.75, 1.0)
    return v1 + (v2 - v1) * t


def tmeasy_forces(p: TMeasyParams, wheel_x, wheel_q, wheel_v, wheel_w_local,
                  terrain_height_fn, terrain_mu=1.0, eps=1e-3):
    """Tire forces for N wheels (all tensors batched on the leading axis).

    ``terrain_height_fn``: (N, 2) xy → (N,) height (flat, heightmap or SCM
    query).  Returns ``(force_world (N, 3) at the wheel centre,
    torque_spin (N,) about the wheel's local y axis, fz (N,) normal
    load)``.
    """
    p = fields_as_tensors(p, wheel_x)
    c = _contact(p, wheel_x, wheel_q, wheel_v, wheel_w_local,
                 terrain_height_fn)
    sx = (c.omega * c.r_eff - c.v_lon) / c.v_ref
    sy = -c.v_lat / c.v_ref
    fz = c.fz

    def load(name, mu=1.0):
        return _load_interp(fz, getattr(p, name + "_1"),
                            getattr(p, name + "_2"), p.Fz0) * mu

    dfx0, fxm, fxs = load("dfx0"), load("fxm", terrain_mu), \
        load("fxs", terrain_mu)
    sxm, sxs = load("sxm"), load("sxs")
    dfy0, fym, fys = load("dfy0"), load("fym", terrain_mu), \
        load("fys", terrain_mu)
    sym, sys_ = load("sym"), load("sys")

    # combined slip by the normalised-slip method (TMeasy)
    sxn = sx / torch.clamp_min(sxm, 1e-6)
    syn = sy / torch.clamp_min(sym, 1e-6)
    sc = torch.sqrt(sxn * sxn + syn * syn) + 1e-9
    cphi = sxn / sc
    sphi = syn / sc
    sm_c = torch.sqrt((sxm * cphi) ** 2 + (sym * sphi) ** 2)
    ss_c = torch.sqrt((sxs * cphi) ** 2 + (sys_ * sphi) ** 2)
    fm_c = torch.sqrt((fxm * cphi) ** 2 + (fym * sphi) ** 2)
    fs_c = torch.sqrt((fxs * cphi) ** 2 + (fys * sphi) ** 2)
    df0_c = torch.sqrt((dfx0 * cphi) ** 2 + (dfy0 * sphi) ** 2)
    f_c = _tmeasy_curve(sc * sm_c, df0_c, fm_c, fs_c, sm_c, ss_c)
    # cphi / sphi carry the slip signs
    return _assemble(p, c, f_c * cphi, f_c * sphi)


@tensor_dataclass
class FialaParams:
    """Fiala tire (a brush model; reference ChFialaTire)."""

    radius: Tensor = 0.35
    cz: Tensor = 250000.0
    dz: Tensor = 3000.0
    c_slip: Tensor = 80000.0     # dFx/dsx at sx = 0
    c_alpha: Tensor = 50000.0    # dFy/dα at α = 0
    mu: Tensor = 0.9
    rolling_resistance: Tensor = 0.015


def fiala_forces(p: FialaParams, wheel_x, wheel_q, wheel_v, wheel_w_local,
                 terrain_height_fn):
    """Fiala brush-model forces (no combined-slip coupling, like the
    reference)."""
    p = fields_as_tensors(p, wheel_x)
    c = _contact(p, wheel_x, wheel_q, wheel_v, wheel_w_local,
                 terrain_height_fn)
    fz = c.fz
    sx = (c.omega * c.r_eff - c.v_lon) / c.v_ref
    alpha = torch.atan2(-c.v_lat, c.v_ref)
    # longitudinal: linear, then clamped by friction
    fx = torch.clamp(p.c_slip * sx, -p.mu * fz, p.mu * fz)
    # lateral: cubic brush saturation
    a_crit = torch.atan(3.0 * p.mu * fz / torch.clamp_min(p.c_alpha, 1e-6))
    ta = torch.tan(torch.clamp(torch.clamp_min(torch.abs(alpha), 0.0),
                               max=a_crit))
    xi = 1.0 - p.c_alpha * ta / torch.clamp_min(3.0 * p.mu * fz, 1e-6)
    fy_mag = torch.where(torch.abs(alpha) < a_crit,
                         p.mu * fz * (1.0 - xi ** 3), p.mu * fz)
    return _assemble(p, c, fx, torch.sign(alpha) * fy_mag)


@tensor_dataclass
class Pac89Params:
    """Magic Formula (Pacejka '89) coefficient set: F = D sin(C arctan(B s −
    E(B s − arctan B s))) for the longitudinal (slip ratio κ) and lateral
    (slip angle α) forces, with the peak D = μ Fz (reference ChPac89Tire).
    """

    radius: Tensor = 0.35
    cz: Tensor = 250000.0
    dz: Tensor = 3000.0
    mu: Tensor = 1.0
    Bx: Tensor = 10.0
    Cx: Tensor = 1.65
    Ex: Tensor = 0.6
    By: Tensor = 8.0
    Cy: Tensor = 1.3
    Ey: Tensor = -1.0
    rolling_resistance: Tensor = 0.015


def _magic(s, B, C, D, E):
    Bs = B * s
    return D * torch.sin(C * torch.atan(Bs - E * (Bs - torch.atan(Bs))))


def pac89_forces(p: Pac89Params, wheel_x, wheel_q, wheel_v, wheel_w_local,
                 terrain_height_fn):
    """Magic Formula tire forces (uncombined, like the reference Pac89)."""
    p = fields_as_tensors(p, wheel_x)
    c = _contact(p, wheel_x, wheel_q, wheel_v, wheel_w_local,
                 terrain_height_fn)
    kappa = (c.omega * c.r_eff - c.v_lon) / c.v_ref
    alpha = torch.atan2(-c.v_lat, c.v_ref)
    fx = _magic(kappa, p.Bx, p.Cx, p.mu * c.fz, p.Ex)
    fy = _magic(alpha, p.By, p.Cy, p.mu * c.fz, p.Ey)
    return _assemble(p, c, fx, fy)


@tensor_dataclass
class Pac02Params:
    """Pacejka 2002 Magic Formula subset (reference ChPac02Tire): load
    dependence, camber sensitivity, combined slip through the cosine
    weighting functions Gxα / Gyκ, with the standard MF names."""

    radius: Tensor = 0.35
    cz: Tensor = 250000.0
    dz: Tensor = 3000.0
    Fz0: Tensor = 4000.0        # nominal load
    # longitudinal pure slip
    pCx1: Tensor = 1.65
    pDx1: Tensor = 1.0          # peak μx at Fz0
    pDx2: Tensor = -0.08        # load sensitivity of μx
    pEx1: Tensor = 0.6
    pKx1: Tensor = 20.0         # Kx/Fz at Fz0
    pKx2: Tensor = -0.5
    # lateral pure slip
    pCy1: Tensor = 1.3
    pDy1: Tensor = 0.95
    pDy2: Tensor = -0.1
    pEy1: Tensor = -1.0
    pKy1: Tensor = 15.0         # cornering stiffness factor
    pKy2: Tensor = 1.6          # load at peak stiffness (·Fz0)
    pKy3: Tensor = 0.4          # camber gain
    pHy3: Tensor = 0.02         # camber-induced slip shift
    pVy3: Tensor = -1.0         # camber-induced force shift (·Fz·γ)
    # combined slip weighting
    rBx1: Tensor = 12.0
    rCx1: Tensor = 1.0
    rBy1: Tensor = 10.0
    rCy1: Tensor = 1.0
    # aligning moment (pneumatic trail; the JAX package computes and drops
    # it, and so does this port: it is not applied)
    qDz1: Tensor = 0.12
    qBz1: Tensor = 8.0
    rolling_resistance: Tensor = 0.015


def pac02_forces(p: Pac02Params, wheel_x, wheel_q, wheel_v, wheel_w_local,
                 terrain_height_fn):
    """MF-2002 combined-slip tire forces: ``(force_world, spin_torque,
    fz)`` like the other models."""
    p = fields_as_tensors(p, wheel_x)
    c = _contact(p, wheel_x, wheel_q, wheel_v, wheel_w_local,
                 terrain_height_fn)
    fz = c.fz
    # camber: inclination of the spin axis out of the ground plane
    gamma = torch.asin(torch.clamp(c.e_spin[..., 2], -0.5, 0.5))
    dfz = (fz - p.Fz0) / p.Fz0
    kappa = (c.omega * c.r_eff - c.v_lon) / c.v_ref
    alpha = torch.atan2(-c.v_lat, c.v_ref)

    # longitudinal pure slip
    Dx = (p.pDx1 + p.pDx2 * dfz) * fz
    Kx = fz * (p.pKx1 + p.pKx2 * dfz)
    Bx = Kx / torch.clamp_min(p.pCx1 * Dx, 1e-6)
    fx0 = _magic(kappa, Bx, p.pCx1, Dx, p.pEx1)

    # lateral pure slip with camber
    Dy = (p.pDy1 + p.pDy2 * dfz) * fz
    Ky = p.pKy1 * p.Fz0 * torch.sin(
        2.0 * torch.atan(fz / torch.clamp_min(p.pKy2 * p.Fz0, 1e-6))) \
        * (1.0 - p.pKy3 * torch.abs(gamma))
    By = Ky / torch.clamp_min(p.pCy1 * Dy, 1e-6)
    fy0 = _magic(alpha + p.pHy3 * gamma, By, p.pCy1, Dy, p.pEy1) \
        + fz * p.pVy3 * gamma

    # combined slip (cosine weighting, the MF-Tyre G functions); arctan(0)
    # is 0, so the JAX package's normaliser cos(rCx1·arctan 0) is 1
    Gxa = torch.cos(p.rCx1 * torch.atan(p.rBx1 * alpha)) \
        / torch.clamp_min(torch.cos(p.rCx1 * 0.0), 1e-6)
    Gyk = torch.cos(p.rCy1 * torch.atan(p.rBy1 * kappa))
    return _assemble(p, c, fx0 * Gxa, fy0 * Gyk)


@tensor_dataclass
class TMsimpleParams:
    """TMsimple handling tire (reference ChTMsimpleTire): a two-point
    quadratic load interpolation of (F_max, dF0, F_s) per axis and the law
    F(s) = μ K sin(B (1 − e^{−s/A})), B = π − asin(Fs/Fmax), A = K·B/dF0,
    with combined slip blended along the slip direction."""

    radius: Tensor = 0.35
    width: Tensor = 0.2
    Fz0: Tensor = 4000.0          # nominal load
    cz: Tensor = 250e3
    dz: Tensor = 1e3
    # characteristics at Fz0 and 2·Fz0
    dfx0_1: Tensor = 80e3
    dfx0_2: Tensor = 150e3
    fxm_1: Tensor = 4500.0
    fxm_2: Tensor = 8500.0
    fxs_1: Tensor = 3500.0
    fxs_2: Tensor = 6800.0
    dfy0_1: Tensor = 60e3
    dfy0_2: Tensor = 110e3
    fym_1: Tensor = 4000.0
    fym_2: Tensor = 7500.0
    fys_1: Tensor = 3200.0
    fys_2: Tensor = 6200.0
    rolling_resistance: Tensor = 0.01


def _tms_quad(fz, v1, v2, Fz0):
    """Two-point quadratic a1·q + a2·q² through (1, v1), (2, v2)."""
    q = fz / Fz0
    a2 = 0.5 * (v2 - 2.0 * v1)
    a1 = v1 - a2
    return a1 * q + a2 * q * q


def tmsimple_forces(p: TMsimpleParams, wheel_x, wheel_q, wheel_v,
                    wheel_w_local, terrain_height_fn, terrain_mu=1.0):
    """TMeasy's contact and slip kinematics with the TMsimple law."""
    p = fields_as_tensors(p, wheel_x)
    c = _contact(p, wheel_x, wheel_q, wheel_v, wheel_w_local,
                 terrain_height_fn)
    fz = c.fz
    sx = (c.omega * c.r_eff - c.v_lon) / c.v_ref
    sy = -c.v_lat / c.v_ref

    def quad(name):
        return _tms_quad(fz, getattr(p, name + "_1"), getattr(p, name + "_2"),
                         p.Fz0)

    Fx_max, Fy_max = quad("fxm"), quad("fym")
    dFx0, dFy0 = quad("dfx0"), quad("dfy0")
    Fxs, Fys = quad("fxs"), quad("fys")

    s = torch.sqrt(sx * sx + sy * sy) + 1e-12
    cbeta = sx / s
    sbeta = sy / s
    K = torch.sqrt((Fx_max * cbeta) ** 2 + (Fy_max * sbeta) ** 2) + 1e-9
    dF0 = torch.sqrt((dFx0 * cbeta) ** 2 + (dFy0 * sbeta) ** 2) + 1e-9
    Fs = torch.sqrt((Fxs * cbeta) ** 2 + (Fys * sbeta) ** 2)
    B = math.pi - torch.asin(torch.clamp(Fs / K, -1.0, 1.0))
    A = K * B / dF0
    Fa = terrain_mu * K * torch.sin(B * (1.0 - torch.exp(-s / A)))
    return _assemble(p, c, Fa * cbeta, Fa * sbeta)
