"""OpenCRG road surfaces (CRGTerrain role).

Counterpart of ``chrono_tpu/vehicle/crg.py``: reads the OpenCRG road files
the reference consumes through its vendored OpenCRG library and provides
road queries on tensors:

* parser (numpy, host; this package keeps its own copy): the IPLOS text
  (LRFI, fixed 10-character fields) and binary (KRBI, big-endian float32)
  data formats, header parameters in either the uppercase-assignment or
  lowercase-exponent style, channels ``reference line phi/slope/banking``
  and ``long section``s (explicit ``at v =`` offsets or an implicit
  uniform v-range);
* geometry: the reference line is integrated once on the host (heading φ,
  slope) into centerline arrays; elevation z(u,v) = ∫slope du +
  v·tan(bank) + grid(u,v) with keep-last borders;
* queries: ``crg_height(road, x, y)`` (nearest-station projection +
  bilinear grid sample, tensor ops only), ``crg_path`` for the
  path-follower driver, and ``crg_to_heightmap`` to rasterize into the
  rigid/SCM terrain grids.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class CRGRoad:
    du: Tensor          # station increment [m]
    cx: Tensor          # (Nu,) centerline x
    cy: Tensor          # (Nu,)
    cz: Tensor          # (Nu,) reference-line elevation (∫ slope)
    phi: Tensor         # (Nu,) heading
    bank: Tensor        # (Nu,) banking angle [rad] (0 if absent)
    v: Tensor           # (Nv,) cross offsets (ascending)
    z: Tensor           # (Nu, Nv) long-section elevation grid


def _parse_header(text: str) -> dict:
    params = {}
    for line in text.splitlines():
        line = line.split("!")[0].strip()
        if not line or line.startswith(("*", "$", "#")):
            continue
        m = re.match(r"([A-Za-z_0-9]+)\s*=\s*([-+0-9.eE]+)", line)
        if m:
            params[m.group(1).lower()] = float(m.group(2))
    return params


def load_crg(path: str, device=None) -> CRGRoad:
    """Parse an OpenCRG file (LRFI text or KRBI binary) into a
    ``CRGRoad`` on the card unless ``device`` names another."""
    device = resolve_device(device, "load_crg")
    raw = open(path, "rb").read()
    fmt_m = re.search(rb"#:(LRFI|KRBI)", raw)
    if not fmt_m:
        raise ValueError(f"{path}: no IPLOS data format marker")
    fmt = fmt_m.group(1).decode()

    # channel definitions (D: lines, in data order)
    chan_defs = [m.group(1).decode("latin1")
                 for m in re.finditer(rb"\nD:([^\n]*)", raw)]
    nchan = len(chan_defs)

    # header parameters (everything before the data block is ASCII)
    last_d = max(m.end() for m in re.finditer(rb"\nD:[^\n]*", raw)) + 1
    header = raw[:last_d].decode("latin1", errors="replace")
    prm = _parse_header(header)

    # data block starts after the '$...' separator record(s)
    k = last_d
    while raw[k:k + 1] in (b"$", b"*", b"\n"):
        nl = raw.find(b"\n", k)
        if raw[k:k + 1] not in (b"\n",) and not raw[k:nl].startswith(
                (b"$", b"*")):
            break
        k = nl + 1

    if fmt == "KRBI":
        data = np.frombuffer(raw[k:], dtype=">f4")
        rows = data.size // nchan
        table = data[:rows * nchan].reshape(rows, nchan).astype(np.float64)
    else:
        rows_l = []
        for line in raw[k:].decode("latin1").splitlines():
            if not line.strip() or line.lstrip().startswith(("$", "*", "!")):
                continue
            vals = []
            for c0 in range(0, len(line) - 9, 10):
                f = line[c0:c0 + 10]
                try:
                    vals.append(float(f))
                except ValueError:
                    vals.append(np.nan)      # '**unused**'
            if len(vals) == nchan:
                rows_l.append(vals)
        table = np.asarray(rows_l, np.float64)

    # map channels
    idx_phi = idx_slope = idx_bank = None
    sect_cols, sect_v = [], []
    for i, d in enumerate(chan_defs):
        dl = d.lower()
        if "reference line phi" in dl:
            idx_phi = i
        elif "reference line slope" in dl:
            idx_slope = i
        elif "reference line bank" in dl:
            idx_bank = i
        elif "long section" in dl:
            sect_cols.append(i)
            m = re.search(r"at v\s*=\s*([-+0-9.eE]+)", d)
            sect_v.append(float(m.group(1)) if m else None)
    if any(vv is None for vv in sect_v):
        v_r = prm.get("long_section_v_right", -1.0)
        v_l = prm.get("long_section_v_left", 1.0)
        sect_v = list(np.linspace(v_r, v_l, len(sect_cols)))

    du = prm.get("reference_line_increment", 1.0)
    nu = table.shape[0]
    phi0 = prm.get("reference_line_start_phi", 0.0)
    x0 = prm.get("reference_line_start_x", 0.0)
    y0 = prm.get("reference_line_start_y", 0.0)

    phi = np.full(nu, phi0)
    if idx_phi is not None:
        col = table[:, idx_phi]
        phi = np.where(np.isnan(col), phi0, col)
        phi[0] = phi[1] if nu > 1 else phi0   # first record is 'unused'
    slope = np.zeros(nu)
    if idx_slope is not None:
        col = table[:, idx_slope]
        slope = np.where(np.isnan(col), 0.0, col)
    bank = np.zeros(nu)
    if idx_bank is not None:
        col = table[:, idx_bank]
        bank = np.where(np.isnan(col), 0.0, col)

    # integrate the reference line (φ, slope of row i apply to the segment
    # ENDING at station i — row 0 is the unused record)
    cx = np.empty(nu)
    cy = np.empty(nu)
    cz = np.empty(nu)
    cx[0], cy[0], cz[0] = x0, y0, 0.0
    for i in range(1, nu):
        cx[i] = cx[i - 1] + du * np.cos(phi[i])
        cy[i] = cy[i - 1] + du * np.sin(phi[i])
        cz[i] = cz[i - 1] + du * slope[i]

    z = table[:, sect_cols]
    z = np.where(np.isnan(z), 0.0, z)
    order = np.argsort(sect_v)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return CRGRoad(du=f32(du), cx=f32(cx), cy=f32(cy), cz=f32(cz),
                   phi=f32(phi), bank=f32(bank),
                   v=f32(np.asarray(sect_v)[order]), z=f32(z[:, order]))


def crg_height(road: CRGRoad, x, y):
    """Road elevation under world (x, y) — nearest-station projection +
    bilinear grid sample, keep-last borders.  Broadcasts over leading
    dims."""
    x = torch.as_tensor(x, dtype=road.cx.dtype, device=road.cx.device)
    y = torch.as_tensor(y, dtype=road.cx.dtype, device=road.cx.device)
    d2 = (road.cx - x[..., None]) ** 2 + (road.cy - y[..., None]) ** 2
    i = torch.argmin(d2, dim=-1)
    ph = road.phi[i]
    tx, ty = torch.cos(ph), torch.sin(ph)
    dx = x - road.cx[i]
    dy = y - road.cy[i]
    u_loc = dx * tx + dy * ty                       # along-road residual
    v = -dx * ty + dy * tx                          # signed cross offset
    # u interpolation between stations i and i±1
    j = torch.clamp(i + torch.sign(u_loc).to(i.dtype), 0,
                    road.cx.shape[0] - 1)
    a = torch.clamp(torch.abs(u_loc) / road.du, 0.0, 1.0)
    # v interpolation on the section grid (clamped: keep-last border)
    vi = torch.clamp(torch.searchsorted(road.v, v.contiguous()) - 1, 0,
                     road.v.shape[0] - 2)
    w = torch.clamp((v - road.v[vi]) / (road.v[vi + 1] - road.v[vi]),
                    0.0, 1.0)

    def zat(k):
        sec = (1 - w) * road.z[k, vi] + w * road.z[k, vi + 1]
        return road.cz[k] + v * torch.tan(road.bank[k]) + sec

    return (1 - a) * zat(i) + a * zat(j)


def crg_path(road: CRGRoad):
    """Centerline (Nu, 2) for the path-follower driver."""
    return torch.stack([road.cx, road.cy], dim=-1)


def crg_to_heightmap(road: CRGRoad, lo, hi, spacing):
    """Rasterize into an axis-aligned height grid (rigid/SCM terrain
    input); off-road cells get the nearest road edge height (keep-last).
    Returns numpy (xs, ys, Z)."""
    xs = np.arange(lo[0], hi[0] + spacing / 2, spacing)
    ys = np.arange(lo[1], hi[1] + spacing / 2, spacing)
    X, Y = np.meshgrid(xs, ys, indexing="ij")

    def t(a):
        return torch.as_tensor(a.ravel().astype(np.float32),
                               device=road.cx.device)

    Z = crg_height(road, t(X), t(Y))
    return xs, ys, Z.cpu().numpy().reshape(X.shape)
