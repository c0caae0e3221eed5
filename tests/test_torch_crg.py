"""PyTorch port (chrono_tpu_torch) vs the JAX package: OpenCRG roads.

The reference's shipped .crg roads are not in the repository, so the test
writes its own in ``tmp_path``: an LRFI text road (uppercase header
assignments, the reference line's phi, slope and banking channels, five
long sections at explicit ``at v =`` offsets, a first record of
``**unused**`` fields, comment and separator lines) and a KRBI binary road
(lowercase exponent header, phi and three long sections on an implicit
uniform v-range).  Both packages parse each road (the port keeps its own
copy of the numpy parser) and query it: the centerline, the elevation at
random points on and off the road (``crg_height``), the path and a
rasterised height map.  The parsed arrays must be equal; the queries agree
within float32 rounding of the road's heights (atol 1e-5 m).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
from chrono_tpu.vehicle import crg as jcrg

from chrono_tpu_torch.vehicle import crg as tcrg

H_ATOL = 1e-5


def _field(x):
    return "**unused**" if x is None else f"{x:10.5f}"[:10].rjust(10)


def write_lrfi(path, nu=41, du=0.5, seed=0):
    rng = np.random.default_rng(seed)
    phi = np.cumsum(rng.normal(0.0, 0.01, nu)) + 0.3
    slope = 0.02 * np.sin(np.linspace(0, 3, nu))
    bank = 0.03 * np.cos(np.linspace(0, 2, nu))
    v = [-2.0, -1.0, 0.0, 1.0, 2.0]
    z = 0.05 * rng.normal(size=(nu, len(v)))
    lines = ["$CT", "  handmade test road", "$", "$ROAD_CRG",
             f"REFERENCE_LINE_START_X   = 3.0", "REFERENCE_LINE_START_Y   = -1.5",
             f"REFERENCE_LINE_INCREMENT = {du}  ! station spacing",
             "$", "$KD_DEFINITION", "#:LRFI",
             "D:reference line phi,rad",
             "D:reference line slope,m/m",
             "D:reference line banking,rad"]
    lines += [f"D:long section {i + 1},m at v = {vv:.3f}"
              for i, vv in enumerate(v)]
    lines += ["$", "$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$"]
    for i in range(nu):
        row = [None if i == 0 else phi[i], slope[i], bank[i], *z[i]]
        lines.append("".join(_field(x) for x in row))
    path.write_text("\n".join(lines) + "\n", encoding="latin1")


def write_krbi(path, nu=30, seed=1):
    rng = np.random.default_rng(seed)
    phi = np.cumsum(rng.normal(0.0, 0.02, nu))
    z = 0.03 * rng.normal(size=(nu, 3))
    head = ["$CT", "  binary test road", "$ROAD_CRG",
            "reference_line_increment = 1.0e+00",
            "long_section_v_right = -1.5e+00",
            "long_section_v_left = 1.5e+00", "$",
            "$KD_DEFINITION", "#:KRBI", "D:reference line phi,rad",
            "D:long section 1,m", "D:long section 2,m", "D:long section 3,m",
            "$", "$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$$"]
    table = np.concatenate([phi[:, None], z], axis=1).astype(">f4")
    table[0, 0] = np.nan                    # the unused first record
    path.write_bytes(("\n".join(head) + "\n").encode("latin1")
                     + table.tobytes())


@pytest.fixture(params=["lrfi", "krbi"])
def road_file(request, tmp_path):
    p = tmp_path / f"road_{request.param}.crg"
    (write_lrfi if request.param == "lrfi" else write_krbi)(p)
    return p


def test_crg_parse_and_query(road_file):
    jr = jcrg.load_crg(str(road_file))
    tr = tcrg.load_crg(str(road_file), device="cpu")
    for f in ("du", "cx", "cy", "cz", "phi", "bank", "v", "z"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    assert tr.z.shape[0] > 20 and tr.v.shape[0] >= 3
    np.testing.assert_array_equal(tcrg.crg_path(tr).numpy(),
                                  np.asarray(jcrg.crg_path(jr)))

    cx, cy = tr.cx.numpy(), tr.cy.numpy()
    rng = np.random.default_rng(2)
    k = rng.integers(0, len(cx), 300)
    x = (cx[k] + rng.normal(0.0, 1.2, 300)).astype(np.float32)
    y = (cy[k] + rng.normal(0.0, 1.2, 300)).astype(np.float32)
    ref = np.asarray(jcrg.crg_height(jr, jnp.asarray(x), jnp.asarray(y)))
    got = tcrg.crg_height(tr, x, y).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=H_ATOL)
    # scalar queries and a (2, 3) batch broadcast as in the JAX package
    np.testing.assert_allclose(
        float(tcrg.crg_height(tr, float(x[0]), float(y[0]))),
        float(jcrg.crg_height(jr, jnp.asarray(x[0]), jnp.asarray(y[0]))),
        rtol=0, atol=H_ATOL)
    np.testing.assert_allclose(
        tcrg.crg_height(tr, x[:6].reshape(2, 3), y[:6].reshape(2, 3)).numpy(),
        ref[:6].reshape(2, 3), rtol=0, atol=H_ATOL)

    lo = (float(cx.min()) - 1.0, float(cy.min()) - 1.0)
    hi = (float(cx.min()) + 4.0, float(cy.min()) + 3.0)
    xs_t, ys_t, Z_t = tcrg.crg_to_heightmap(tr, lo, hi, 0.25)
    xs_j, ys_j, Z_j = jcrg.crg_to_heightmap(jr, lo, hi, 0.25)
    np.testing.assert_array_equal(xs_t, xs_j)
    np.testing.assert_array_equal(ys_t, ys_j)
    np.testing.assert_allclose(Z_t, Z_j, rtol=0, atol=H_ATOL)


def test_crg_defaults_to_the_card(road_file):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default loads there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcrg.load_crg(str(road_file))
