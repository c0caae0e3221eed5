"""PyTorch port (chrono_tpu_torch) vs the JAX package: the model-file front
ends and the YAML app.

- URDF (tests/test_urdf.py's two-link arm), OpenSim (a pin, a ball and a
  slider joint) and ADAMS (a revolute pendulum, a spherical link and a
  spring-damper) decks, written by the test from ``chip_smoke.py``'s
  constants: parsed as the JAX parsers parse them, built field for field
  against the JAX builds (integer leaves to the bit, floats within 1e-7),
  then 50 steps on the direct solver, each JAX state stepped once by the
  port (x and q at ``test_torch_mbs.py``'s ``STEP_TOL``, v and ω at the
  North star's rtol 1e-3 / atol 1e-4: the float32 floor of the
  stabilised constraints, ~6e-5 at h = 1e-3) and the port's own run
  within x atol 2e-4 of the JAX run;
- the YAML spec layer on spec dicts: ``build_mbs`` field for field,
  ``run_spec`` on the MBS spec (the final state and the csv it writes) and
  on the DEM spec (``build_dem``'s particles to the bit, the final state at
  the North star's tolerances, the frame it writes); ``load_spec`` and
  ``main`` (``python -m chrono_tpu_torch.run``) on the same specs written
  as YAML files;
- ``validate_arrays`` and ``validate_csv`` against the JAX functions.

The reference's own decks are not in the repository,
so the decks are written here in their formats.  Both sides run in float32
on the CPU; each JAX step is jitted once (XLA's backend optimisations
off).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import yaml

from chrono_tpu.io import adams as JA
from chrono_tpu.io import opensim as JO
from chrono_tpu.io import urdf as JU
from chrono_tpu.io import yaml_spec as JY
from chrono_tpu.physics import system as jsys
from chrono_tpu.utils import validation as JV

from chrono_tpu_torch import convert
from chrono_tpu_torch import run as trun
from chrono_tpu_torch.io import adams as TA
from chrono_tpu_torch.io import opensim as TO
from chrono_tpu_torch.io import urdf as TU
from chrono_tpu_torch.io import yaml_spec as TY
from chrono_tpu_torch.io.writers import CSVWriter
from chrono_tpu_torch.physics import system as tsys
from chrono_tpu_torch.utils import validation as TV

import chip_smoke
from test_torch_mbs import assert_same_leaves, leaves
from test_torch_robots import run_both

O0 = {"xla_backend_optimization_level": 0}
N_STEPS = 50
# one step's v and ω: the North star's tolerance.  The stabilised
# constraints turn a position rounding of one float32 ulp (~6e-8 m or rad)
# into a velocity of ~6e-8 / h = 6e-5 at h = 1e-3, so two float32
# implementations of one step part there by that much (the three decks
# meet STEP_TOL in x and q; in v and ω up to 6e-5 apart, also between the
# JAX package's own compiles at two optimisation levels)
V_TOL = dict(rtol=1e-3, atol=1e-4)
DEM_X_TOL = dict(rtol=1e-4, atol=1e-5)
DEM_V_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    return chip_smoke.model_decks(str(tmp_path_factory.mktemp("decks")))


def build_both(kind, path):
    """(JAX model, JAX state), (port model, port state), names or None."""
    if kind == "urdf":
        with open(path) as f:
            text = f.read()
        jm, js, jn = JU.build_from_urdf(text)
        tm, ts, tn = TU.build_from_urdf(text, device="cpu")
        assert tn == jn
        return (jm, js), (tm, ts)
    if kind == "osim":
        jm, js, jn = JO.load_osim(path)
        tm, ts, tn = TO.load_osim(path, device="cpu")
        assert tn == jn
        return (jm, js), (tm, ts)
    return JA.load_adm(path), TA.load_adm(path, device="cpu")


def test_parsers_read_what_the_jax_parsers_read(decks):
    with open(decks["urdf"]) as f:
        text = f.read()
    ju, tu = JU.parse_urdf(text), TU.parse_urdf(text)
    assert tu.root == ju.root and list(tu.links) == list(ju.links)
    for a, b in zip(tu.joints, ju.joints):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    jo, to = JO.parse_osim(decks["osim"]), TO.parse_osim(decks["osim"])
    assert list(to["bodies"]) == list(jo["bodies"]) == [
        "ground", "rod1", "rod2", "slider"]
    assert [b["joint"]["tag"] for b in to["bodies"].values()
            if b["joint"]] == ["PinJoint", "BallJoint", "SliderJoint"]
    np.testing.assert_array_equal(to["gravity"], jo["gravity"])
    ja, ta = JA.parse_adm(decks["adm"]), TA.parse_adm(decks["adm"])
    assert ta.joints == ja.joints == [("REVOLUTE", 202, 101),
                                      ("SPHERICAL", 302, 203)]
    assert sorted(ta.markers) == sorted(ja.markers)
    for k, m in ja.markers.items():
        np.testing.assert_array_equal(ta.markers[k].quat, m.quat)
        np.testing.assert_array_equal(ta.markers[k].qp, m.qp)
    assert ta.springs == ja.springs
    np.testing.assert_array_equal(ta.gravity, ja.gravity)


@pytest.mark.parametrize("kind", ["urdf", "osim", "adm"])
def test_deck_builds_and_steps(kind, decks):
    (jm, js), (tm, ts) = build_both(kind, decks[kind])
    assert_same_leaves(tm, convert.mbs_model_from_numpy(leaves(jm),
                                                        device="cpu"))
    for f in "xqvw":
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-7, err_msg=f)
    h = chip_smoke.FILE_H
    settings = dict(solver="direct")
    jstep = jax.jit(lambda s, t: jsys.step_euler_implicit_linearized(
        jm, s, t, h, jsys.SolverSettings(**settings))[0],
        compiler_options=O0)
    jf, tf = run_both(
        jstep, lambda s, t: tsys.step_euler_implicit_linearized(
            tm, s, t, h, tsys.SolverSettings(**settings))[0], js, ts, h,
        n=N_STEPS, v_tol=V_TOL)
    assert float((tf.x - ts.x).abs().max()) > 1e-4      # it moved


# -------------------------------------------------------------- YAML specs

def mbs_spec(csv=None):
    spec = yaml.safe_load(chip_smoke.MBS_SPEC_YAML.replace("@CSV@", "x"))
    spec["simulation"]["end_time"] = 0.05
    spec["output"] = {"csv": csv} if csv else {}
    return spec


def dem_spec(frames=None):
    spec = yaml.safe_load(chip_smoke.DEM_SPEC_YAML.replace("@FRAMES@", "x"))
    spec["simulation"]["end_time"] = 0.01
    spec["output"] = {"frames": frames} if frames else {}
    return spec


def test_build_mbs_field_for_field():
    (jm, js), jn = JY.build_mbs(mbs_spec())
    (tm, ts), tn = TY.build_mbs(mbs_spec(), device="cpu")
    assert tn == jn == {"ground": 0, "rod": 1, "disc": 2}
    assert_same_leaves(tm, convert.mbs_model_from_numpy(leaves(jm),
                                                        device="cpu"))
    for f in "xqvw":
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    bad = mbs_spec()
    bad["model"]["motors"][0]["profile"]["type"] = "bogus"
    with pytest.raises(ValueError, match="unknown profile"):
        TY.build_mbs(bad, device="cpu")


def test_run_spec_mbs(tmp_path):
    """50 steps: the final state at x atol 2e-4 (and v, ω rtol 1e-3 /
    atol 1e-3), the csv's rows against the JAX run's csv."""
    jf = JY.run_spec(mbs_spec(str(tmp_path / "j.csv")), verbose=False)
    tf = TY.run_spec(mbs_spec(str(tmp_path / "t.csv")), verbose=False,
                     device="cpu")
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=0,
                               atol=2e-4)
    for f in "vw":
        np.testing.assert_allclose(getattr(tf, f).numpy(),
                                   np.asarray(getattr(jf, f)), rtol=1e-3,
                                   atol=1e-3, err_msg=f)
    jc, jd = CSVWriter.read(str(tmp_path / "j.csv"))
    tc, td = CSVWriter.read(str(tmp_path / "t.csv"))
    assert tc == jc and td.shape == jd.shape == (50, 10)
    np.testing.assert_allclose(td, jd, rtol=0, atol=2e-4)


def test_run_spec_dem(tmp_path):
    """``build_dem``'s system: the same particles to the bit; the spec's
    run: the same time, positions and velocities at the North star's
    tolerances, and the frame it writes."""
    js = JY.build_dem(dem_spec())
    ts = TY.build_dem(dem_spec(), device="cpu")
    np.testing.assert_array_equal(ts.positions, js.positions)
    assert ts.state.n == js.state.n == 64
    jf = JY.run_spec(dem_spec(), verbose=False)
    frames = str(tmp_path / "frames")
    tf = TY.run_spec(dem_spec(frames), verbose=False, device="cpu")
    assert float(tf.time) == float(jf.time) > 0.009
    np.testing.assert_allclose(tf.pos.numpy(), np.asarray(jf.pos),
                               **DEM_X_TOL)
    np.testing.assert_allclose(tf.vel.numpy(), np.asarray(jf.vel),
                               **DEM_V_TOL)
    from chrono_tpu_torch.io.writers import FrameWriter
    np.testing.assert_array_equal(FrameWriter.read_frame(frames, 0)["pos"],
                                  tf.pos.numpy())


def test_load_spec_and_main(tmp_path):
    """The specs as YAML files: ``load_spec`` reads what PyYAML reads, and
    ``main`` (the ``python -m chrono_tpu_torch.run`` entry) runs them on the
    device it is given and writes the csv."""
    csv = tmp_path / "m.csv"
    path = tmp_path / "mbs.yaml"
    spec = mbs_spec(str(csv))
    path.write_text(yaml.safe_dump(spec))
    assert TY.load_spec(str(path)) == JY.load_spec(str(path)) == spec
    assert trun.main is TY.main
    assert TY.main([str(path), "--device", "cpu"]) == 0
    cols, data = CSVWriter.read(str(csv))
    assert "disc_z" in cols and data.shape == (50, 10)
    assert np.isfinite(data).all()


def test_validation_norms(tmp_path):
    rng = np.random.default_rng(4)
    sim = rng.normal(size=(40, 4))
    ref = sim + 1e-3 * rng.normal(size=(40, 4))
    for norm in ("l2", "rms", "inf"):
        np.testing.assert_allclose(
            TV.validate_arrays(torch.tensor(sim), ref, norm),
            JV.validate_arrays(sim, ref, norm), rtol=1e-12)
    for pkg in (TV, JV):                       # an unknown norm's name
        with pytest.raises(KeyError):
            pkg.validate_arrays(sim, ref, "bogus")
    t = np.arange(40) * 0.01
    for name, data in (("sim", sim), ("gold", ref)):
        w = CSVWriter(str(tmp_path / f"{name}.csv"),
                      ["t", "a", "b", "c", "d"])
        for k in range(40):
            w.append(t[k], *data[k])
        w.write()
    got = TV.validate_csv(str(tmp_path / "sim.csv"),
                          str(tmp_path / "gold.csv"), columns=["a", "c"])
    ref_v = JV.validate_csv(str(tmp_path / "sim.csv"),
                            str(tmp_path / "gold.csv"), columns=["a", "c"])
    assert got.keys() == ref_v.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref_v[k], rtol=1e-12)
