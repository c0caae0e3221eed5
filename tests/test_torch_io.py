"""PyTorch port (chrono_tpu_torch) vs the JAX package: the output
writers, the exporters, the checkpoints and the reference DEM checkpoint
loader (``io/``).

The text files (CSV, PLY, OBJ, VTK, the frame and sequence indexes) must
be byte-identical to the JAX package's for the same data, given to the
port as tensors; npz frames hold the same arrays.  A ``DEMState`` that
the JAX ``save_checkpoint`` writes loads into the port's ``DEMState``
leaf for leaf (and the other way round), with the same archive names.
``parse_dem_checkpoint`` and ``dem_system_from_checkpoint`` agree with
JAX's on a checkpoint in the reference's text format written here.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chrono_tpu.dem import system as jsys
from chrono_tpu.io import checkpoint as jck
from chrono_tpu.io import dem_checkpoint as jdck
from chrono_tpu.io import export as jexp
from chrono_tpu.io import writers as jw

from chrono_tpu_torch import convert
from chrono_tpu_torch import io as tio
from chrono_tpu_torch.dem import system as tsys

from chip_smoke import dem_box_setup, dem_system_of
from test_torch_dem_system import (  # noqa: F401 (a fixture)
    jax_system, leaves, one_thread,
)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_csv_writer_bytes(tmp_path):
    cols = ["t", "x", "energy"]
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(7, 3)) * [1, 1e-3, 1e4]
    paths = []
    for mod, tag in ((jw, "jax"), (tio, "port")):
        w = mod.CSVWriter(str(tmp_path / tag / "log.csv"), cols)
        for r in rows:
            w.append(*(torch.tensor(v) if tag == "port" else v for v in r))
        w.write()
        paths.append(w.path)
    assert _read(paths[0]) == _read(paths[1])
    c0, d0 = jw.CSVWriter.read(paths[0])
    c1, d1 = tio.CSVWriter.read(paths[1])
    assert c0 == c1 == cols
    np.testing.assert_array_equal(d0, d1)
    with pytest.raises(ValueError):
        tio.CSVWriter(paths[1], cols).append(1.0, 2.0)


def test_frame_writer_arrays_and_index(tmp_path):
    rng = np.random.default_rng(2)
    frames = [(0.1 * k, rng.normal(size=(20, 3)).astype(np.float32))
              for k in range(3)]
    for mod, tag in ((jw, "jax"), (tio, "port")):
        w = mod.FrameWriter(str(tmp_path / tag), prefix="p")
        for t, pos in frames:
            w.write_frame(t, pos=torch.from_numpy(pos) if tag == "port"
                          else pos, ids=np.arange(20))
    assert _read(tmp_path / "jax" / "index.json") == \
        _read(tmp_path / "port" / "index.json")
    for k in range(3):
        a = jw.FrameWriter.read_frame(str(tmp_path / "jax"), k, "p")
        b = tio.FrameWriter.read_frame(str(tmp_path / "port"), k, "p")
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
            assert a[name].dtype == b[name].dtype


def test_hdf5_writer(tmp_path):
    pytest.importorskip("h5py", reason="h5py is not installed: the HDF5 "
                        "writer imports it when it is made")
    w = tio.HDF5Writer(str(tmp_path / "out.h5"))
    w.write_frame(0.5, pos=torch.ones((100, 3)))
    w.close()
    (t, arrays), = tio.HDF5Writer.read(str(tmp_path / "out.h5"))
    assert t == 0.5 and arrays["pos"].shape == (100, 3)


def test_exports_bytes(tmp_path):
    """PLY with colours and values, OBJ, legacy VTK and a PLY sequence
    with its index: the same bytes."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (50, 3))
    values = rng.uniform(size=50)
    verts = rng.normal(size=(6, 3))
    faces = np.array([[0, 1, 2], [2, 3, 4], [1, 4, 5]])
    heights = rng.normal(size=(5, 4))
    frames = [(0.05 * k, rng.normal(size=(10, 3))) for k in range(3)]
    for mod, tag in ((jexp, "jax"), (tio, "port")):
        d = tmp_path / tag
        conv = (lambda a: torch.as_tensor(a)) if tag == "port" else \
            (lambda a: a)
        mod.write_ply_points(str(d / "a.ply"), conv(pts), conv(colors),
                             conv(values))
        mod.write_ply_points(str(d / "b.ply"), conv(pts))
        mod.write_obj_mesh(str(d / "m.obj"), conv(verts), conv(faces))
        mod.write_vtk_structured_grid(str(d / "g.vtk"), conv(heights),
                                      (0.5, -1.0), 0.25)
        mod.export_particle_sequence(str(d / "seq"),
                                     [(t, conv(p)) for t, p in frames])
    names = ["a.ply", "b.ply", "m.obj", "g.vtk", "seq/index.json"] + [
        f"seq/particles_{k:06d}.ply" for k in range(3)]
    for name in names:
        assert _read(tmp_path / "jax" / name) == \
            _read(tmp_path / "port" / name), name
    assert len(os.listdir(tmp_path / "port" / "seq")) == 4


@pytest.mark.parametrize("integrator,rolling", [
    ("centered_difference", "none"), ("chung", "elastic_plastic")])
def test_dem_state_checkpoint_across_packages(tmp_path, integrator,
                                              rolling):
    """A JAX ``DEMState`` (after a rebuild, so the list is filled) saved by
    the JAX package loads into the port's, leaf for leaf; the port's saved
    state loads into JAX's; both archives have the same names; the
    metadata comes back."""
    setup = dem_box_setup(n=40, integrator=integrator, rolling_mode=rolling)
    js = jax_system(setup)
    jstate = jsys.rebuild_neighbors(js.params, js.grid, js.state)
    jstate = jstate.replace(tan_disp=jnp.asarray(
        np.random.default_rng(4).normal(size=jstate.tan_disp.shape),
        jnp.float32))
    meta = {"step": 12, "note": "settled"}
    jck.save_checkpoint(str(tmp_path / "j.npz"), jstate, metadata=meta)
    template = dem_system_of(setup, "cpu").state
    got = tio.load_checkpoint(str(tmp_path / "j.npz"), template)
    assert type(got) is tsys.DEMState
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(jstate, f.name)
        assert (a is None) == (b is None), f.name
        if f.name == "nbr":
            for g in ("idx", "valid", "overflow"):
                np.testing.assert_array_equal(getattr(a, g).numpy(),
                                              np.asarray(getattr(b, g)))
                assert getattr(a, g).dtype == getattr(template.nbr, g).dtype
        elif a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tio.load_metadata(str(tmp_path / "j.npz")) == meta
    tio.save_checkpoint(str(tmp_path / "t.npz"), got, metadata=meta)
    assert sorted(np.load(tmp_path / "t.npz").files) == \
        sorted(np.load(tmp_path / "j.npz").files)
    back = jck.load_checkpoint(str(tmp_path / "t.npz"), jstate)
    for a, b in zip(jax_leaves(back), jax_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="leaves"):
        tio.load_checkpoint(str(tmp_path / "j.npz"), template.nbr)


def jax_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


CHECKPOINT = """ChSystemDem
radius: 0.05
density: 2500
boxSize: 1.2 1.0 1.5
G: 0 0 -9.81
fixedStepSize: 2e-4
timeIntegrator: {integrator}
frictionMode: 2
rollingMode: {rolling}
K_n_s2s: 2e5
G_n_s2s: 40
K_t_s2s: 1.5e5
G_t_s2s: 20
K_n_s2w: 3e5
G_n_s2w: 30
K_t_s2w: 2e5
G_t_s2w: 10
StaticFrictionCoeff_s2s: 0.4
StaticFrictionCoeff_s2w: 0.3
RollingCoeff_s2s: 0.05
RollingCoeff_s2w: 0.02
ParamsEnd

CsvParticles
x,y,z,vx,vy,vz,wx,wy,wz,fixed
{rows}
HstHistory
0 1 0.001 0 0
"""


def _checkpoint_file(tmp_path, integrator=1, rolling=1, n=30):
    rng = np.random.default_rng(5)
    pos = rng.uniform(-0.4, 0.4, (n, 3))
    rest = rng.normal(size=(n, 6))
    fixed = rng.integers(0, 2, n)
    rows = "\n".join(",".join(f"{v:.9g}" for v in np.r_[p, r, f])
                     for p, r, f in zip(pos, rest, fixed))
    path = tmp_path / "ck.txt"
    path.write_text(CHECKPOINT.format(integrator=integrator,
                                      rolling=rolling, rows=rows))
    return str(path)


def test_parse_dem_checkpoint_matches_jax(tmp_path):
    path = _checkpoint_file(tmp_path)
    a, b = tio.parse_dem_checkpoint(path), jdck.parse_dem_checkpoint(path)
    assert a["params"] == b["params"] and len(a["params"]) == 20
    assert a["particles"].keys() == b["particles"].keys()
    for k in a["particles"]:
        np.testing.assert_array_equal(a["particles"][k], b["particles"][k])


@pytest.mark.parametrize("integrator,rolling", [(1, 1), (3, 2)])
def test_dem_system_from_checkpoint_matches_jax(tmp_path, integrator,
                                                 rolling):
    """The user force model with the checkpoint's raw coefficients, the
    enums mapped, the particles and their spins, the fixity, the grid;
    the history block is not imported."""
    path = _checkpoint_file(tmp_path, integrator, rolling)
    ts, tfixed = tio.dem_system_from_checkpoint(path, device="cpu",
                                                max_per_cell=16)
    js, jfixed = jdck.dem_system_from_checkpoint(path, max_per_cell=16)
    np.testing.assert_array_equal(tfixed, jfixed)
    assert ts.params == convert.params_from_numpy(leaves(js.params))
    assert ts.params.force_model == "user"
    for k in ("pos", "vel", "omega"):
        np.testing.assert_array_equal(getattr(ts.state, k).numpy(),
                                      np.asarray(getattr(js.state, k)))
    assert ts.grid == convert.grid_from_numpy(leaves(js.grid))
    with open(path) as f:
        assert "HstHistory" in f.read()      # parsed, and not imported
    assert not ts.state.tan_disp.any()
