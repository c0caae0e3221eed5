"""PyTorch port (chrono_tpu_torch) vs the JAX package: DEM ↔ triangle-mesh
coupling (``dem/mesh.py``).

chip_smoke.py's ``ramp_mesh_setup`` (two triangles on a tilted, moving,
turning frame; 200 spheres of r = 5 cm with their centres 0.3 r … 1.2 r
above the face, from a numpy seed) goes through both packages: the triangle binning must
give the same table, the world triangles agree to 1e-6 m, and
``sphere_mesh_forces`` agrees at rtol 1e-4 with an atol of 1e-5 of the
largest particle force (torques: of that force times r).  The JAX
function is jitted at XLA's O0.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chrono_tpu.dem import mesh as jmesh
from chrono_tpu.dem import system as jsys

from chrono_tpu_torch import convert
from chrono_tpu_torch.dem import mesh as tmesh

from chip_smoke import ramp_mesh_forces, ramp_mesh_setup
from test_torch_dem_system import leaves, one_thread  # noqa: F401

O0 = {"xla_backend_optimization_level": 0}
GEOM_TOL = dict(rtol=1e-6, atol=1e-6)


def _jax_scene(setup):
    sys_ = jsys.DEMSystem(**setup["system"])
    sys_.set_material(**setup["material"])
    sys_.set_wall_material(**setup["wall_material"])
    sys_._build()
    mesh = jmesh.make_triangle_mesh(setup["verts"], setup["faces"]).replace(
        **{k: jnp.asarray(v) for k, v in setup["frame"].items()})
    return sys_, mesh


def test_bins_match_jax():
    """The table of the ramp's two triangles (margin r), and a crowded
    soup of 60 triangles at cap 3 (cells that want more keep their first
    3): equal tables and equal fullest-cell counts."""
    setup = ramp_mesh_setup()
    js, _ = _jax_scene(setup)
    grid = convert.grid_from_numpy(leaves(js.grid))
    for tris, cap in ((setup["world"], 8),
                      (tuple(np.random.default_rng(2).uniform(
                          0.3, 0.5, (60, 3)) for _ in range(3)), 3)):
        ref, ref_most = jmesh.bin_triangles_numpy(js.grid, tris, cap=cap,
                                                  margin=0.05)
        got, most = tmesh.bin_triangles_numpy(grid, tris, cap=cap,
                                              margin=0.05, device="cpu")
        assert most == ref_most and got.cap == ref.cap == cap
        np.testing.assert_array_equal(got.tri_ids.numpy(),
                                      np.asarray(ref.tri_ids))
        assert int((got.tri_ids >= 0).sum()) > 2
    assert most == cap                  # the crowded cells are cut at cap
    conv = convert.mesh_bins_from_numpy(leaves(ref), device="cpu")
    assert torch.equal(conv.tri_ids, got.tri_ids) and conv.cap == cap


def test_world_triangles_match_jax():
    setup = ramp_mesh_setup()
    _, jm = _jax_scene(setup)
    tm = convert.triangle_mesh_from_numpy(leaves(jm), device="cpu")
    assert tm.n_tris == jm.n_tris == 2
    for got, ref, w in zip(tmesh.mesh_world_triangles(tm),
                           jmesh.mesh_world_triangles(jm), setup["world"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GEOM_TOL)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=2e-7)


def test_sphere_mesh_forces_match_jax():
    """Forces and torques on the particles and the force and torque on
    the mesh about its frame origin."""
    setup = ramp_mesh_setup()
    js, jm = _jax_scene(setup)
    bins, _ = jmesh.bin_triangles_numpy(js.grid, setup["world"], cap=8,
                                        margin=0.05)
    pos, vel, omega = (jnp.asarray(a) for a in setup["arrays"])
    ref = jax.jit(lambda p, v, w: jmesh.sphere_mesh_forces(
        js.params, js.grid, bins, jm, p, v, w), compiler_options=O0)(
            pos, vel, omega)
    got, most = ramp_mesh_forces(setup, "cpu")
    assert most <= 8
    f_scale = float(jnp.abs(ref[0]).max())
    n_touch = int((np.abs(np.asarray(ref[0])).sum(1) > 0).sum())
    assert f_scale > 0 and n_touch > 10
    for g, r, name, s in zip(got, ref, ("f", "tau", "F", "T"),
                             (1.0, 0.05, 1.0, 1.0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5 * f_scale * s, err_msg=name)
    # the mesh takes minus the particles' sum, and friction is capped at
    # the wall material's μ: with the particles' μ the answer moves
    np.testing.assert_allclose(got[2].numpy(), -got[0].sum(0).numpy(),
                               rtol=1e-5, atol=1e-4 * f_scale)
    other = dict(setup, wall_material=dict(setup["wall_material"],
                                           mu_s=0.5))
    moved, _ = ramp_mesh_forces(other, "cpu")
    assert not np.allclose(moved[0].numpy(), got[0].numpy(), rtol=1e-4,
                           atol=1e-5 * f_scale)


def test_obj_loader_and_mesh_match_jax(tmp_path):
    """An OBJ with a quad, a pentagon and a triangle (fan-triangulated,
    ``v//n`` and ``v/t`` indices): the same vertices and faces, and the
    same mesh at rest at the origin."""
    path = tmp_path / "shape.obj"
    path.write_text(
        "# test\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0.2\n"
        "vn 0 0 1\nf 1//1 2//1 3//1 4//1\nf 1/1 2/2 3/3 5/4 4/5\n"
        "f 2 3 5\n")
    v, f = tmesh.load_obj_numpy(str(path))
    jv, jf = jmesh.load_obj_numpy(str(path))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert v.dtype == np.float32 and f.dtype == np.int32 and len(f) == 6
    tm = tmesh.make_triangle_mesh(v, f, device="cpu")
    jm = jmesh.make_triangle_mesh(jv, jf)
    for field in dataclasses.fields(tm):
        np.testing.assert_array_equal(getattr(tm, field.name).numpy(),
                                      np.asarray(getattr(jm, field.name)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            tmesh.make_triangle_mesh(v, f)
