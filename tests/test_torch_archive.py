"""PyTorch port (chrono_tpu_torch): the JSON archive of carriers, the visual
assets against the JAX package, and the timers.

- ``archive_out`` → ``archive_in`` of a ``Model`` with joints, motors (a
  sampled ``FInterp`` program and a sine), springs and rotational springs,
  of a ``BodyState``, of the copter (a carrier holding a ``Model``) and of
  containers of tensors in every dtype the port keeps: every tensor comes
  back bit for bit with its dtype, shape and device, and one step of the
  restored model equals the original's to the bit; a carrier type that the
  registry does not hold is refused;
- ``VisualScene.tessellate`` (spheres, boxes, cylinders and a mesh on
  moved, turned bodies; poses from tensors) against the JAX package's:
  vertices atol 1e-6, faces and colours exact;
- ``PhaseTimers`` (with a synchronised result), ``Profiler`` and
  ``device_trace`` on CPU work.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from chrono_tpu import assets as JAs

from chrono_tpu_torch import assets as TAs
from chrono_tpu_torch.core import functions as TF
from chrono_tpu_torch.io.archive import archive_in, archive_out
from chrono_tpu_torch.models.robots import create_copter
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics.builder import SystemBuilder
from chrono_tpu_torch.physics.system import (
    SolverSettings, step_euler_implicit_linearized,
)
from chrono_tpu_torch.utils import timers
from chrono_tpu_torch.utils.tree import REGISTRY, tensor_dataclass


def equal_trees(a, b, path="root"):
    """Type for type; tensors bit for bit with dtype, shape and device."""
    assert type(a) is type(b), path
    if isinstance(a, torch.Tensor):
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape,
                                                b.device), path
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(
            torch.isnan(a), torch.isnan(b)) and torch.equal(
                a.nan_to_num(0.0), b.nan_to_num(0.0))), path
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            equal_trees(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            equal_trees(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            equal_trees(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


def scene(dtype=torch.float32):
    """Every element kind the archive has to carry: revolute, spherical and
    prismatic joints, an angle motor on a sampled program, a speed motor on
    a sine, a translational and a rotational spring."""
    b = SystemBuilder(dtype=dtype, device="cpu")
    g = b.add_ground()
    arm = b.add_body(mass=1.0, inertia=(0.01, 0.05, 0.05), pos=(0.5, 0, 0))
    disc = b.add_body(mass=0.5, inertia=(0.002, 0.004, 0.002),
                      pos=(1.0, 0, 0))
    slider = b.add_body(mass=0.3, pos=(0.0, 1.0, 0.0))
    ts = torch.linspace(0.0, 1.0, 11)
    b.add_motor_rotation_angle(g, arm, (0, 0, 0), (0, 1, 0),
                               TF.FInterp(ts=ts, ys=torch.sin(3.0 * ts)))
    b.add_motor_rotation_speed(arm, disc, (1, 0, 0), (1, 0, 0), TF.FSine(
        amp=torch.tensor(3.0), freq=torch.tensor(2.0),
        phase=torch.tensor(0.1)))
    b.add_joint("prismatic", g, slider, world_pos=(0, 1, 0),
                world_axis=(1, 0, 0))
    b.add_joint("spherical", arm, slider, world_pos=(0.5, 0.5, 0))
    b.add_tsda(g, slider, pa_world=(1, 1, 0), pb_world=(0, 1, 0), k=50.0,
               c=0.5, rest_length=0.8)
    b.add_rsda(g, arm, world_axis=(0, 1, 0), k=2.0, c=0.1)
    return b.finalize()


def test_model_round_trip_bit_for_bit(tmp_path):
    model, state = scene()
    back = archive_in(archive_out(model))
    equal_trees(model, back)
    assert set(model.joints) == {"revolute", "prismatic", "spherical"}
    path = str(tmp_path / "model.json")
    archive_out((model, state), path)
    m2, s2 = archive_in(path)
    equal_trees((model, state), (m2, s2))
    settings = SolverSettings(solver="direct")
    t = torch.tensor(0.3)
    a = step_euler_implicit_linearized(model, state, t, 1e-3, settings)[0]
    b = step_euler_implicit_linearized(m2, s2, t, 1e-3, settings)[0]
    equal_trees(a, b)


def test_model_round_trip_float64():
    model, state = scene(torch.float64)
    back = archive_in(archive_out(model))
    equal_trees(model, back)
    assert back.props.inv_mass.dtype == torch.float64


def test_nested_carriers_and_dtypes():
    """A carrier holding a ``Model`` (the copter), and containers of
    tensors in each dtype with values that text rounds badly."""
    copter, state = create_copter(device="cpu")
    equal_trees(copter, archive_in(archive_out(copter)))
    vals = [1.0 / 3.0, -0.0, 1e-38, 3.4e38, float("inf"), float("nan"),
            2.0 ** -149]
    tree = {"f32": torch.tensor(vals, dtype=torch.float32),
            "f64": torch.tensor(vals, dtype=torch.float64),
            "i32": torch.tensor([-2 ** 31, 7], dtype=torch.int32),
            "i64": torch.tensor([2 ** 62, -1], dtype=torch.int64),
            "bool": torch.tensor([True, False]),
            "empty": torch.zeros((0, 3)),
            "scalar": torch.tensor(0.1),
            "state": BodyState(*[torch.randn(2, k, generator=torch.Generator(
            ).manual_seed(k)) for k in (3, 4, 3, 3)]),
            "list": [1, 2.5, "s", None, (True,)],
            "np": np.arange(4, dtype=np.int16)}
    back = archive_in(archive_out(tree))
    equal_trees(tree, back)
    assert torch.equal(torch.signbit(back["f32"]), torch.signbit(tree["f32"]))


def test_archive_refuses_unregistered_types():
    @dataclasses.dataclass
    class Loose:
        a: int = 1

    with pytest.raises(TypeError, match="cannot archive Loose"):
        archive_out(Loose())
    with pytest.raises(TypeError, match="two carriers named BodyState"):
        @tensor_dataclass
        class BodyState:                      # noqa: F811
            x: torch.Tensor = None
    assert REGISTRY["BodyState"].__module__.endswith("physics.body")
    doc = json.loads(archive_out(torch.zeros(2)))
    doc["archive_version"] = 99
    with pytest.raises(ValueError, match="newer version"):
        archive_in(json.dumps(doc))


# ------------------------------------------------------------------ assets

def visual_scenes(mod):
    s = mod.VisualScene()
    s.model(0).add_sphere(0.5, material=mod.VisualMaterial(color=(1, 0, 0)))
    s.model(1).add_box((0.1, 0.2, 0.3), pos=(0.1, 0, 0),
                       rot=(np.cos(0.3), np.sin(0.3), 0, 0)).add_cylinder(
        0.05, 0.4, pos=(0, 0, 0.5))
    s.model(2).add_mesh([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                        [[0, 1, 2], [0, 1, 3]], pos=(0, 0.2, 0),
                        material=mod.VisualMaterial(color=(0.2, 0.4, 0.6)))
    return s


def test_tessellate_against_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 3))
    q = rng.normal(size=(3, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jv, jf, jc = visual_scenes(JAs).tessellate(x, q)
    tv, tf, tc = visual_scenes(TAs).tessellate(
        torch.tensor(x, dtype=torch.float32),
        torch.tensor(q, dtype=torch.float32))
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tc, jc)
    assert len(tf) > 100


# ------------------------------------------------------------------ timers

def test_phase_timers_and_profiler(tmp_path):
    pt = timers.PhaseTimers()
    a = torch.randn(64, 64)
    for _ in range(3):
        with pt.phase("matmul", sync_result=None):
            out = a @ a
        with pt.phase("synced", sync_result={"out": [out, (out,)]}):
            out = out @ a
    pt.add_sim_time(0.01, 0.02)
    assert pt.counts["matmul"] == pt.counts["synced"] == 3
    assert pt.totals["matmul"] > 0 and pt.rtf == pytest.approx(2.0)
    report = pt.report()
    assert "matmul" in report and "RTF = 2.00" in report
    prof = timers.Profiler()
    with prof("advance"):
        for _ in range(2):
            with prof("collision"):
                a.sum()
    assert prof.nodes["advance/collision"][1] == 2
    assert prof.nodes["advance"][1] == 1
    lines = prof.report().splitlines()
    assert lines[0].startswith("advance") and lines[1].startswith(
        "  collision")
    with timers.device_trace(str(tmp_path / "trace")) as p:
        (a @ a).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any("matmul" in e.name or "mm" in e.name for e in p.events())
