"""YAML model / simulation specification: build a scene from a spec and run
it.

Counterpart of ``chrono_tpu/io/yaml_spec.py`` (the reference's YAML parser
layer and its yaml_app runners): a declarative scene + simulation
description that builds a model and runs it — the port's config-driven
entry point, ``python -m chrono_tpu_torch.run spec.yaml``.

Top-level keys: ``simulation`` (time_step, end_time, solver, gravity),
``model`` (mbs: bodies / joints / motors / springs | dem: material and
sampling), ``output`` (csv / frames).  A spec is a plain dict; PyYAML is
imported only by :func:`load_spec`, so the package imports without it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def load_spec(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _name_index(bodies_spec):
    return {b.get("name", f"body{i}"): i for i, b in enumerate(bodies_spec)}


def _profile(m):
    from chrono_tpu_torch.core import functions as F

    p = m.get("profile", {"type": "const", "value": m.get("value", 0.0)})
    kind = p["type"]

    def t(v):
        return torch.tensor(float(v))

    if kind == "const":
        return F.FConst(c=t(p["value"]))
    if kind == "ramp":
        return F.FRamp(y0=t(p.get("y0", 0.0)), slope=t(p["slope"]))
    if kind == "sine":
        return F.FSine(amp=t(p["amplitude"]), freq=t(p["frequency"]),
                       phase=t(p.get("phase", 0.0)))
    raise ValueError(f"unknown profile type {kind!r}")


def build_mbs(spec: dict, dtype=torch.float32, device=None):
    """model: {bodies: [...], joints: [...], motors: [...], springs: [...]}
    → ((Model, BodyState), {name: body index}), on the card unless
    ``device`` names another."""
    from chrono_tpu_torch.physics.builder import SystemBuilder

    b = SystemBuilder(dtype=dtype, device=device)
    mspec = spec["model"]
    sim = spec.get("simulation", {})
    if "gravity" in sim:
        b.set_gravity(sim["gravity"])

    names = _name_index(mspec.get("bodies", []))
    for bd in mspec.get("bodies", []):
        b.add_body(
            mass=bd.get("mass", 1.0),
            inertia=bd.get("inertia", (1.0, 1.0, 1.0)),
            pos=bd.get("pos", (0, 0, 0)),
            rot=bd.get("rot"),
            vel=bd.get("vel", (0, 0, 0)),
            omega_local=bd.get("omega", (0, 0, 0)),
            fixed=bd.get("fixed", False),
            name=bd.get("name"),
        )

    def body_ref(v):
        return names[v] if isinstance(v, str) else int(v)

    for j in mspec.get("joints", []):
        b.add_joint(j["type"], body_ref(j["body1"]), body_ref(j["body2"]),
                    world_pos=j.get("pos", (0, 0, 0)),
                    world_axis=j.get("axis", (0, 0, 1)),
                    aux=j.get("distance", 0.0))

    adders = {
        "rotation_speed": b.add_motor_rotation_speed,
        "rotation_angle": b.add_motor_rotation_angle,
        "rotation_torque": b.add_motor_rotation_torque,
        "linear_speed": b.add_motor_linear_speed,
        "linear_position": b.add_motor_linear_position,
        "linear_force": b.add_motor_linear_force,
    }
    for m in mspec.get("motors", []):
        adders[m["type"]](body_ref(m["body1"]), body_ref(m["body2"]),
                          m.get("pos", (0, 0, 0)), m.get("axis", (0, 0, 1)),
                          _profile(m), add_joint=m.get("add_joint", True))

    for s in mspec.get("springs", []):
        b.add_tsda(body_ref(s["body1"]), body_ref(s["body2"]),
                   pa_world=s["point1"], pb_world=s["point2"],
                   k=s.get("spring_coefficient", 0.0),
                   c=s.get("damping_coefficient", 0.0),
                   rest_length=s.get("free_length"),
                   f_actuation=s.get("actuation_force", 0.0))

    return b.finalize(), names


def build_dem(spec: dict, device=None):
    """model: {type: dem, radius, density, box, material: {...},
    particles: {sampler: grid|hcp|poisson, region: [lo, hi], ...}} → a
    ``DEMSystem`` with its particles, on the card unless ``device`` names
    another."""
    from chrono_tpu_torch.dem.system import DEMSystem
    from chrono_tpu_torch.utils import samplers

    m = spec["model"]
    sim = spec.get("simulation", {})
    sys_ = DEMSystem(
        radius=m["radius"], density=m.get("density", 2500.0),
        box=(m["box"][0], m["box"][1]),
        dt=sim.get("time_step"),
        gravity=tuple(sim.get("gravity", (0, 0, -9.81))),
        friction_mode=m.get("friction_mode", "multi_step"),
        rolling_mode=m.get("rolling_mode", "none"),
        device=device,
    )
    mat = m.get("material", {})
    sys_.set_material(**mat)
    sys_.set_wall_material(**m.get("wall_material", mat))
    p = m.get("particles", {})
    sampler = p.get("sampler", "grid")
    region = p.get("region", m["box"])
    spacing = p.get("spacing", 2.1 * m["radius"])
    if sampler == "grid":
        pts = samplers.grid_sample_box(region[0], region[1], spacing,
                                       jitter=p.get("jitter", 0.0),
                                       seed=p.get("seed", 0))
    elif sampler == "hcp":
        pts = samplers.hcp_sample_box(region[0], region[1], m["radius"])
    elif sampler == "poisson":
        pts = samplers.poisson_disk_sample_box(region[0], region[1], spacing,
                                               seed=p.get("seed", 0))
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    sys_.create_particles(pts)
    return sys_


def run_spec(spec: dict, verbose: bool = True, device=None):
    """Execute a spec on the card unless ``device`` names another; returns
    the final state and writes the output files the spec asks for."""
    from chrono_tpu_torch.physics.system import SolverSettings, simulate

    sim = spec.get("simulation", {})
    h = float(sim.get("time_step", 1e-3))
    t_end = float(sim.get("end_time", 1.0))
    model_type = spec["model"].get("type", "mbs")
    out_spec = spec.get("output", {})

    if model_type == "mbs":
        (model, state), names = build_mbs(spec, device=device)
        sol = sim.get("solver", {})
        settings = SolverSettings(
            solver=sol.get("type", "direct"),
            max_iter=int(sol.get("max_iterations", 100)),
            tol=float(sol.get("tolerance", 1e-6)),
        )
        n = int(round(t_end / h))
        final, (xs, _) = simulate(model, state, h, n, settings)
        if out_spec.get("csv"):
            from chrono_tpu_torch.io.writers import CSVWriter
            cols = ["t"] + [f"{nm}_{ax}" for nm in names for ax in "xyz"]
            w = CSVWriter(out_spec["csv"], cols)
            ts = np.arange(n) * h + h
            X = xs.cpu().numpy()
            for k in range(n):
                w.append(ts[k], *X[k].reshape(-1))
            w.write()
        if verbose:
            print(f"mbs: {len(names)} bodies, {n} steps -> t={t_end}")
        return final
    if model_type == "dem":
        sys_ = build_dem(spec, device=device)
        sys_.advance(t_end)
        if out_spec.get("frames"):
            from chrono_tpu_torch.io.writers import FrameWriter
            fw = FrameWriter(out_spec["frames"])
            fw.write_frame(float(sys_.state.time), pos=sys_.positions,
                           vel=sys_.velocities)
        if verbose:
            print(f"dem: {sys_.state.n} particles -> "
                  f"t={float(sys_.state.time):.3f}")
        return sys_.state
    raise ValueError(f"unknown model type {model_type!r}")


def main(argv=None) -> int:
    """``python -m chrono_tpu_torch.run spec.yaml [--device cpu]``: run a
    spec file, on the card unless ``--device`` names another device."""
    parser = argparse.ArgumentParser(prog="python -m chrono_tpu_torch.run")
    parser.add_argument("spec", help="YAML spec file")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    run_spec(load_spec(args.spec), device=args.device)
    return 0
