"""The port never imports JAX or the JAX package.

Every module of ``chrono_tpu_torch/`` and ``chip_smoke.py`` runs on a
machine that has no JAX.  Each file's syntax tree is walked, so an import
inside a function, which an import-time check would miss, fails too.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix() for p in
               (ROOT / "chrono_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
BANNED = ("jax", "jaxlib", "chrono_tpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def banned_imports(source: str):
    return sorted({name for name in _imports(ast.parse(source))
                   if name.split(".")[0] in BANNED})


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    assert banned_imports((ROOT / path).read_text()) == []


def test_guard_catches_hidden_imports():
    src = ("import torch\n"
           "def f():\n"
           "    import jax.numpy as jnp\n"
           "    from chrono_tpu.fsi import sph\n"
           "    return importlib.import_module('chrono_tpu.dem')\n"
           "from chrono_tpu_torch import convert\n")
    assert banned_imports(src) == ["chrono_tpu.dem", "chrono_tpu.fsi",
                                   "jax.numpy"]


def test_guard_walks_the_whole_port():
    assert "chrono_tpu_torch/ops/cuda/sph_substep.py" in FILES
    assert "chrono_tpu_torch/fsi/sph/pencil.py" in FILES
    for module in ("core/quaternion", "core/functions", "core/dual",
                   "physics/system", "physics/builder", "physics/shafts",
                   "solver/direct", "solver/descriptor", "vehicle/driver",
                   "vehicle/powertrain", "vehicle/tire", "vehicle/terrain",
                   "vehicle/wheeled", "vehicle/closed_loop", "vehicle/dbp",
                   "models/hmmwv", "models/decks", "models/rover"):
        assert f"chrono_tpu_torch/{module}.py" in FILES
    assert len(FILES) >= 20


@pytest.mark.parametrize("script", ["kernel_turns.py", "mbs_host_cost.py"])
def test_turn_probe_imports_no_jax(script):
    """The port's measuring scripts beside ``chip_smoke.py`` import nothing
    of JAX either."""
    assert banned_imports((ROOT / script).read_text()) == []
