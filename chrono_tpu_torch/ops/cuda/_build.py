"""Build ``csrc/<name>.cu`` with nvcc and load it with ctypes.

Each source has a plain C interface, so it compiles without PyTorch's
headers in seconds.  The shared library goes to ``chrono_tpu_torch/_build/``
(git-ignored) at first use and is rebuilt when its source is newer.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>.so``; the
    compiler's output (ptxas register and spill counts) goes to
    ``_build/<name>.log``."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
        build(name)
    return ctypes.CDLL(str(lib))
