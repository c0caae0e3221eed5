"""Build ``csrc/<name>.cu`` with nvcc and load it with ctypes.

Each source has a plain C interface, so it compiles without PyTorch's
headers in seconds.  The shared library goes to ``chrono_tpu_torch/_build/``
(git-ignored) at first use and is rebuilt when its source, or a header it
may include (``csrc/*.cuh``), is newer.  Nothing here runs at import time.
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


def _stale(name: str) -> bool:
    """Whether the library is missing or older than its source or any
    shared header (``csrc/*.cuh``)."""
    lib = BUILD_DIR / f"lib{name}.so"
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build_all(names) -> None:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>.so`` for each name
    whose library is missing or stale (:func:`_stale`), one nvcc process per
    source, all started together; the compiler's output (ptxas register and
    spill counts) goes to ``_build/<name>.log``."""
    stale = [name for name in names if _stale(name)]
    if not stale:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for name in stale:
        tmp = (BUILD_DIR / f"lib{name}.so").with_suffix(f".{os.getpid()}.tmp")
        jobs.append((name, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, proc in jobs:          # wait for every process first
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{err}")
            continue
        (BUILD_DIR / f"{name}.log").write_text(out + err)
        os.replace(tmp, BUILD_DIR / f"lib{name}.so")
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
