"""Build ``csrc/<name>.cu`` with nvcc and load it with ctypes.

Each source has a plain C interface, so it compiles without PyTorch's
headers in seconds.  The shared library goes to ``chrono_tpu_torch/_build/``
(git-ignored) at first use and is rebuilt when its source, or a header it
may include (``csrc/*.cuh``), is newer.  Nothing here runs at import time.

A build may carry preprocessor defines, such as ``PAIR_COUNTERS``, the
counter build of the pair walks (``csrc/cell_pairs.cuh``): its library is
``lib<name>-<DEFINE>….so`` beside the default one, and :func:`load`
returns it inside :func:`variant`.
"""

from __future__ import annotations

import contextlib
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
# the defines of the libraries that load() returns (see variant())
DEFINES: tuple = ()


@contextlib.contextmanager
def variant(*defines: str):
    """Inside the block, :func:`load` returns the libraries built with
    ``-D`` of each of ``defines``; the wrappers bind them per variant."""
    global DEFINES
    saved, DEFINES = DEFINES, tuple(defines)
    try:
        yield
    finally:
        DEFINES = saved


def lib_path(name: str, defines: tuple = ()) -> Path:
    return BUILD_DIR / ("lib" + "-".join((name, *defines)) + ".so")


def log_path(name: str, defines: tuple = ()) -> Path:
    """The compiler's output (ptxas registers and spills) of a build."""
    return BUILD_DIR / ("-".join((name, *defines)) + ".log")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _stale(name: str, defines: tuple = ()) -> bool:
    """Whether the library is missing or older than its source or any
    shared header (``csrc/*.cuh``)."""
    lib = lib_path(name, defines)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build_all(jobs) -> None:
    """Compile ``csrc/<name>.cu`` into :func:`lib_path` for each job (a
    name, or a ``(name, defines)`` pair) whose library is missing or stale
    (:func:`_stale`), one nvcc process per library, all started together;
    the compiler's output goes to :func:`log_path`."""
    jobs = [(j, ()) if isinstance(j, str) else (j[0], tuple(j[1]))
            for j in jobs]
    stale = [(name, defs) for name, defs in jobs if _stale(name, defs)]
    if not stale:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for name, defs in stale:
        lib = lib_path(name, defs)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, defs, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defs), "-o",
             str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, defs, tmp, proc in procs:   # wait for every process first
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu {defs}:\n{err}")
            continue
        log_path(name, defs).write_text(out + err)
        os.replace(tmp, lib_path(name, defs))
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with :data:`DEFINES`,
    built first if needed."""
    return _load(name, DEFINES)


@functools.cache
def _load(name: str, defines: tuple) -> ctypes.CDLL:
    build_all([(name, defines)])
    return ctypes.CDLL(str(lib_path(name, defines)))
