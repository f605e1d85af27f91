"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library that ``ctypes``
loads; nothing includes PyTorch's headers, so a build takes seconds.
The library lands in ``build/mxnet_tpu_torch/`` beside the package's
parent directory (the repository's ``build/``, which git ignores). Its
file name carries a hash of the source and the flags, so a stale build
is never loaded. Builds happen at first use, from the sources in the
package; :func:`build_all` starts one ``nvcc`` per source at once.

There is no fallback: a missing ``nvcc`` or a failing build raises
with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

__all__ = ["SOURCES", "build_all", "load", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mxnet_tpu_torch"
SOURCES = ("conv_epilogue",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit PyTorch finds (``$CUDA_HOME``,
    ``$CUDA_PATH``, ``nvcc`` on ``PATH``, the toolkit's default prefix);
    raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else ""
    if path and os.path.isfile(path) and os.access(path, os.X_OK):
        return path
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target)."""
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name, proc, tmp, target) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"nvcc failed building {name} "
                         f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)        # atomic: readers never see half a file
    return out


def build_all(names=SOURCES) -> dict:
    """Build every named kernel that has no current library, all nvcc
    processes running at once. Returns {name: compiler output} for the
    sources it built (ptxas's register and spill report among it)."""
    with _lock:
        todo = [n for n in names if not _target(n).exists()]
        started = [(n, *_start(n)) for n in todo]
        return {n: _finish(n, proc, tmp, target)
                for n, proc, tmp, target in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first when needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
