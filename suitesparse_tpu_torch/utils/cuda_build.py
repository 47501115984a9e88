"""Build the port's CUDA sources (``csrc/*.cu``) into shared libraries with
a plain C interface and load them with ctypes.

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/lib<name>-<hash>.so`` at the repository root (a directory
that ``.gitignore`` lists).  The file name carries a hash of the source, so
an edited source is rebuilt and a stale library is never loaded.  Nothing
here runs at import time: the first call that needs a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's compiler")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path.  The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``<name>.log``."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent loader never
    # sees a half-written library
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cu")], capture_output=True,
                         text=True, timeout=900)
    log = res.stdout + res.stderr
    (BUILD_DIR / f"{name}.log").write_text(log)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, path)
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
