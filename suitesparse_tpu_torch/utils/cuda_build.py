"""Build the port's CUDA sources (``csrc/*.cu``) into shared libraries with
a plain C interface, load them with ctypes, and launch their entry points:
the one launch route of every kernel of the port.

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/lib<name>-<hash>.so`` at the repository root (a directory
that ``.gitignore`` lists).  The file name carries a hash of the source and
of the headers in ``csrc/``, so an edited source is rebuilt and a stale
library is never loaded.  Nothing here runs at import time: the first call
that needs a kernel builds it.

A wrapper launches a kernel with ``launch(entry, tensor, *args)``: the
entry point's argument types are bound once, from ``ENTRY_POINTS``, and
every call passes the tensor's device index and PyTorch's current stream on
that device last (``csrc/launch.cuh``: the C side switches device only when
it must, and returns a cudaError_t).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Every entry point of the kernel libraries: its source (csrc/<lib>.cu) and
# its leading arguments, "p" a pointer and "i" an int.  Each also takes the
# device index (int) and the stream (a pointer) last, and returns an int.
ENTRY_POINTS = {
    "sstpu_block_chol_f32": ("block_chol", "pppii"),
    "sstpu_block_chol_f64": ("block_chol", "pppii"),
    "sstpu_bcsr_spmm_f32": ("bcsr_spmm", "ppppiiiii"),
    "sstpu_scale_blocks_f32": ("dispatch_probe", "ppi"),
    "sstpu_scale_gather_f32": ("dispatch_probe", "pppii"),
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_bound: dict[str, tuple] = {}
# the raw handle of the current stream on a device, without building a
# torch.cuda.Stream (the public call where torch has no private one)
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda dev: torch.cuda.current_stream(dev).cuda_stream)


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
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


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


def argtypes(entry: str) -> list:
    """The ctypes argument types of an entry point, device and stream
    included: ``c_void_p`` for every pointer and the stream (an int would
    cut a 64-bit address to 32 bits), ``c_int`` for every int."""
    return ([_CTYPES[k] for k in ENTRY_POINTS[entry][1]]
            + [ctypes.c_int, ctypes.c_void_p])


def bind(entry: str) -> tuple:
    """(function, error string) of an entry point, its argument types bound
    once; builds and loads its library on first use."""
    got = _bound.get(entry)
    if got is None:
        lib = load(ENTRY_POINTS[entry][0])
        fn = getattr(lib, entry)
        fn.argtypes = argtypes(entry)
        fn.restype = ctypes.c_int
        err = lib.sstpu_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        got = _bound[entry] = (fn, err)
    return got


def launch(entry: str, t: torch.Tensor, *args) -> None:
    """Launch ``entry`` with ``args`` (the leading arguments of its row in
    ENTRY_POINTS, pointers as ints) on the device of ``t`` and PyTorch's
    current stream there.  Raises ValueError when ``t`` is not a CUDA
    tensor, RuntimeError with the library's error string when the launch
    fails."""
    if not t.is_cuda:
        raise ValueError(f"{entry}: a kernel launches on a CUDA tensor, not "
                         f"on one on {t.device}")
    fn, err_string = _bound.get(entry) or bind(entry)
    dev = t.get_device()
    err = fn(*args, dev, raw_stream(dev))
    if err:
        raise RuntimeError(f"{entry}: kernel launch failed: "
                           + err_string(err).decode())
