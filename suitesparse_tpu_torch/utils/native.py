"""ctypes bridge to the native C++ analysis components (native/src/*.cc).

The reference's orderings are C (AMD/COLAMD/BTF); ours are C++ built into
one shared library, loaded via ctypes (no pybind11 in this image).  The
library is built lazily with g++ on first use; every native entry point has
a pure-Python fallback in its calling module, so the package works without
a toolchain (Status.NOT_AVAILABLE discipline).
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"


def _build() -> pathlib.Path | None:
    so = _NATIVE_DIR / "libsstpu.so"
    srcs = sorted((_NATIVE_DIR / "src").glob("*.cc"))
    if not srcs:
        return None
    if so.exists() and all(so.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return so
    # link to a private name, then rename: another process that loads the
    # library meanwhile (a test worker, the JAX package) never maps a
    # half-written file
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", str(tmp)]
            + [str(s) for s in srcs],
            check=True, capture_output=True, cwd=_NATIVE_DIR, timeout=300)
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return None


def get_lib():
    """Return the loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        c_i64 = ctypes.c_int64
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.sstpu_amd.restype = c_i64
        lib.sstpu_amd.argtypes = [c_i64, p_i64, p_i64, p_i64,
                                  ctypes.c_void_p, ctypes.c_double, c_i64]
        _register_optional(lib)
        _lib = lib
        return _lib


def _register_optional(lib):
    """Signatures for entry points that may not exist in older builds."""
    c_i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_dbl = ctypes.c_double
    p_dbl = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_dbl1 = ctypes.POINTER(ctypes.c_double)
    p_i641 = ctypes.POINTER(ctypes.c_int64)
    for name, argtypes, restype in [
        ("sstpu_etree", [c_i64, c_i64, p_i64, p_i64, c_i64, p_i64], None),
        ("sstpu_postorder", [c_i64, p_i64, p_i64], None),
        ("sstpu_colcounts", [c_i64, p_i64, p_i64, p_i64, p_i64], None),
        ("sstpu_maxtrans", [c_i64, c_i64, p_i64, p_i64, p_i64], c_i64),
        ("sstpu_colamd", [c_i64, c_i64, p_i64, p_i64, p_i64,
                          ctypes.c_double, ctypes.c_double], c_i64),
        ("sstpu_strongcomp", [c_i64, p_i64, p_i64, p_i64, p_i64], c_i64),
        ("sstpu_klu_factor",
         [c_i64, p_i64, p_i64, ctypes.c_void_p, c_dbl, c_i64, c_i64,
          p_i641, p_i641, p_i641, p_i641, p_dbl1, p_dbl1, p_dbl1],
         ctypes.c_void_p),
        ("sstpu_klu_extract",
         [ctypes.c_void_p, p_i64, p_i64, ctypes.c_void_p, p_i64, p_i64,
          ctypes.c_void_p, p_i64], None),
        ("sstpu_klu_free", [ctypes.c_void_p], None),
        ("sstpu_klu_refactor",
         [c_i64, p_i64, p_i64, ctypes.c_void_p, p_i64, p_i64, p_i64,
          ctypes.c_void_p, p_i64, p_i64, ctypes.c_void_p, c_i64], c_i64),
        ("sstpu_heavy_matching",
         [c_i64, p_i64, p_i64, p_dbl, p_i64, p_i64], c_i64),
        ("sstpu_fm_refine",
         [c_i64, p_i64, p_i64, p_dbl, p_dbl,
          np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
          c_dbl, c_dbl, c_i64], c_dbl),
        ("sstpu_amalgamate",
         [c_i64, c_i64, p_i64, p_i64, p_i64, c_i64, c_i64, c_i64,
          c_dbl, c_dbl, c_dbl, p_i64], c_i64),
        ("sstpu_edge_cut",
         [c_i64, p_i64, p_i64, p_dbl, c_dbl, c_dbl, c_i64, c_i64, c_i64,
          c_i64, c_i64, ctypes.c_uint64,
          np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")], c_dbl),
        ("sstpu_vertex_cover",
         [c_i64, c_i64, c_i64, p_i64, p_i64,
          np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
          np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")], None),
    ]:
        try:
            fn = getattr(lib, name)
        except AttributeError:
            continue
        fn.argtypes = argtypes
        fn.restype = restype


def has_native() -> bool:
    return get_lib() is not None
