"""Genuine SuiteSparse test/benchmark matrices bundled with the reference.

Counterpart of suitesparse_tpu/io/fixtures.py, copied; the one change is
where the SuiteSparse checkout is looked for by default (``reference``
under the home directory, not an absolute path).

The reference ships real matrices from the SuiteSparse Collection inside
its per-package test directories (SURVEY.md §4: CSparse/Matrix, KLU/Matrix,
CHOLMOD/Demo/Matrix, SPQR/Matrix, Mongoose/Matrix, UMFPACK/Demo/HB).  This
module resolves those files by their collection names so tests and
benchmarks run on the *actual* matrices the reference's demos use —
never a synthetic stand-in served under a real matrix's name.

The reference checkout is located via ``SSTPU_REFERENCE`` (default
``~/reference`` when present).  Loaders: MatrixMarket (.mtx),
Rutherford-Boeing (.rsa/.rua/.rra), and CSparse's whitespace triplet
format (``cs_load``, reference CSparse/Source/cs_load.c: zero-based
"i j x" lines).
"""
from __future__ import annotations

import os
import pathlib
from typing import Optional

import numpy as np

from ..core.sparse import SparseCSC
from .matrixmarket import mmread
from .rbio import rbread


def reference_root() -> Optional[pathlib.Path]:
    p = pathlib.Path(os.environ.get("SSTPU_REFERENCE",
                                    os.path.expanduser("~/reference")))
    return p if p.is_dir() else None


def load_triplet(path: str, dtype=np.float64,
                 detect_sym: bool = False) -> SparseCSC:
    """CSparse cs_load format: zero-based 'row col value' per line
    (reference CSparse/Source/cs_load.c, cs_entry accumulation of dups).

    detect_sym: mark a square lower-triangular-pattern load as SYM_LOWER
    (cs_demo's is_sym heuristic, cs_demo.c:30-45).  Off by default so a
    genuinely triangular unsymmetric matrix is never silently symmetrized
    (round-4 advisor finding); :func:`load` enables it only for the known
    symmetric fixture names."""
    import scipy.sparse as sp
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if data.size == 0:
        raise ValueError(f"empty triplet file {path}")
    i = data[:, 0].astype(np.int64)
    j = data[:, 1].astype(np.int64)
    x = data[:, 2].astype(dtype) if data.shape[1] > 2 else np.ones(len(i), dtype)
    m, n = int(i.max()) + 1, int(j.max()) + 1
    A = sp.coo_matrix((x, (i, j)), shape=(m, n)).tocsc()
    A.sum_duplicates()
    out = SparseCSC.from_scipy(A)
    # CSparse's symmetric demo matrices (bcsstk16 et al.) store only the
    # lower triangle in the triplet file; cs_demo detects this (is_sym,
    # cs_demo.c:30-45) and works on A+A'.  Mark such matrices as
    # symmetric-lower so sym_upper_view & friends see the full pattern —
    # round-4 regression find: triu() of a lower-only stype-0 matrix is
    # just the diagonal, which silently made fixture tests vacuous.
    if detect_sym and m == n and out.nnz:
        col = np.repeat(np.arange(n, dtype=np.int64), np.diff(out.indptr))
        if np.all(out.indices >= col):
            from ..core.sparse import SYM_LOWER
            out.stype = SYM_LOWER
    return out


# triplet-format fixtures known to be symmetric lower-only storage (the
# CSparse symmetric demo set, cs_demo.c is_sym candidates)
_SYM_TRIPLET = {"bcsstk01", "bcsstk02", "bcsstk16"}


# name -> path fragment under the reference root (first hit wins)
_FIXTURES = {
    # SPD / symmetric (Cholesky class)
    "bcsstk01": ["CHOLMOD/Demo/Matrix/bcsstk01.rsa", "CSparse/Matrix/bcsstk01"],
    "bcsstk02": ["CHOLMOD/Demo/Matrix/bcsstk02.rsa"],
    "bcsstk16": ["CSparse/Matrix/bcsstk16"],
    "dwt_992": ["Mongoose/Matrix/dwt_992.mtx"],
    "jagmesh7": ["Mongoose/Matrix/jagmesh7.mtx"],
    "can___24": ["CHOLMOD/Demo/Matrix/can___24.mtx"],
    "LFAT5": ["SPQR/Matrix/LFAT5.mtx"],
    # unsymmetric (UMFPACK/KLU class)
    "west0067": ["UMFPACK/Demo/HB/west0067.rua", "CSparse/Matrix/west0067",
                 "KLU/Matrix/west0067.mtx"],
    "west0479": ["RBio/RBio/private/west0479.rua"],
    "arc130": ["UMFPACK/Demo/HB/arc130.rua"],
    "fs_183_6": ["UMFPACK/Demo/HB/fs_183_6.rua"],
    "fs_183_1": ["CSparse/Matrix/fs_183_1"],
    "impcol_a": ["KLU/Matrix/impcol_a.mtx"],
    "ctina": ["KLU/Matrix/ctina.mtx"],
    "w156": ["KLU/Matrix/w156.mtx"],
    "1c": ["KLU/Matrix/1c.mtx"],
    "arrowc": ["KLU/Matrix/arrowc.mtx"],
    "GD99_cc": ["KLU/Matrix/GD99_cc.mtx"],
    "mbeacxc": ["CSparse/Matrix/mbeacxc"],
    "ibm32a": ["CSparse/Matrix/ibm32a"],
    "ibm32b": ["CSparse/Matrix/ibm32b"],
    "t1": ["CSparse/Matrix/t1"],
    # least squares (SPQR class)
    "ash219": ["CSparse/Matrix/ash219", "SPQR/Matrix/ash219.mtx"],
    "lp_afiro": ["CSparse/Matrix/lp_afiro", "CHOLMOD/Demo/Matrix/lp_afiro.rra"],
    "lp_e226": ["SPQR/Matrix/lp_e226.mtx"],
    "lp_e226_transposed": ["SPQR/Matrix/lp_e226_transposed.mtx"],
    "Franz6_id1959_aug": ["SPQR/Matrix/Franz6_id1959_aug.mtx"],
    "Groebner_id2003_aug": ["SPQR/Matrix/Groebner_id2003_aug.mtx"],
    "young1c": ["SPQR/Matrix/young1c.mtx"],   # complex
    # graphs (Mongoose/GraphBLAS class)
    "Erdos971": ["Mongoose/Matrix/Erdos971.mtx"],
    "G51": ["Mongoose/Matrix/G51.mtx"],
    "Pd": ["Mongoose/Matrix/Pd.mtx"],
    "bcspwr10": ["Mongoose/Matrix/bcspwr10.mtx"],
}


def available() -> list[str]:
    """Names of genuine reference fixtures resolvable on this machine."""
    root = reference_root()
    if root is None:
        return []
    out = []
    for name, cands in _FIXTURES.items():
        if any((root / c).exists() for c in cands):
            out.append(name)
    return sorted(out)


def load(name: str, dtype=np.float64) -> SparseCSC:
    """Load a genuine reference fixture by collection name."""
    root = reference_root()
    if root is None:
        raise FileNotFoundError(
            "no reference checkout (set SSTPU_REFERENCE) — genuine fixture "
            f"{name!r} unavailable")
    cands = _FIXTURES.get(name)
    if cands is None:
        raise KeyError(f"{name!r} is not a known reference fixture; "
                       f"known: {sorted(_FIXTURES)}")
    for c in cands:
        p = root / c
        if p.exists():
            if p.suffix == ".mtx":
                return mmread(str(p))
            if p.suffix in (".rsa", ".rua", ".rra", ".rb"):
                return rbread(str(p))
            return load_triplet(str(p), dtype,
                                detect_sym=name in _SYM_TRIPLET)
    raise FileNotFoundError(f"fixture {name!r}: none of {cands} exist "
                            f"under {root}")
