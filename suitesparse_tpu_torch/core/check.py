"""Validation + diagnostic printing (CHOLMOD/Check equivalents).

Reference: cholmod_check_* / cholmod_print_* for every object type with 4
print levels routed through a pluggable printf (cholmod_check.c;
SuiteSparse_config printf_func).  Our print routing goes through
Common.print_func / Common.print_level.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .common import Common, default_common
from .sparse import SparseCSC, Triplet


def check_sparse(A: SparseCSC) -> bool:
    """cholmod_check_sparse."""
    return A.check()


def check_triplet(t: Triplet) -> bool:
    """cholmod_check_triplet."""
    if len(t.row) != len(t.col):
        return False
    if t.data is not None and len(t.data) != len(t.row):
        return False
    if t.nnz and (t.row.min() < 0 or t.row.max() >= t.shape[0]
                  or t.col.min() < 0 or t.col.max() >= t.shape[1]):
        return False
    return True


def check_perm(p, n: Optional[int] = None) -> bool:
    """cholmod_check_perm."""
    p = np.asarray(p)
    n = n if n is not None else len(p)
    return len(p) == n and np.array_equal(np.sort(p), np.arange(n))


def check_parent(parent) -> bool:
    """cholmod_check_parent: a valid etree has parent[j] > j or -1."""
    parent = np.asarray(parent)
    j = np.arange(len(parent))
    return bool(np.all((parent == -1) | (parent > j)))


def check_factor(f) -> bool:
    """cholmod_check_factor (simplicial Factor)."""
    if not check_perm(f.perm, f.n):
        return False
    if f.Lp[0] != 0 or np.any(np.diff(f.Lp) < 0):
        return False
    for j in range(f.n):
        lo, hi = int(f.Lp[j]), int(f.Lp[j + 1])
        if hi <= lo or f.Li[lo] != j:        # diagonal first
            return False
        if np.any(np.diff(f.Li[lo:hi]) <= 0):
            return False
    return True


def print_sparse(A: SparseCSC, name: str = "A",
                 common: Optional[Common] = None) -> None:
    """cholmod_print_sparse: detail scales with Common.print_level (0-4)."""
    cm = common or default_common()
    lvl = cm.print_level
    if lvl <= 0:
        return
    stype = {0: "unsymmetric", 1: "symmetric-upper", -1: "symmetric-lower"}
    cm.print_func(f"{name}: {A.nrow}-by-{A.ncol}, nnz {A.nnz}, "
                  f"{stype.get(np.sign(A.stype), '?')}, "
                  f"dtype {A.dtype}, sorted={A.sorted}, "
                  f"ok={A.check()}")
    if lvl >= 3:
        t = A.to_triplet()
        shown = t.nnz if lvl >= 4 else min(t.nnz, 10)
        for k in range(shown):
            v = t.data[k] if t.data is not None else 1
            cm.print_func(f"  ({t.row[k]},{t.col[k]})  {v:.6g}")
        if shown < t.nnz:
            cm.print_func(f"  ... ({t.nnz - shown} more)")


def print_factor(f, name: str = "L", common: Optional[Common] = None) -> None:
    """cholmod_print_factor."""
    cm = common or default_common()
    if cm.print_level <= 0:
        return
    kind = "LL'" if f.is_ll else "LDL'"
    cm.print_func(f"{name}: {kind} factor, n={f.n}, nnz(L)={int(f.Lp[-1])}, "
                  f"minor={f.minor} ({'ok' if f.ok else 'NOT POSDEF'})")


def print_perm(p, name: str = "perm", common: Optional[Common] = None) -> None:
    cm = common or default_common()
    if cm.print_level <= 0:
        return
    ok = check_perm(p)
    cm.print_func(f"{name}: length {len(p)}, valid={ok}")


def print_common(common: Common) -> None:
    """cholmod_print_common: option + Info dump."""
    cm = common
    cm.print_func(f"Common: status={cm.status.name} print_level={cm.print_level}")
    cm.print_func(f"  cholesky: supernodal={cm.cholesky.supernodal} "
                  f"switch={cm.cholesky.supernodal_switch} "
                  f"nrelax={cm.cholesky.nrelax} zrelax={cm.cholesky.zrelax}")
    cm.print_func(f"  lu: strategy={cm.lu.strategy} pivot_tol={cm.lu.pivot_tol} "
                  f"btf={cm.lu.btf} scale={cm.lu.scale}")
    for k, v in cm.info.items():
        if not k.startswith("_"):
            cm.print_func(f"  info.{k} = {v}")
