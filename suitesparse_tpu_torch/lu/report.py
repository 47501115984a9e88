"""umfpack_report_* family equivalents: human-readable summaries routed
through Common.print_func (umfpack_report_status/info/control/symbolic/
numeric/matrix/vector/perm, UMFPACK/Include)."""
from __future__ import annotations

import numpy as np

from ..core.common import Common, default_common


def report_status(common: Common) -> None:
    common.print_func(f"status: {common.status.name}")


def report_control(common: Common) -> None:
    lu = common.lu
    common.print_func(
        "umf control: strategy=%s pivot_tol=%g sym_pivot_tol=%g scale=%s "
        "refine_steps=%d" % (lu.strategy, lu.pivot_tol, lu.sym_pivot_tol,
                             lu.scale, lu.refine_steps))


def report_info(common: Common) -> None:
    for k, v in sorted(common.info.items()):
        if k.startswith("umf_") or k in ("lnz", "anz", "fl"):
            common.print_func(f"  {k}: {v}")


def report_symbolic(S, common=None) -> None:
    cm = common or default_common()
    if S.singles is not None:
        nb = len(S.singles.r) - 1
        n1 = sum(1 for s in S.singles.subs if s is None)
        cm.print_func(f"umf symbolic: n={S.n} strategy=btf blocks={nb} "
                      f"singletons={n1} sym={S.sym_ratio:.3f} "
                      f"nzdiag={S.nzdiag}")
        return
    cm.print_func(f"umf symbolic: n={S.n} strategy={S.strategy} "
                  f"sym={S.sym_ratio:.3f} nzdiag={S.nzdiag} "
                  f"nsuper={S.ss.nsuper} levels={len(S.plan.levels)} "
                  f"packed={S.plan.total}")


def report_numeric(num, common=None) -> None:
    cm = common or default_common()
    if num.bnums is not None:
        cm.print_func(f"umf numeric: dtype={np.dtype(num.dtype).name} "
                      f"singular={num.singular} "
                      f"blocks={len(num.bnums)}")
        return
    cm.print_func(f"umf numeric: dtype={np.dtype(num.dtype).name} "
                  f"singular={num.singular} panels={int(num.Lb.shape[0]) - 1}")


def report_perm(p, common=None) -> None:
    cm = common or default_common()
    ok = sorted(np.asarray(p).tolist()) == list(range(len(p)))
    cm.print_func(f"perm: length {len(p)} valid={ok}")


def report_vector(x, common=None) -> None:
    cm = common or default_common()
    x = np.asarray(x)
    cm.print_func(f"vector: len={len(x)} norm_inf={np.abs(x).max():.6g} "
                  f"finite={bool(np.isfinite(x).all())}")


def report_matrix(A, common=None) -> None:
    from ..core.check import print_sparse
    print_sparse(A, "A", common)
