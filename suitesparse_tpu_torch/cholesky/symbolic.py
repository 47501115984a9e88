"""Cholesky symbolic analysis: ordering selection + etree + counts.

cholmod_analyze equivalent (CHOLMOD/Cholesky/cholmod_analyze.c):
  * ordering search loop over Common.cholesky.methods, keeping the ordering
    with minimum nnz(L) (cholmod_analyze.c:455,645-703)
  * default escalation policy (cholmod_analyze.c:59-69): try AMD; escalate
    to nested dissection only if fl/lnz >= 500 AND lnz/anz >= 5
  * supernodal/simplicial auto switch: supernodal iff flops/lnz >=
    supernodal_switch (default 40; cholmod_core.h:458-465)

The output Symbolic object is reusable across many numeric factorizations
with the same pattern (the 3-phase contract, SURVEY.md §1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC, SYM_UPPER, invert_permutation
from ..core.status import SparseError, Status
from ..graph import chol_symbolic_flops, col_counts, etree, postorder
from ..ordering import amd
from ..utils.trace import span


def _force_upper(A: SparseCSC) -> SparseCSC:
    """Canonical upper-triangular symmetric view of the input."""
    if A.nrow != A.ncol:
        raise SparseError(Status.INVALID, "cholesky needs a square matrix")
    U = A.triu(0)
    U.stype = SYM_UPPER
    return U


@dataclasses.dataclass
class Symbolic:
    """Reusable symbolic factorization (cholmod_factor symbolic part)."""

    n: int
    perm: np.ndarray            # fill-reducing permutation (perm[k] = pivot k)
    parent: np.ndarray          # etree of the permuted matrix
    post: np.ndarray            # postorder of the etree
    colcount: np.ndarray        # nnz per column of L (incl. diagonal)
    lnz: int                    # total nnz(L)
    flops: float                # LL' flop count (sum cc^2)
    anz: int                    # nnz(tril(A))
    method: str                 # ordering method chosen
    is_super: bool              # supernodal numeric path selected
    supernodes: Optional[object] = None   # filled by super_symbolic

    @property
    def fill_ratio(self) -> float:
        return self.lnz / max(self.anz, 1)

    @property
    def flops_per_lnz(self) -> float:
        return self.flops / max(self.lnz, 1)


def analyze_ordering(A_upper: SparseCSC, perm: np.ndarray) -> tuple:
    """cholmod_analyze_ordering (cholmod_analyze.c:312-365): permute, etree,
    postorder, counts for a candidate permutation."""
    P = A_upper.symperm(perm, values=False)
    parent = etree(P)
    post = postorder(parent)
    cc = col_counts(P, parent, post)
    return parent, post, cc


def analyze(A: SparseCSC, common: Optional[Common] = None,
            perm: Optional[np.ndarray] = None) -> Symbolic:
    """cholmod_analyze: choose an ordering and build the symbolic factor.
    The call is the span ``cholesky.analyze`` (utils/trace); cm.info's
    ``analyze_time`` and ``time_analyze`` hold its seconds."""
    cm = common or default_common()
    with span("cholesky.analyze") as sp:
        sym = _analyze(A, cm, perm)
    cm.info["analyze_time"] = sp.seconds
    cm.info["time_analyze"] = cm.info.get("time_analyze", 0.0) + sp.seconds
    return sym


def _analyze(A: SparseCSC, cm: Common, perm) -> Symbolic:
    cm.checkpoint("analyze")
    opts = cm.cholesky
    from ..core.sparse import sym_upper_view
    U = sym_upper_view(A)
    n = U.ncol
    anz = U.nnz

    candidates: list[tuple[str, Optional[np.ndarray]]] = []
    if perm is not None:
        candidates.append(("given", np.ascontiguousarray(perm, dtype=INDEX)))
    elif opts.methods:
        for m in opts.methods:
            candidates.append((m, None))
    else:
        candidates.append(("amd", None))

    best = None
    for method, p0 in candidates:
        if method == "given":
            p = p0
        elif method == "natural":
            p = np.arange(n, dtype=INDEX)
        elif method == "amd":
            p = amd(U, cm)
        elif method == "nesdis":
            from ..ordering.nesdis import nested_dissection
            p = nested_dissection(U, cm)
        else:
            raise SparseError(Status.INVALID, f"unknown ordering method {method}")
        parent, post, cc = analyze_ordering(U, p)
        lnz = int(cc.sum())
        fl = chol_symbolic_flops(cc)
        if best is None or lnz < best[4]:
            best = (method, p, parent, post, lnz, cc, fl)

    method, p, parent, post, lnz, cc, fl = (
        best[0], best[1], best[2], best[3], best[4], best[5], best[6])

    # default escalation: AMD result bad enough -> try nested dissection
    # (cholmod_analyze.c:59-69 thresholds)
    if (not opts.methods and perm is None and method == "amd"
            and fl / max(lnz, 1) >= opts.nd_flops_per_lnz
            and lnz / max(anz, 1) >= opts.nd_fill_ratio):
        try:
            from ..ordering.nesdis import nested_dissection
            p2 = nested_dissection(U, cm)
            parent2, post2, cc2 = analyze_ordering(U, p2)
            lnz2 = int(cc2.sum())
            if lnz2 < lnz:
                method, p, parent, post, cc = "nesdis", p2, parent2, post2, cc2
                lnz, fl = lnz2, chol_symbolic_flops(cc2)
        except ImportError:
            pass

    # supernodal switch (cholmod_core.h:458-465)
    if opts.supernodal == "supernodal":
        is_super = True
    elif opts.supernodal == "simplicial":
        is_super = False
    else:
        is_super = fl / max(lnz, 1) >= opts.supernodal_switch

    sym = Symbolic(n=n, perm=p, parent=parent, post=post, colcount=cc,
                   lnz=lnz, flops=fl, anz=anz, method=method,
                   is_super=is_super)
    cm.info.update({"ordering": method, "lnz": lnz, "anz": anz,
                    "fl": fl, "fl_per_lnz": fl / max(lnz, 1),
                    "lnz_per_anz": lnz / max(anz, 1),
                    "supernodal": is_super})
    cm.status = Status.OK
    return sym
