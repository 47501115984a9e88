"""The one traffic generator: a mix's parameters (``mixes/<mix>.json``)
and the run's seed give the pools that the window cycles through.

Parameters of a mix (the pools' keys may be left out: their defaults
follow in brackets):

step          the name of the step each window iteration runs: the
              configuration's front end (``solvers/<solver>.py``) does it
              in its method ``step_<step>(pools, i)``.
setup         the steps set-up runs once each, in order, before the window
              (a list of step names): they warm every shape the window uses.
trace_steps   steps of the traced window (``--trace 1``).
value_sets    [1] value sets made from the configuration's matrix: each
              off-diagonal entry is multiplied by a factor drawn uniformly
              from ``offdiag_scale`` ([1, 1]), an entry and its mirror by
              the same factor where the matrix is symmetric; each diagonal
              entry is then set so that its row keeps the original matrix's
              diagonal excess (diagonal - sum of |off-diagonals|), so a
              diagonally dominant matrix stays so (and an SPD one SPD).
rhs_pool      [16] right-hand sides drawn from N(0, 1), float64,
rhs_width     [1] columns each (width 1: one vector).

A mix may hold further keys for its step to read (``pools.mix``).  Every seed gives the
same number and sizes of sets and right-hand sides; only their values
change.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

REQUIRED = ("step", "setup", "trace_steps")
DEFAULTS = dict(value_sets=1, offdiag_scale=[1.0, 1.0], rhs_pool=16,
                rhs_width=1)


@dataclasses.dataclass
class Pools:
    values: list            # data arrays on the matrix's CSC pattern
    rhs: np.ndarray         # (rhs_pool, n) or (rhs_pool, n, width) float64
    mix: dict               # the mix, for the keys its step reads

    def step(self, i: int) -> tuple:
        """(value set, right-hand side) of window step i: the sets cycle
        from the second on (set-up's step, i = -1, takes the first), the
        right-hand sides from the first."""
        return (i + 1) % len(self.values), i % len(self.rhs)


def full(mix: dict, name: str) -> dict:
    """The mix with its defaults filled in, checked."""
    missing = [k for k in REQUIRED if k not in mix]
    if missing:
        raise ValueError(f"mix {name}: missing {missing}")
    mix = {**DEFAULTS, **mix}
    lo, hi = mix["offdiag_scale"]
    if not (0 < lo <= hi and mix["value_sets"] >= 1 and mix["rhs_pool"] >= 1
            and mix["rhs_width"] >= 1 and mix["trace_steps"] >= 1
            and isinstance(mix["setup"], list)):
        raise ValueError(f"mix {name}: parameters out of range")
    return mix


def _twins(A: sp.csc_matrix):
    """Rows, the entries off the diagonal, for each of them the index of
    the factor it draws (its upper twin's where A is symmetric, its own
    where not), and the number of factors."""
    n = A.shape[0]
    col = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    row = A.indices.astype(np.int64)
    off = np.flatnonzero(row != col)
    if (abs(A - A.T) > 0).nnz:
        return row, off, np.arange(len(off)), len(off)
    upper = np.flatnonzero(row < col)
    key_u = row[upper] * n + col[upper]
    order = np.argsort(key_u)
    key = np.minimum(row[off], col[off]) * n + np.maximum(row[off], col[off])
    pos = np.searchsorted(key_u[order], key)
    if np.any(pos >= len(order)) or np.any(key_u[order][
            np.minimum(pos, len(order) - 1)] != key):
        raise ValueError("the matrix's pattern is not symmetric")
    return row, off, order[pos], len(upper)


def value_sets(A: sp.csc_matrix, count: int, scale, rng) -> list:
    """``count`` value sets on A's pattern (A square; a symmetric one
    stored in full)."""
    row, off, twin, nf = _twins(A)
    diag = np.flatnonzero(row == np.repeat(np.arange(A.shape[0]),
                                           np.diff(A.indptr)))
    n = A.shape[0]
    absoff = np.bincount(row[off], weights=np.abs(A.data[off]), minlength=n)
    excess = np.zeros(n)
    excess[row[diag]] = A.data[diag]
    excess -= absoff
    lo, hi = scale
    out = []
    for _ in range(count):
        f = rng.uniform(lo, hi, nf)
        data = A.data.astype(np.float64).copy()
        data[off] *= f[twin]
        s = np.bincount(row[off], weights=np.abs(data[off]), minlength=n)
        data[diag] = s[row[diag]] + excess[row[diag]]
        out.append(data)
    return out


def make_pools(A: sp.csc_matrix, mix: dict, seed: int) -> Pools:
    mix = full(mix, "")
    rng = np.random.default_rng(seed)
    values = value_sets(A, mix["value_sets"], mix["offdiag_scale"], rng)
    n, k = A.shape[0], mix["rhs_width"]
    shape = (mix["rhs_pool"], n) if k == 1 else (mix["rhs_pool"], n, k)
    rhs = rng.standard_normal(shape)
    return Pools(values=values, rhs=rhs, mix=mix)
