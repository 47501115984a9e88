"""The work of the UMF LU program's fronts, from the symbolic's unpadded
supernode sizes: a front of k columns with m rows below them factors its
k x k diagonal block (2/3 k^3 flops), solves the two k-wide triangles
against the m rows below and the m columns beside (2 m k^2) and forms the
m x m update (2 m^2 k).  It reads the k^2 + 2 m k values of its front and
writes them factored, and writes the m^2 update.  Counted on the unpadded
sizes, the work is the same whatever buckets, padding or kernels carry
it."""
from __future__ import annotations

import numpy as np

from . import counts


def lu_front_flops(cols, rows_below) -> np.ndarray:
    """Operations of each front's LU, triangular solves and update."""
    k = np.asarray(cols, dtype=np.float64)
    m = np.asarray(rows_below, dtype=np.float64)
    return 2.0 / 3.0 * k ** 3 + 2.0 * m * k ** 2 + 2.0 * m ** 2 * k


def lu_front_bytes(cols, rows_below, itemsize: int = 4) -> np.ndarray:
    """Bytes of each front: its values read once and written once, and its
    update written once."""
    k = np.asarray(cols, dtype=np.float64)
    m = np.asarray(rows_below, dtype=np.float64)
    return (2.0 * (k * k + 2.0 * m * k) + m * m) * itemsize


def lu_front_least_s(cols, rows_below, itemsize: int = 4) -> float:
    """The least time the card could take for every front: per front the
    larger of its operations over the float32 peak and its bytes over the
    HBM peak."""
    return float(np.maximum(
        lu_front_flops(cols, rows_below) / counts.PEAK_FLOPS_F32,
        lu_front_bytes(cols, rows_below, itemsize)
        / counts.PEAK_HBM_BYTES).sum())
