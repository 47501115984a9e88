"""The yardstick's constants and counts: the H100's datasheet peaks, the
operations and bytes of one ``block_chol`` launch, and the launches of one
pf factor by shape.

The launch count follows ``suitesparse_tpu_torch.cholesky.pf.block_chol_shapes``
(copied, so that the benchmark keeps its own arithmetic); the harness checks
it against the ``block_chol`` kernels it finds in the trace and reports no
roofline where the two disagree.
"""
from __future__ import annotations

import numpy as np

# H100 SXM datasheet peaks at 700 W, dense: float32 outside the tensor
# cores (FLOP/s) and HBM3 (bytes/s)
PEAK_FLOPS_F32 = 67e12
PEAK_HBM_BYTES = 3.35e12
# a share of a peak above this means the counts or the time are wrong
PEAK_MARGIN = 1.05

# block_chol takes one launch per 128-wide slab of a diagonal block
BLOCK_CHOL_SLAB = 128


def block_chol_shapes(fmeta, instr_cls, potrf_maxnp: int) -> dict:
    """{(W, Np): launches} of block_chol in one pf factor, from the plan's
    factor classes (``fmeta[c] = (Np, Mb, W, ...)``) and the class of each
    instruction (``instr_cls``; ids past the factor classes are pair
    projections).  A factor class with Np <= ``potrf_maxnp`` launches once
    per 128-wide slab, or once when it has fewer columns."""
    nf = len(fmeta)
    shapes: dict = {}
    for cid in np.asarray(instr_cls).tolist():
        if cid >= nf:
            continue
        Np, _, W = fmeta[cid][:3]
        if Np <= potrf_maxnp:
            bb = min(Np, BLOCK_CHOL_SLAB)
            shapes[(W, bb)] = shapes.get((W, bb), 0) + Np // bb
    return shapes


def block_chol_flops(W: int, Np: int) -> float:
    """Operations of the Cholesky of W dense Np x Np blocks."""
    return W * Np ** 3 / 3.0


def block_chol_bytes(W: int, Np: int, itemsize: int = 4) -> float:
    """Bytes of one launch: the blocks S and the pad vector read once, the
    factor U written once."""
    return (2 * W * Np * Np + W * Np) * itemsize


def block_chol_least_s(shapes: dict, itemsize: int = 4) -> float:
    """The least time the card could take for the launches of ``shapes``:
    per launch the larger of its operations over the float32 peak and its
    bytes over the HBM peak."""
    return sum(cnt * max(block_chol_flops(W, Np) / PEAK_FLOPS_F32,
                         block_chol_bytes(W, Np, itemsize) / PEAK_HBM_BYTES)
               for (W, Np), cnt in shapes.items())


def share_of_peak(least_s: float, took_s: float, what: str) -> float:
    """100 x least / took, in %; raises above PEAK_MARGIN x 100, where the
    count or the time leaves out part of the work."""
    pct = 100.0 * least_s / took_s
    if pct > 100.0 * PEAK_MARGIN:
        raise RuntimeError(f"{what}: {pct:.4g}% of the peak is above "
                           f"{PEAK_MARGIN:.0%}; the count or the time is "
                           f"wrong")
    return pct
