"""The dense factor-step primitives at panel shapes: the counterpart of
tools/microbench_dense.py.

    python -m suitesparse_tpu_torch.tools.microbench_dense [WxNpxMb ...]

For each (W, Np, Mb) (default: the reference's shapes) it times, in ms a
call and GF/s, ``torch.linalg.cholesky_ex`` of a (W, Np, Np) SPD batch,
and with Mb > 0 ``torch.linalg.solve_triangular`` (the TRSM of a (W, Mb,
Np) block against the factor's transpose, the port's ``trsm_inv=False``
route) and the SYRK product (``super_numeric.syrk``).  The port's factor
step runs POTRF + TRSM as ``panel_factor`` (the block_chol kernel on
128-wide slabs, an explicit inverse and the trailing update) at every Np
up to ``pf._POTRF_MAXNP``: that is timed beside them on the (W, Np + Mb,
Np) panel.

Each time is the mean of a chain of back-to-back calls on CUDA events
(``microbench.per_call_s``), which replaces the reference's K2 - K1
differencing of a host readback; float32 products run in full float32.  A
rate above 105% of the H100's 67 TFLOP/s float32 peak raises.  Runs on the
card unless ``device="cpu"`` is asked for (host times there).
"""
from __future__ import annotations

import sys

import torch

from ..utils.device import resolve_device
from .microbench import check_peak, matmul_precision, per_call_s

__all__ = ["SHAPES", "main"]

SHAPES = ((512, 8, 8), (512, 32, 32), (128, 128, 128), (64, 128, 512),
          (16, 256, 1024), (4, 512, 1536), (1, 1024, 2048), (1, 3584, 0))


def _spd(W: int, Np: int, dev) -> torch.Tensor:
    """The reference's (W, Np, Np) batch: 4 I + 0.1, symmetrized, + Np I."""
    eye = torch.eye(Np, device=dev)
    A0 = (eye * 4.0 + 0.1).expand(W, Np, Np)
    return (A0 + A0.transpose(1, 2)) / 2 + eye * Np


def shape_row(W: int, Np: int, Mb: int, dev, reps: int) -> dict:
    """ms and GF/s of each primitive at one panel shape."""
    from ..cholesky.kernels import panel_factor
    from ..cholesky.super_numeric import syrk
    A = _spd(W, Np, dev)
    fl_chol, fl_trsm = W * Np ** 3 / 3, W * Mb * Np * Np
    cases = [("chol", lambda: torch.linalg.cholesky_ex(A), fl_chol)]
    if Mb:
        Ct = torch.linalg.cholesky_ex(A)[0].transpose(1, 2)
        B = torch.ones((W, Mb, Np), device=dev)
        cases += [("trsm", lambda: torch.linalg.solve_triangular(
                       Ct, B, upper=True, left=False), fl_trsm),
                  ("syrk", lambda: syrk(B), 2 * W * Mb * Mb * Np)]
    P = torch.cat([A, torch.ones((W, Mb, Np), device=dev)], dim=1)
    pe = torch.zeros((W, Np), device=dev)
    rm = torch.ones((W, Np + Mb), device=dev)
    cm = torch.ones((W, Np), device=dev)
    cases.append(("panel_factor", lambda: panel_factor(P, pe, rm, cm),
                  fl_chol + fl_trsm))
    row = {}
    with matmul_precision("highest"):
        for nm, fn, fl in cases:
            t = per_call_s(fn, dev, reps)
            rate = check_peak(fl / t, "float32", f"{nm} W={W} Np={Np} Mb={Mb}")
            row[nm] = dict(ms=t * 1e3, gflops=rate / 1e9)
    return row


def main(shapes=SHAPES, device=None, reps: int = 10) -> dict:
    """Time every shape on ``device`` (the card unless "cpu" is asked
    for) and print one line each."""
    dev = resolve_device(device)
    out = {}
    for W, Np, Mb in shapes:
        row = out[(W, Np, Mb)] = shape_row(W, Np, Mb, dev, reps)
        print(f"W={W:4d} Np={Np:5d} Mb={Mb:5d} ({dev.type}): " + "  ".join(
            f"{nm} {r['ms']:8.3f} ms ({r['gflops']:8.1f} GF/s)"
            for nm, r in row.items()), flush=True)
    return out


if __name__ == "__main__":
    main([tuple(map(int, s.split("x"))) for s in sys.argv[1:]] or SHAPES)
