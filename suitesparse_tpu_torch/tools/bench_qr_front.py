"""The QR program's blocked Householder QR of its tall fronts
(``qr/spqr.front_qr``: the panel kernel ``csrc/qr_panel.cu`` and float64
GEMMs) against its plain version and against cuSOLVER's geqrf and ormqr.

    python -m suitesparse_tpu_torch.tools.bench_qr_front [FR,FC[,B]] ...

holds ``front_qr`` against ``front_qr_plain`` on the card at ``CHECKS``
(one front height for each way the panel kernel holds its rows: one CTA,
a cluster, a cooperative grid) and at ``tallest`` (the grid at 32 rows a
thread), with one right-hand side: QR, tau and Q'B
within 1e-12 of the plain version relative to the front's largest entry,
a repeat bit-identical, and R with b bit-identical to R without.  Then,
at each shape given (default ``SHAPES``: up to 800 rows, ~10,000 rows and
the unwrap3d_64 root front, 38,400 x 7,936 padded), it prints one JSON
line: ``front_qr`` with one right-hand side captured into a CUDA graph
and replayed (``kernel_ms``, CUDA events over the replays; ``launches``,
its panel-kernel launches), the plain version once (``plain_ms``, host
clock ended by a sync), ``torch.geqrf`` then ``torch.ormqr`` captured the
same way (``library_ms``, the yardstick it replaces), and the least time
the card could take (``bound_ms``: the larger of the front's Householder
flops plus b's over 67 TFLOP/s and its entries and b's read and written
once over 3.35 TB/s, as ``benchmark/harness/qr_counts.py`` counts them).
Needs the card.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from ..qr.spqr import _sm_count, front_qr, front_qr_plain, panel_tiling

__all__ = ["CHECKS", "SHAPES", "bound_ms", "case", "check", "main",
           "tallest", "time_shape"]

PEAK_FLOPS = 67e12         # H100 SXM float64 tensor cores (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
REPS = 3
# (B, FR, FC): a bucket whose panels each fit one CTA, one whose first
# panels take a cluster, one whose first panels take a cooperative grid
# (panel_tiling)
CHECKS = ((6, 128, 96), (2, 1536, 1024), (1, 9856, 1536))


def tallest(sms: int) -> tuple:
    """The tallest bucket ``front_qr`` takes on a card of ``sms`` SMs: one
    front of SMs x 512 rows, a grid of one CTA an SM, 32 rows a thread."""
    return (1, sms * 512, 64)


# unwrap3d_64's shapes: a one-CTA bucket, a ~10,000-row front and the root
SHAPES = ((11, 768, 512), (1, 9856, 5504), (1, 38400, 7936))


def case(rng: torch.Generator, B: int, FR: int, FC: int, k: int = 1,
         device="cuda") -> tuple:
    """Random float64 fronts (B, FR, FC) whose last rows are zero, as a
    padded front's are, and k right-hand sides (B, FR, k) (None for 0)."""
    W = torch.randn((B, FR, FC), generator=rng, dtype=torch.float64)
    W[:, FR - FR // 64:] = 0.0
    WB = (torch.randn((B, FR, k), generator=rng, dtype=torch.float64)
          if k else None)
    return W.to(device), None if WB is None else WB.to(device)


def _rel(a: torch.Tensor, b: torch.Tensor, scale: float) -> float:
    return float((a - b).abs().max()) / scale


def check(rng: torch.Generator, shape: tuple, k: int = 1) -> dict:
    """front_qr against front_qr_plain on the card at one shape: QR, tau
    and Q'B within 1e-12 (relative to the largest entry of W or b), a
    repeat bit-identical, R with b bit-identical to R without.  Raises
    AssertionError on a miss; returns the errors."""
    B, FR, FC = shape
    W, WB = case(rng, B, FR, FC, k)
    QR, tau, QtB = front_qr(W, WB.clone())
    QR2, tau2, QtB2 = front_qr(W, WB.clone())
    QR0, tau0, _ = front_qr(W, None)
    QRp, taup, QtBp = front_qr_plain(W, WB.clone())
    torch.cuda.synchronize()
    sw, sb = float(W.abs().max()), float(WB.abs().max())
    out = dict(shape=list(shape), k=k,
               tiling=list(panel_tiling(FR, _sm_count(W.device))),
               qr_vs_plain=_rel(QR, QRp, sw),
               tau_vs_plain=_rel(tau, taup, 1),
               qtb_vs_plain=_rel(QtB, QtBp, sb),
               repeat_identical=bool(torch.equal(QR, QR2)
                                     and torch.equal(tau, tau2)
                                     and torch.equal(QtB, QtB2)),
               r_with_b_identical=bool(torch.equal(QR, QR0)
                                       and torch.equal(tau, tau0)))
    for key in ("qr_vs_plain", "tau_vs_plain", "qtb_vs_plain"):
        assert out[key] <= 1e-12, f"front_qr {shape}: {key} {out[key]:.3e}"
    assert out["repeat_identical"], f"front_qr {shape}: a repeat differs"
    assert out["r_with_b_identical"], f"front_qr {shape}: R with b differs"
    return out


def bound_ms(B: int, FR: int, FC: int, k: int = 1) -> float:
    """The least time of B fronts' QR with k right-hand sides: the larger
    of flops over the float64 peak and bytes over the HBM peak."""
    f, c = float(FR), float(FC)
    flops = (2 * c * c * (f - c / 3) if f >= c else 2 * f * f * (c - f / 3)) \
        + 4 * f * c * k
    nbytes = 2 * f * (c + k) * 8
    return B * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def _graph_ms(fn, reps: int = REPS) -> tuple:
    """(ms a replay of ``fn`` captured into a CUDA graph, front_qr's
    launches the capture recorded)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = front_qr.launches
    with torch.cuda.graph(graph):
        fn()
    launches = front_qr.launches - before
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms, launches


def time_shape(shape: tuple, k: int = 1, plain: bool = True) -> dict:
    """front_qr, its plain version and geqrf + ormqr at one shape."""
    B, FR, FC = shape
    rng = torch.Generator().manual_seed(FR * 7 + FC)
    W, WB = case(rng, B, FR, FC, k)
    kernel_ms, launches = _graph_ms(lambda: front_qr(W, WB.clone()))

    def library():
        QR, tau = torch.geqrf(W)
        torch.ormqr(QR, tau, WB, left=True, transpose=True)
    library_ms, _ = _graph_ms(library)
    out = dict(shape=list(shape), k=k,
               tiling=list(panel_tiling(FR, _sm_count(W.device))),
               kernel_ms=kernel_ms, launches=launches,
               library_ms=library_ms, bound_ms=bound_ms(B, FR, FC, k))
    if plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        front_qr_plain(W, WB.clone())
        torch.cuda.synchronize()
        out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    del W, WB
    torch.cuda.empty_cache()
    return out


def main(shapes=SHAPES, checks=CHECKS) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_qr_front measures the card: no CUDA "
                           "device")
    rng = torch.Generator().manual_seed(20)
    rows = []
    for shape in checks + (tallest(_sm_count(torch.device("cuda"))),):
        row = check(rng, shape)
        print("[check] " + json.dumps(row), flush=True)
        rows.append(row)
    for shape in shapes:
        row = time_shape(shape)
        row["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    given = [tuple(int(v) for v in a.split(",")) for a in sys.argv[1:]]
    main([(s[2] if len(s) > 2 else 1, s[0], s[1]) for s in given] or SHAPES)
