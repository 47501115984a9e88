"""qr_front_roofline_pct: the least time of one numeric's QR fronts (per
front of the symbolic, unpadded: f rows and c columns, the larger of
2 c^2 (f - c/3) (f >= c; else 2 f^2 (c - f/3)) + 4 f c flops over the
float32 peak and its bytes, at the fronts' own entry size, over the HBM
peak; harness.qr_counts) over
qr_device_ms, the busy time of the QR program's replay per
refactorization, in %."""
from harness import counts, qr_counts


def read(run):
    t = run.trace
    fronts = run.counters.get("qr_fronts")
    if t is None or run.device.type != "cuda" or not fronts \
            or run.counters.get("program") != "spqr":
        return None
    n = t["calls"].get("refactorize", 0)
    us = t["graph_busy_us"].get("refactorize")
    if not n or not us:
        return None
    least = qr_counts.qr_front_least_s(fronts["rows"], fronts["cols"],
                                       fronts.get("itemsize",
                                                  run.counters["itemsize"]))
    return counts.share_of_peak(least, us / n / 1e6, "qr_front")
