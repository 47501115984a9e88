"""lu_front_roofline_pct: the least time of one numeric's LU fronts (per
supernode of the symbolic, unpadded: k columns, m rows below them, the
larger of 2/3 k^3 + 2 m k^2 + 2 m^2 k flops over the float32 peak and its
bytes over the HBM peak; harness.lu_counts) over lu_device_ms, the busy
time of the LU program's replay per refactorization, in %."""
from harness import counts, lu_counts


def read(run):
    t = run.trace
    fronts = run.counters.get("lu_fronts")
    if t is None or run.device.type != "cuda" or not fronts \
            or run.counters.get("program") != "umf":
        return None
    n = t["calls"].get("refactorize", 0)
    us = t["graph_busy_us"].get("refactorize")
    if not n or not us:
        return None
    least = lu_counts.lu_front_least_s(fronts["cols"], fronts["rows_below"],
                                       run.counters["itemsize"])
    return counts.share_of_peak(least, us / n / 1e6, "lu_front")
