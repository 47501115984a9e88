"""pr_spmv_roofline_pct: the least time of the power iterations a
PageRank call needed (harness.pr_counts: 4 bytes an arc and each
per-vertex vector once an iteration, over the HBM peak) over
pr_device_ms, the loop program's busy time per call, in %.  The
iterations are the mean of the traced phase's calls (the program's
counter graphblas.pagerank.iterations, summed by the front end in
counters()["phases"]["traced"]).  The predicated steps run past the stop
count in the time and not in the work."""
from harness import counts, pr_counts


def read(run):
    t = run.trace
    c = run.counters
    if t is None or run.device.type != "cuda" \
            or c.get("program") != "pagerank":
        return None
    traced = c.get("phases", {}).get("traced")
    n = t["calls"].get("solve", 0)
    us = t["graph_busy_us"].get("solve")
    if not n or not us or not traced or not traced["iterations"]:
        return None
    least = pr_counts.pagerank_least_s(
        c["n"], c["arcs"], traced["iterations"] / traced["calls"],
        c["itemsize"])
    return counts.share_of_peak(least, us / n / 1e6, "pagerank_spmv")
