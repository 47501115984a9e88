"""pr_device_ms: per PageRank call, the busy time (union of intervals) of
the kernels of the CUDA graphs launched inside the solve spans of the
traced window: the loop program's replays (graphblas.algorithms), every
predicated step included."""


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda" \
            or run.counters.get("program") != "pagerank":
        return None
    n = t["calls"].get("solve", 0)
    us = t["graph_busy_us"].get("solve")
    return us / n / 1e3 if n and us else None
