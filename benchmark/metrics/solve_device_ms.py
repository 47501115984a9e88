"""solve_device_ms: per solve, the busy time (union of intervals) of the
kernels of the CUDA graphs launched inside the solve spans of the traced
window: the solve program's replay."""


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda":
        return None
    n = t["calls"].get("solve", 0)
    us = t["graph_busy_us"].get("solve")
    return us / n / 1e3 if n and us else None
