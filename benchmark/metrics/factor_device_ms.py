"""factor_device_ms: per refactorization, the busy time (union of
intervals) of the kernels of the CUDA graphs launched inside the
refactorize spans of the traced window: the pf program's replay."""


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda":
        return None
    n = t["calls"].get("refactorize", 0)
    us = t["graph_busy_us"].get("refactorize")
    return us / n / 1e3 if n and us else None
