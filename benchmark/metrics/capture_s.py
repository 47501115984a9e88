"""capture_s: the factor program's warm-up and capture seconds, as the
program counts them (cm.info factor_warmup_time + factor_capture_time)."""


def read(run):
    c = run.counters
    if run.device.type != "cuda" or c.get("capture_s") is None:
        return None
    return c["warmup_s"] + c["capture_s"]
