"""solve_step_p99_ms: the 99th percentile of every solve step of the
window, each timed on the host's clock (the call returns the host
solution, so the clock reads its completion)."""
import numpy as np


def read(run):
    if run.spans.of("window", "refactorize") or not run.step_s:
        return None
    return 1e3 * float(np.percentile(run.step_s, 99))
