"""solve_call_ms: mean span around CholeskySolver.solve in the window."""


def read(run):
    m = run.span_mean("solve")
    return None if m is None else 1e3 * m
