"""refactorize_ms: mean span around CholeskySolver.refactorize in the
window (front end: host value assembly, replay, NaN scan, clone)."""


def read(run):
    m = run.span_mean("refactorize")
    return None if m is None else 1e3 * m
