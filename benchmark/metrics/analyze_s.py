"""analyze_s: span around analyze in set-up (ordering, symbolic
factorization)."""


def read(run):
    d = run.spans.of("setup", "analyze")
    return d[0] if d else None
