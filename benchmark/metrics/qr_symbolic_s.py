"""qr_symbolic_s: seconds of the set-up's qr_symbolic (the program's span
qr.symbolic: the ordering of A^T A, supernodes, the fronts' rows and
sizes, the buckets' maps and R's panel plan): its last outermost call
before the window's first qr.numeric."""
from harness import program_spans


def read(run):
    spans = program_spans.table()
    window = program_spans.window_calls(run, "refactorize", "qr.numeric",
                                        spans)
    got = spans and spans.get("qr.symbolic")
    if not window or not got:
        return None
    before = [c for c in got["calls"] if c.start < window[0].start
              and "qr.symbolic" not in c.parent.split("/")]
    return before[-1].seconds if before else None
