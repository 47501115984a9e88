"""umf_symbolic_s: seconds of the set-up's umf_symbolic (the program's span
umf.symbolic: strategy, matching, ordering, supernodes, plan and scatter
maps): its last outermost call before the window's first umf.numeric."""
from harness import program_spans


def read(run):
    spans = program_spans.table()
    window = program_spans.window_calls(run, "refactorize", "umf.numeric",
                                        spans)
    got = spans and spans.get("umf.symbolic")
    if not window or not got:
        return None
    before = [c for c in got["calls"] if c.start < window[0].start
              and "umf.symbolic" not in c.parent.split("/")]
    return before[-1].seconds if before else None
