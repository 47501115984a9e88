"""umf_refine_ms: the float64 host residuals of the iterative refinement
per solve in the window: the program's spans umf.solve.residual that
start inside the window's umf.solve calls, summed, over the number of
those calls (their count per solve is the refinement count)."""
import bisect

from harness import program_spans


def read(run):
    spans = program_spans.table()
    solves = program_spans.window_calls(run, "solve", "umf.solve", spans)
    got = spans and spans.get("umf.solve.residual")
    if not solves or not got:
        return None
    starts = [c.start for c in solves]
    total = 0.0
    for c in got["calls"]:
        i = bisect.bisect_right(starts, c.start) - 1
        if i >= 0 and c.start < starts[i] + solves[i].seconds:
            total += c.seconds
    return 1e3 * total / len(solves)
