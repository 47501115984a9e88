"""device_copy_gb: bytes copied within the device in a refactor-and-solve
step of the window, in GB (1e9): the d2d bytes that the program counts
inside its spans super.factorize and super.solve (the factor program's
copy-in and the clone of its result, the solve's copy of the panels and
of the inverted diagonal blocks, the solve program's copy-in and
clone)."""
from harness import program_spans


def read(run):
    spans = program_spans.table()
    calls = [program_spans.window_calls(run, call, span, spans)
             for call, span in program_spans.PROGRAM_CALL.items()]
    if not all(calls):
        return None
    steps = len(calls[0])
    return sum(c.d2d for cs in calls for c in cs) / steps / 1e9
