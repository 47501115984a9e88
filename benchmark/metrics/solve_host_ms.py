"""solve_host_ms: mean host time of a solve call in the window outside its
wait for the device: the program's span super.solve less its
super.solve.wait (upload of b, the solve program's copy-in, launch and
clone, the download of x, and the copy of a new factor when it runs)."""
from harness import program_spans


def read(run):
    spans = program_spans.table()
    whole = program_spans.window_calls(run, "solve", "super.solve", spans)
    wait = program_spans.window_calls(run, "solve", "super.solve.wait",
                                      spans)
    if not whole or not wait:
        return None
    return program_spans.mean_ms(whole) - program_spans.mean_ms(wait)
