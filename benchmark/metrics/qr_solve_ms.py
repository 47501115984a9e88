"""qr_solve_ms: mean host time of the R solve per solve in the window:
the program's span qr.solve (the bind of a new R, Q'b's upload, the R
solve program's replay, the download), one in each solve call."""
from harness import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.window_calls(
        run, "solve", "qr.solve"))
