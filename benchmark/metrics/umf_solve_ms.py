"""umf_solve_ms: mean host time of umf_solve per solve in the window,
refinement included: the program's span umf.solve (the bind of a new
numeric, three solves' uploads, LU solve programs and downloads, and the
float64 host residuals), one in each solve call."""
from harness import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.window_calls(
        run, "solve", "umf.solve"))
