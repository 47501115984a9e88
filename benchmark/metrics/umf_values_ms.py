"""umf_values_ms: mean host time of umf_numeric's value path per
refactorization in the window: the program's span umf.numeric.values (row
scaling, permutation, sort and cast of the values on the host), one in
each refactorize call."""
from harness import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.window_calls(
        run, "refactorize", "umf.numeric.values"))
