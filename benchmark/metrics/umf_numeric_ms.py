"""umf_numeric_ms: mean host time of umf_numeric per refactorization in
the window: the program's span umf.numeric (host value scaling and
permutation, upload, the LU program's replay and clones, the NaN and pivot
scan that waits for the device), one in each refactorize call."""
from harness import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.window_calls(
        run, "refactorize", "umf.numeric"))
