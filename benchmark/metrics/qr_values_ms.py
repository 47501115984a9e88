"""qr_values_ms: mean host time of qr_factorize's value path per
refactorization in the window: the program's span qr.numeric.values (A's
values and b cast on the host in their own order, and the default rank
tolerance from A's column norms), one in each refactorize call."""
from harness import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.window_calls(
        run, "refactorize", "qr.numeric.values"))
