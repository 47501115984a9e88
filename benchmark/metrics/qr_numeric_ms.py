"""qr_numeric_ms: mean host time of qr_factorize per refactorization in
the window: the program's span qr.numeric (host value cast, upload, the
gather into the factored order, the QR program's replay and clones, the
rank check that waits for the device, Q'b's download), one in each
refactorize call."""
from harness import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.window_calls(
        run, "refactorize", "qr.numeric"))
