"""assemble_ms: mean host value assembly of a refactorization in the
window: the program's span super.factorize.assemble (symperm, transpose
and sort of the values of tril(PAP') in NumPy), one in each refactorize
call."""
from harness import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.window_calls(
        run, "refactorize", "super.factorize.assemble"))
