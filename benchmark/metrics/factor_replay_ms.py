"""factor_replay_ms: mean host time of the factor program's call and the
wait for the device after it, per refactorization in the untraced window:
the program's spans super.factorize.program (copy-in, graph launch, clone
of the result) and super.factorize.wait.  The traced factor_device_ms is
the device's busy time of the same replays."""
from harness import program_spans


def read(run):
    calls = [program_spans.window_calls(run, "refactorize",
                                        "super.factorize." + part)
             for part in ("program", "wait")]
    if not all(calls):
        return None
    return sum(program_spans.mean_ms(c) for c in calls)
