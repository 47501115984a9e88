"""The program's own spans (``suitesparse_tpu_torch.utils.trace``), as the
per-layer metrics read them.

The program keeps one table of its spans for the process: per span name,
its last calls in order, each with its start, seconds, bytes moved and the
names of the spans open around it.  The harness's span around a call into
the program (``refactorize``, ``solve``) and the program's span inside it
come one for one, and the traced window's calls come last.  So the
window's calls of a program span that runs once in each such call are the
``window`` count of the harness's spans, before its ``traced`` count.

A program without the facility or without the span gives None.
"""
from __future__ import annotations

# a call that builds a plan or a program's body (its device index maps)
PLAN = "plan."
BODY = ".body"
SETUP_START = "cholesky.analyze"
# the program's span inside each harness call
PROGRAM_CALL = {"refactorize": "super.factorize", "solve": "super.solve"}


def table():
    """The program's span table, or None where the program has none."""
    try:
        from suitesparse_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def window_calls(run, call: str, span: str, spans=None):
    """The calls of the program span ``span`` made inside the window's
    harness spans ``call`` (one each), or None."""
    spans = table() if spans is None else spans
    got = spans and spans.get(span)
    n_window = len(run.spans.of("window", call))
    n_traced = len(run.spans.of("traced", call))
    if not got or not n_window or len(got["calls"]) < n_window + n_traced:
        return None
    calls = got["calls"]
    end = len(calls) - n_traced
    return calls[end - n_window:end]


def mean_ms(calls):
    return None if not calls else 1e3 * sum(c.seconds for c in calls) \
        / len(calls)


def is_plan(name: str) -> bool:
    return name.startswith(PLAN) or (name.startswith("program.")
                                     and name.endswith(BODY))


def setup_plan_s(run):
    """Seconds of the set-up's plan building: the calls of the plan spans
    from the program's last ``analyze`` before the window to the window's
    first call into the program, without those inside another plan
    span."""
    spans = table()
    if not spans:
        return None
    firsts = [w[0].start for call, span in PROGRAM_CALL.items()
              for w in [window_calls(run, call, span, spans)] if w]
    if not firsts:
        return None
    end = min(firsts)
    starts = [c.start for c in spans.get(SETUP_START, {}).get("calls", ())
              if c.start < end]
    if not starts:
        return None
    begin = max(starts)
    total, seen = 0.0, False
    for name, got in spans.items():
        if not is_plan(name):
            continue
        for c in got["calls"]:
            if begin <= c.start < end and not any(
                    is_plan(p) for p in c.parent.split("/")):
                total += c.seconds
                seen = True
    return total if seen else None
