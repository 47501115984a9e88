"""solve_step_ms: the window's time over the solve steps it completed, on
the host's clock."""


def read(run):
    if run.spans.of("window", "refactorize") or not run.step_s:
        return None
    return 1e3 * run.window_s / len(run.step_s)
