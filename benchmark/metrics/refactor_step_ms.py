"""refactor_step_ms: the window's time over the refactor-and-solve steps
it completed, on the host's clock; read where the steps refactorize."""


def read(run):
    if not run.spans.of("window", "refactorize") or not run.step_s:
        return None
    return 1e3 * run.window_s / len(run.step_s)
