"""device_idle_pct.solve: 100 x (1 - busy / step) for the solve cells: busy is
the union of every device operation per step of the traced window, step
the untraced window's time per step.  The profiler stretches the traced
steps (its cost per kernel of a replayed graph), so the traced window's
own idle share reads higher; the result line's busy_s and window_s give
that one."""


def read(run):
    t = run.trace
    n = t and t["calls"].get("solve", 0)
    if not n or run.device.type != "cuda" or not run.step_s:
        return None
    step_us = 1e6 * run.window_s / len(run.step_s)
    return 100.0 * (1.0 - t["busy_us"] / n / step_us)
