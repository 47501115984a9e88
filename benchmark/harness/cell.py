"""One run of one cell: set-up, the measured window, the traced window,
the judge.

Set-up (``setup_s``, from the process's start): the matrix from the
configuration, the pools from the seed, ``analyze``, and the mix's
``setup`` steps, which warm every shape the window uses (for the Cholesky
front end: the first refactorization with its plans, warm-up, capture and
first replay, and the first solve with the solve program's capture).

Window: a closed loop with one caller that waits for each answer, for
``seconds`` seconds: each iteration runs the mix's ``step``, which the
configuration's front end (``solvers/<solver>.py``) does in its method
``step_<step>``, host data in and host answer out.  Every answer is kept
for the judge.

Traced window (``--trace 1``): ``trace_steps`` further steps of the same
loop under ``torch.profiler`` (CPU and CUDA), after TRACE_WARMUP steps
that the profiler records and the reduction (``harness.tracing``) leaves
out.

Judge: after the window, with the peak memory read and the program's state
freed, the configuration's plain reference (``reference/<judge>.py``,
``backward_error`` unless the configuration names another) reads every
answer and the current factor; each number it returns is held against its
limit (``limits/<cell>.json``) here, for the benchmark and the control
alike.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from . import tracing, traffic

# steps run under the profiler before its window opens
TRACE_WARMUP = 2


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: dict
    config: dict
    mix: dict
    device: torch.device
    setup_s: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    spans: object = None
    counters: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    trace: dict = None

    def span_mean(self, name: str, phase: str = "window"):
        d = self.spans.of(phase, name)
        return sum(d) / len(d) if d else None


@dataclasses.dataclass
class Case:
    """What the judge reads: the benchmark's own inputs, and the answers
    and the factor that the program returned."""

    A0: sp.csc_matrix       # the configuration's matrix; its pattern
    values: list            # the value sets (data arrays on that pattern)
    rhs: np.ndarray         # the right-hand sides
    answers: list           # (value set, right-hand side, answer) a step
    factor: object          # the front end's claim (solvers/), or None
    seed: int
    device: torch.device

    def matrix(self, v: int) -> sp.csc_matrix:
        return sp.csc_matrix((self.values[v], self.A0.indices,
                              self.A0.indptr), shape=self.A0.shape)


def set_precision(config: dict) -> None:
    """float32 products in full float32 unless the configuration allows
    TF32."""
    tf32 = bool(config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


class Session:
    """A cell's matrix and program on one device, set up once.

    The benchmark makes one run a process; the control tool makes several
    seeds' runs in one session."""

    def __init__(self, spec, cell_name: str, device, log):
        self.cell = spec.cell(cell_name)
        self.config = spec.config(self.cell["config"])
        self.mix = traffic.full(spec.mix(self.cell["traffic"]),
                                self.cell["traffic"])
        self.limits = spec.limits(cell_name)
        self.reference = spec.judge(self.config.get("judge",
                                                    "backward_error"))
        self.device = torch.device(device)
        self.log = log
        set_precision(self.config)
        if self.device.type == "cuda":
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats(self.device)
        gen = spec.generator(self.config["generator"])
        self.A0 = gen.make(**self.config["params"])
        self.spans = tracing.Spans()
        self.driver = spec.solver(self.config["solver"]).Driver(
            self.A0, self.config, self.device, self.spans)
        self.step = self._step_fn(self.mix["step"])
        self.setup_steps = [self._step_fn(k) for k in self.mix["setup"]]
        self.driver.analyze()
        log(f"matrix n={self.A0.shape[0]} nnz={self.A0.nnz}; analyze "
            f"{sum(self.spans.of('setup', 'analyze')):.3f} s")

    def _step_fn(self, name: str):
        fn = getattr(self.driver, f"step_{name}", None)
        if fn is None:
            raise ValueError(f"the front end {self.config['solver']!r} "
                             f"has no step {name!r}")
        return fn

    def run(self, seed: int, seconds: float, trace: bool, t0: float) -> tuple:
        """One run from the seed: returns (Run, answers, pools)."""
        spans = self.spans
        spans.phase = "setup"
        pools = traffic.make_pools(self.A0, self.mix, seed)
        self.driver.set_values(pools.values)
        for fn in self.setup_steps:
            fn(pools, -1)
        run = Run(cell=self.cell, config=self.config, mix=self.mix,
                  device=self.device, spans=spans)
        run.counters = self.driver.counters()
        run.setup_s = time.perf_counter() - t0
        self.log(f"program {run.counters.get('program')}; set-up "
                 f"{run.setup_s:.3f} s")

        steps: list = []
        spans.phase = "window"
        start = time.perf_counter()
        i = 0
        while True:
            ts = time.perf_counter()
            steps.append(self.step(pools, i))
            te = time.perf_counter()
            run.step_s.append(te - ts)
            i += 1
            if te - start >= seconds:
                break
        run.window_s = te - start
        q = np.percentile(run.step_s, [0, 25, 50, 75, 100]) * 1e3
        half = len(run.step_s) // 2
        self.log(f"window {run.window_s:.3f} s, {i} steps; step ms min "
                 f"{q[0]:.2f} quartiles {q[1]:.2f} {q[2]:.2f} {q[3]:.2f} max "
                 f"{q[4]:.2f}; halves {1e3 * np.mean(run.step_s[:half]):.2f} "
                 f"{1e3 * np.mean(run.step_s[half:]):.2f}")
        if trace:
            run.trace = self._traced(pools, i, steps)
        if self.device.type == "cuda":
            run.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        return run, steps, pools

    def _traced(self, pools, i: int, steps: list) -> dict:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        spans = self.spans
        spans.phase = "traced"
        spans.profiling = True
        try:
            with profile(activities=acts) as prof:
                # the profiler's own start-up lands in steps outside the
                # traced window
                for j in range(TRACE_WARMUP):
                    steps.append(self.step(pools, i + j))
                i += TRACE_WARMUP
                with torch.profiler.record_function(
                        tracing.PREFIX + tracing.WINDOW):
                    for j in range(self.mix["trace_steps"]):
                        steps.append(self.step(pools, i + j))
        finally:
            spans.profiling = False
        t = time.perf_counter()
        summary = tracing.reduce_trace(tracing.trace_events(prof))
        self.log(f"trace: {summary['ops']} device ops ({summary['launched']} "
                 f"with a launch record), calls {summary['calls']}, read in "
                 f"{time.perf_counter() - t:.1f} s")
        return summary

    def judge(self, seed: int, steps: list, pools, close: bool = True) -> dict:
        """Every answer and the current factor judged by the reference,
        each number it returns against its limit: {"checks": {name:
        (value, limit)}, "failed": answers over a limit, "correct"}.
        Reads the factor, then (``close``) frees the program's state before
        the reference runs."""
        t0 = time.perf_counter()
        claim = self.driver.factor()
        if close:
            self.driver.close()
        t = time.perf_counter()
        case = Case(A0=self.A0, values=pools.values, rhs=pools.rhs,
                    answers=steps, factor=claim, seed=seed,
                    device=self.device)
        got = self.reference.judge(case)
        lim = self.limits
        if set(got["values"]) != set(lim):
            raise ValueError(f"the judge returns {sorted(got['values'])}, "
                             f"the cell's limits name {sorted(lim)}")
        checks = {k: (float(got["values"][k]), lim[k]) for k in lim}
        bad = np.zeros(len(steps), dtype=bool)
        for k, e in got.get("per_answer", {}).items():
            bad |= ~(np.asarray(e) <= lim[k])
        self.log(f"judge: the factor read in {t - t0:.1f} s, {len(steps)} "
                 f"answers and the factor judged in "
                 f"{time.perf_counter() - t:.1f} s")
        return dict(checks=checks, failed=int(bad.sum()),
                    correct=all(v <= lv for v, lv in checks.values()))
