"""The per-layer metrics that read the program's own spans
(``suitesparse_tpu_torch.utils.trace``), on the CPU at n = 512: each reads
the window's calls and no others, and each gives None where the program
has no such span, or no span table at all."""
import sys
import time

import pytest

import bench_support as bs
from harness import cell as cell_mod
from harness import program_spans, spec as spec_mod, tracing
from suitesparse_tpu_torch import utils
from suitesparse_tpu_torch.cholesky import super_numeric
from suitesparse_tpu_torch.utils import trace

NAMES = ("assemble_ms", "factor_replay_ms", "device_copy_gb",
         "solve_host_ms", "plan_s")
# added inside each window call, never in set-up or in the traced window
SLOW_S = 0.02
WINDOW_GB = 1.0


@pytest.fixture
def root(tmp_path):
    return bs.checkout(tmp_path)


def _session(root, traffic):
    spec = spec_mod.Spec(root)
    return spec, cell_mod.Session(spec, f"lap3d_8.{traffic}", "cpu",
                                  lambda msg: None)


def _run(root, traffic, trace=1, seconds=0.5):
    spec, session = _session(root, traffic)
    run, _, _ = session.run(bs.BIG_SEED, seconds, bool(trace),
                            time.perf_counter())
    return spec, run


def _read(spec, run, names=NAMES):
    return {n: spec.reader(n).read(run) for n in names}


@pytest.fixture
def window_only(monkeypatch):
    """Inside each window call only: the host assembly, the factor
    program's call and the solve's host work each take SLOW_S longer, and
    the refactorization counts WINDOW_GB more d2d bytes.  Set-up: a plan
    span of 0.1 s holding another plan span; first window call: a plan
    span of 0.1 s, which plan_s must leave out."""
    made = []
    real_init = tracing.Spans.__init__

    def init(self):
        real_init(self)
        made.append(self)
    monkeypatch.setattr(tracing.Spans, "__init__", init)

    def phase():
        return made[-1].phase if made else None

    def slowed(fn):
        def inner(*a, **kw):
            if phase() == "window":
                time.sleep(SLOW_S)
            return fn(*a, **kw)
        return inner

    late = []

    def factor_program(*a, **kw):
        if phase() == "setup":
            with trace.span("plan.outer"):
                time.sleep(0.05)
                with trace.span("plan.inner"):
                    time.sleep(0.05)
        elif phase() == "window" and not late:
            late.append(1)
            with trace.span("plan.late"):
                time.sleep(0.1)
        trace.moved("d2d", WINDOW_GB * 1e9 if phase() == "window" else 0)
        return real_factor_program(*a, **kw)

    # both run inside the program's spans super.factorize / super.solve
    real_factor_program = super_numeric.factor_program
    monkeypatch.setattr(super_numeric, "factor_program", factor_program)
    monkeypatch.setattr(super_numeric, "_assemble_values",
                        slowed(super_numeric._assemble_values))
    monkeypatch.setattr(super_numeric, "solve_program",
                        slowed(super_numeric.solve_program))
    real_call = super_numeric.DeviceProgram.__call__

    def call(self, *inputs):
        # the factor program's call; the solve's are slowed with it
        if self.name.startswith(("solve_", "dinv")) or phase() != "window":
            return real_call(self, *inputs)
        time.sleep(SLOW_S)
        return real_call(self, *inputs)
    monkeypatch.setattr(super_numeric.DeviceProgram, "__call__", call)


@pytest.mark.parametrize("traffic", ["refactor", "solve"])
def test_the_metrics_read_the_windows_calls_only(root, window_only,
                                                 traffic):
    # long enough for several slowed steps on a loaded host
    spec, run = _run(root, traffic, seconds=2.0)
    got = _read(spec, run)
    n_window = len(run.spans.of("window", "solve"))
    assert n_window >= 2 and len(run.spans.of("traced", "solve")) >= 2
    # the set-up's outer plan span counts, the one inside it and the one
    # in the window do not; lap3d_8's own plans take well under 0.04 s
    assert 0.1 <= got["plan_s"] < 0.14
    if traffic == "refactor":
        ms = SLOW_S * 1e3
        # each slowed call takes SLOW_S more in the window and no more
        # outside it: a mean over any other calls reads less
        for name in ("assemble_ms", "factor_replay_ms", "solve_host_ms"):
            assert got[name] >= ms, name
        # WINDOW_GB a step in the window, the program's own copies beside
        assert WINDOW_GB < got["device_copy_gb"] < WINDOW_GB + 0.01
        # the program's spans inside each harness refactorize span
        harness = sum(run.spans.of("window", "refactorize"))
        inner = program_spans.window_calls(run, "refactorize",
                                           "super.factorize")
        assert sum(c.seconds for c in inner) <= harness
    else:
        assert got["solve_host_ms"] >= SLOW_S * 1e3
        for name in ("assemble_ms", "factor_replay_ms", "device_copy_gb"):
            assert got[name] is None, name


def test_the_window_calls_fall_inside_the_window(root):
    """The calls the metrics take are those that started after the set-up
    and before the traced window, as many as the window's steps."""
    spec, run = _run(root, "refactor")
    spans = program_spans.table()
    for call, span in program_spans.PROGRAM_CALL.items():
        calls = spans[span]["calls"]
        win = program_spans.window_calls(run, call, span, spans)
        n_traced = len(run.spans.of("traced", call))
        assert len(win) == len(run.step_s) and n_traced > 0
        after = calls[len(calls) - n_traced:]
        assert max(c.start for c in win) < min(c.start for c in after)
        before = calls[len(calls) - n_traced - len(win) - 1]
        assert before.start < min(c.start for c in win)
    got = _read(spec, run)
    assert all(v is not None and v > 0 for v in got.values()), got


def test_each_metric_gives_none_without_its_spans(root, monkeypatch):
    spec, run = _run(root, "refactor", trace=0)
    assert None not in _read(spec, run).values()
    # the program has the table, but not the spans the metrics read
    monkeypatch.setattr(program_spans, "table", lambda: {})
    assert _read(spec, run) == dict.fromkeys(NAMES)
    monkeypatch.undo()
    # the program has no span table (a program before the facility)
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "suitesparse_tpu_torch.utils.trace",
                        None)
    assert program_spans.table() is None
    assert _read(spec, run) == dict.fromkeys(NAMES)


@pytest.mark.parametrize("traffic", ["refactor", "solve"])
def test_a_traced_result_line_reports_the_cells_metrics(root, capsys,
                                                        traffic):
    rc, res, _ = bs.run(root, capsys, f"lap3d_8.{traffic}", trace=1)
    assert rc == 0 and res["correct"] is True
    want = {"refactor": {"assemble_ms", "factor_replay_ms",
                         "device_copy_gb", "plan_s"},
            "solve": {"solve_host_ms", "plan_s"}}[traffic]
    assert want <= set(res["metrics"])
    assert not (set(NAMES) - want) & set(res["metrics"])
    rc, res, _ = bs.run(root, capsys, f"lap3d_8.{traffic}", trace=0)
    assert rc == 0 and not set(NAMES) & set(res["metrics"])


def test_a_program_span_is_one_for_one_with_the_harness_call(root):
    """Each harness refactorize and solve span holds one call of the
    program's span of the same call (the rule window_calls rests on)."""
    trace.reset()
    spec, run = _run(root, "refactor")
    got = trace.snapshot()
    for call, span in program_spans.PROGRAM_CALL.items():
        n = sum(len(run.spans.of(ph, call))
                for ph in ("setup", "window", "traced"))
        assert got[span]["count"] == n
