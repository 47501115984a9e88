"""The port's spans and byte counters (suitesparse_tpu_torch/utils/trace.py)
on the CPU: what a span records, its ring, its profiler range only while a
profiler records, nesting on the profiler's clock, the spans of the
Cholesky front end and its device programs once per call, cm.info's
factor times read from them, and Common.tic/toc on the same table."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from suitesparse_tpu_torch.cholesky import analyze, pf, super_symbolic
from suitesparse_tpu_torch.cholesky.api import CholeskySolver
from suitesparse_tpu_torch.cholesky.super_numeric import (build_plan,
                                                          factorize_super,
                                                          solve_super)
from suitesparse_tpu_torch.core.common import default_common
from suitesparse_tpu_torch.io.generators import laplacian_3d
from suitesparse_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _empty_table():
    trace.reset()
    yield
    trace.reset()


def test_counters_add_over_threads_and_reset_with_the_table():
    trace.count("t.n")
    trace.count("t.n", 4)
    other = threading.Thread(target=lambda: trace.count("t.n", 10))
    other.start()
    other.join()
    got = trace.counts()
    assert got["t.n"] == 15
    got["t.n"] = 0                  # a copy
    assert trace.counts()["t.n"] == 15
    trace.reset()
    assert "t.n" not in trace.counts()


def test_a_span_counts_calls_seconds_and_bytes():
    for i in range(3):
        with trace.span("t.outer") as outer:
            trace.moved("h2d", 10)
            with trace.span("t.inner"):
                time.sleep(0.002)
                trace.moved("d2d", 100 + i)
                trace.moved("d2h", 1)
    got = trace.snapshot()
    inner, top = got["t.inner"], got["t.outer"]
    assert inner["count"] == top["count"] == 3
    assert (inner["h2d"], inner["d2h"], inner["d2d"]) == (0, 3, 303)
    # an outer span's bytes hold those of the spans inside it
    assert (top["h2d"], top["d2h"], top["d2d"]) == (30, 3, 303)
    assert inner["seconds"] >= 0.006 and top["seconds"] >= inner["seconds"]
    assert outer.seconds == top["calls"][-1].seconds > 0
    assert [c.d2d for c in inner["calls"]] == [100, 101, 102]
    assert all(c.parent == "t.outer" for c in inner["calls"])
    assert all(c.parent == "" for c in top["calls"])
    # each inner call starts inside its outer call
    for o, i in zip(top["calls"], inner["calls"]):
        assert o.start <= i.start and i.start + i.seconds <= \
            o.start + o.seconds
    starts = [c.start for c in inner["calls"]]
    assert starts == sorted(starts)
    # bytes outside any span go nowhere
    trace.moved("d2d", 5)
    assert trace.snapshot()["t.outer"]["d2d"] == 303


def test_the_ring_keeps_the_last_calls_in_order(monkeypatch):
    monkeypatch.setattr(trace, "RING", 4)
    for i in range(10):
        with trace.span("t.ring"):
            trace.moved("h2d", i)
    got = trace.snapshot()["t.ring"]
    assert got["count"] == 10 and got["first"] == 6
    assert [c.h2d for c in got["calls"]] == [6, 7, 8, 9]
    assert got["h2d"] == sum(range(10))


def test_spanned_makes_every_call_a_span_and_keeps_the_function():
    @trace.spanned("t.fn")
    def fn(x, y=1):
        """doc"""
        return x + y
    assert fn(1, y=2) == 3 and fn(1) == 2
    assert fn.__doc__ == "doc" and fn.__name__ == "fn"
    assert trace.snapshot()["t.fn"]["count"] == 2
    with pytest.raises(TypeError):
        fn()
    assert trace.snapshot()["t.fn"]["count"] == 3


def test_without_a_profiler_no_range_is_entered(monkeypatch):
    entered = []
    monkeypatch.setattr(trace, "record_function",
                        lambda name: entered.append(name))
    assert not torch.autograd._profiler_enabled()
    with trace.span("t.a"):
        with trace.scope("t.b"):
            with trace.span("t.c"):
                pass
    assert entered == []
    assert trace.scope("t.b") is trace.scope("t.d")


def test_pf_scope_is_the_facilitys():
    assert pf._scope is trace.scope
    assert pf.record_function is torch.profiler.record_function


def _annotations(prof):
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return {e["name"]: e for e in events
            if e.get("cat") == "user_annotation" and "dur" in e}


def test_spans_nest_inside_an_outer_range_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.outer"):
            with trace.span("t.call"):
                with trace.span("t.piece"):
                    torch.ones(8).sum()
                with trace.scope("t.scope"):
                    torch.ones(8).sum()
    ann = _annotations(prof)
    assert {"bench.outer", "t.call", "t.piece", "t.scope"} <= set(ann)

    def bounds(name):
        e = ann[name]
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    for inner, outer in (("t.call", "bench.outer"), ("t.piece", "t.call"),
                         ("t.scope", "t.call")):
        (a, b), (c, d) = bounds(inner), bounds(outer)
        assert c <= a and b <= d, (inner, outer)
    # the table holds the same calls, timed on the host
    got = trace.snapshot()
    assert got["t.call"]["count"] == got["t.piece"]["count"] == 1
    assert "t.scope" not in got


def _solver(program, k=6):
    A = laplacian_3d(k)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = program
    return A, cm, CholeskySolver(sym=analyze(A, cm), common=cm,
                                 device="cpu")


FACTOR_SPANS = ("super.factorize",
                "super.factorize.assemble", "super.factorize.upload",
                "super.factorize.program", "super.factorize.wait",
                "super.factorize.nan_scan")
SOLVE_SPANS = ("super.solve", "super.solve.bind",
               "super.solve.upload", "super.solve.program",
               "super.solve.wait", "super.solve.download")
ONCE = ("cholesky.analyze", "plan.super_symbolic", "plan.build_plan",
        "plan.value_map", "super.factorize.prepare")


@pytest.mark.parametrize("program", ["pf", "wave", "unrolled"])
def test_the_front_end_enters_each_span_once_per_call(program):
    A, cm, solver = _solver(program)
    n = A.shape[0]
    rounds = 3
    for i in range(rounds):
        # new values each round, so that every solve copies its factor in
        solver.refactorize(A if i % 2 == 0 else
                           A.__class__(A.indptr, A.indices, A.data * 2,
                                       A.shape))
        x = solver.solve(np.ones(n))
        assert np.isfinite(x).all()
    got = trace.snapshot()
    for name in FACTOR_SPANS + SOLVE_SPANS:
        assert got[name]["count"] == rounds, name
    for name in ONCE:
        assert got[name]["count"] == 1, name
    prog = {"pf": "pf", "wave": "wave", "unrolled": "unrolled"}[program]
    assert got[f"program.{prog}.body"]["count"] == 1
    # the CPU runs the body eagerly: no warm-up, capture or replay
    assert got[f"program.{prog}.eager"]["count"] == rounds
    assert got[f"program.{prog}.copy_in"]["count"] == rounds
    assert f"program.{prog}.replay" not in got
    assert f"program.{prog}.capture" not in got
    # the spans of one call nest as the code does
    parents = {c.parent for c in got["super.factorize.assemble"]["calls"]}
    assert parents == {"super.factorize"}
    parents = {c.parent for c in got[f"program.{prog}.clone"]["calls"]}
    assert parents == {"super.factorize/super.factorize.program"}
    # bytes: the values up, b up and x down, the result's clone
    itemsize = 8
    up = got["super.factorize.upload"]["calls"][-1]
    assert up.h2d > 0 and up.h2d % itemsize == 0
    assert got["super.solve.upload"]["h2d"] == rounds * n * itemsize
    assert got["super.solve.download"]["d2h"] == rounds * n * itemsize
    clone = got[f"program.{prog}.clone"]["calls"][-1]
    assert clone.d2d == solver.factor.Lx.numel() * itemsize
    bind = got["super.solve.bind"]["calls"][-1]
    assert bind.d2d >= solver.plan.total * itemsize
    whole = got["super.factorize"]["calls"][-1]
    assert whole.d2d >= clone.d2d and whole.h2d == up.h2d


def test_cm_info_factor_times_are_read_from_the_spans():
    A, cm, solver = _solver("pf")
    for _ in range(2):
        solver.refactorize(A)
    assert "factor_gflops" not in cm.info
    got = trace.snapshot()
    call = got["super.factorize"]["calls"][-1]
    parts = {p: got[f"super.factorize.{p}"]["calls"][-1].seconds
             for p in ("assemble", "program", "wait")}
    assert cm.info["factor_time"] == parts["program"] + parts["wait"]
    assert cm.info["factor_assemble_time"] == parts["assemble"]
    both = cm.info["factor_time"] + cm.info["factor_assemble_time"]
    # the upload and the NaN scan lie between them and the whole call
    assert 0.8 * call.seconds <= both <= call.seconds


def test_factorize_super_and_solve_super_called_directly():
    A, cm, solver = _solver("pf")
    sym = solver.sym
    ss = super_symbolic(A, sym, cm)
    plan = build_plan(ss)
    f = factorize_super(A, sym, ss, plan, cm, device="cpu")
    x = solve_super(f, np.ones(A.shape[0]))
    assert np.isfinite(x).all()
    got = trace.snapshot()
    for name in FACTOR_SPANS + SOLVE_SPANS:
        assert got[name]["count"] == 1, name
    assert got["super.factorize"]["calls"][0].parent == ""


def test_tic_toc_time_into_the_table():
    cm = default_common()
    cm.tic("t_key")
    time.sleep(0.002)
    t = cm.toc("t_key")
    assert t >= 0.002 and cm.info["time_t_key"] == t
    got = trace.snapshot()["common.t_key"]
    assert got["count"] == 1 and got["seconds"] == t
    # a toc without its tic adds nothing; a tic left open by an exception
    # does not become the parent of later spans
    assert cm.toc("never") == 0.0 and cm.info["time_never"] == 0.0
    cm.tic("left_open")
    with trace.span("t.after"):
        pass
    assert trace.snapshot()["t.after"]["calls"][0].parent == ""


def test_analyze_is_a_span_with_its_info_keys():
    A = laplacian_3d(5)
    cm = default_common()
    analyze(A, cm)
    got = trace.snapshot()["cholesky.analyze"]
    assert got["count"] == 1
    assert cm.info["analyze_time"] == got["seconds"] == \
        cm.info["time_analyze"]
    assert not any(k.startswith("_tic_") for k in cm.info)


def test_a_span_costs_little_with_the_profiler_off():
    """Host cost of a span with no profiler: a loose bound here, the card
    host's number goes into PERF.md."""
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("t.cost"):
            pass
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 50e-6
    assert trace.snapshot()["t.cost"]["count"] == n


def test_threads_keep_tables_of_their_own(monkeypatch):
    """Eight threads entering nested spans at once, with a short switch
    interval: every call is counted once, and each thread's spans nest
    only inside its own."""
    import sys
    import threading
    n, k = 8, 500
    errors = []

    def work(i):
        try:
            for _ in range(k):
                with trace.span(f"t.thread{i}"):
                    with trace.span("t.shared"):
                        trace.moved("d2d", 1)
        except Exception as exc:   # reported below
            errors.append(exc)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    got = trace.snapshot()
    shared = got["t.shared"]
    assert shared["count"] == n * k and shared["d2d"] == n * k
    assert {c.parent for c in shared["calls"]} == {
        f"t.thread{i}" for i in range(n)}
    starts = [c.start for c in shared["calls"]]
    assert starts == sorted(starts)
    for i in range(n):
        assert got[f"t.thread{i}"]["count"] == k
        assert got[f"t.thread{i}"]["d2d"] == k
