"""Spans and byte counters of the port: one process-wide table of host
timings, and ``torch.profiler`` ranges while a profiler records.

``scope(name)``
    A profiler range (``record_function``) while a profiler records, else
    a shared no-op that costs one flag test.  For the phase labels of an
    eager program body (``cholesky/pf.py``), which runs thousands of them
    and is timed on the device, not on the host.
``span(name)``
    The same range, plus a host timing that is always on: on leaving, the
    span's call count, seconds and bytes go into the table under ``name``.
    Spans nest per thread; a span's bytes include those of the spans inside
    it.  ``spanned(name)`` makes a function's every call a span.
``moved(direction, nbytes)``
    Bytes that the code inside the innermost open span copies: ``"h2d"``
    (host to the program's device), ``"d2h"``, or ``"d2d"`` (within the
    device).  On the CPU the device is the host, so they count host copies.
``count(name, n)``
    Adds ``n`` to the process-wide counter ``name`` (``counts()`` reads
    them): how often something ran where a span's calls do not say it
    (PageRank's iterations and predicated steps).

A span reads the host's clock and never the device's: it never
synchronizes, reads no device value and allocates nothing on the device.
Where the program waits for the device, the wait has a span of its own.
While a profiler records, each span is also a ``record_function`` range
named as in the table, so that it lies in the trace on the trace's clock
with the kernels it launched.

Reading the table (the operator's API)::

    snapshot() -> {name: {"count":   calls so far,
                          "seconds": their summed seconds,
                          "h2d", "d2h", "d2d": their summed bytes,
                          "first":   the index (0 for the first call ever)
                                     of the first call in "calls",
                          "calls":   the last RING calls, oldest first, as
                                     Call(start, seconds, h2d, d2h, d2d,
                                     parent)}}

``start`` is ``time.perf_counter()`` at entry and ``parent`` the names of
the spans open around the call, outermost first, joined by "/" ("" at the
top), so that a reader can take the calls of one phase by index or by time
and a span's children by their parent.  ``reset()`` empties the table.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import torch
from torch.profiler import record_function

__all__ = ["Call", "RING", "Span", "count", "counts", "moved", "nbytes",
           "reset", "scope", "snapshot", "span", "spanned"]

# calls kept per name
RING = 65536
Call = collections.namedtuple("Call", "start seconds h2d d2h d2d parent")

_NO_RANGE = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled
_now = time.perf_counter
_local = threading.local()
_lock = threading.Lock()
_threads: list = []         # each thread's _State, for snapshot()


class _Stat:
    __slots__ = ("count", "seconds", "h2d", "d2h", "d2d", "calls")

    def __init__(self):
        self.count = 0
        self.seconds = 0.0
        self.h2d = self.d2h = self.d2d = 0
        self.calls = collections.deque(maxlen=RING)


class _State:
    """One thread's open spans, table and counters: a span touches no
    lock."""

    __slots__ = ("stack", "table", "counts")

    def __init__(self):
        self.stack = []
        self.table = {}
        self.counts = {}


def _new_state() -> _State:
    state = _local.state = _State()
    with _lock:
        _threads.append(state)
    return state


def scope(name: str):
    """The profiler range ``name`` while a profiler records, else a shared
    no-op: an unrecorded ``record_function`` still costs ~10 us of host
    time, and a lap3d_44 pf body enters 1,300."""
    if _profiling():
        return record_function(name)
    return _NO_RANGE


class Span:
    """One call of the span ``name``; ``seconds`` holds its duration once
    it has been left.  ``nest=False`` (``Common.tic``/``toc``, which may be
    left unbalanced by an exception) times the call without opening a
    profiler range or taking the bytes of the code inside it."""

    __slots__ = ("name", "nest", "range", "start", "seconds", "up", "_path",
                 "state", "h2d", "d2h", "d2d")

    def __init__(self, name: str, nest: bool = True):
        self.name = name
        self.nest = nest
        self.seconds = 0.0

    @property
    def path(self) -> str:
        """The names of this span and of those open around it, "/"."""
        if self._path is None:
            up = self.up
            self._path = (self.name if up is None
                          else up.path + "/" + self.name)
        return self._path

    def __enter__(self) -> "Span":
        try:
            state = _local.state
        except AttributeError:
            state = _new_state()
        self.state = state
        stack = state.stack
        self.up = stack[-1] if stack else None
        self._path = None
        self.h2d = self.d2h = self.d2d = 0
        self.range = None
        if self.nest:
            if _profiling():
                self.range = record_function(self.name)
                self.range.__enter__()
            stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, et, ev, tb) -> None:
        seconds = self.seconds = _now() - self.start
        copied = self.h2d or self.d2h or self.d2d
        if self.nest:
            stack = self.state.stack
            # an unbalanced span opened inside this one leaves with it
            while stack and stack.pop() is not self:
                pass
            if stack and copied:
                top = stack[-1]
                top.h2d += self.h2d
                top.d2h += self.d2h
                top.d2d += self.d2d
            if self.range is not None:
                self.range.__exit__(et, ev, tb)
        table = self.state.table
        st = table.get(self.name)
        if st is None:
            st = table[self.name] = _Stat()
        st.count += 1
        st.seconds += seconds
        if copied:
            st.h2d += self.h2d
            st.d2h += self.d2h
            st.d2d += self.d2d
        up = self.up
        st.calls.append((self.start, seconds, self.h2d, self.d2h, self.d2d,
                         "" if up is None else up.path))


# a span to enter with ``with``: ``with span("super.solve.wait"):``
span = Span


def spanned(name: str):
    """Decorator: every call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def moved(direction: str, n: int) -> None:
    """Record ``n`` bytes copied in ``direction`` ("h2d", "d2h" or "d2d")
    in the innermost open span of this thread (nowhere if none is open)."""
    state = getattr(_local, "state", None)
    if state is not None and state.stack:
        top = state.stack[-1]
        setattr(top, direction, getattr(top, direction) + int(n))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to this thread's share of the counter ``name``."""
    try:
        state = _local.state
    except AttributeError:
        state = _new_state()
    state.counts[name] = state.counts.get(name, 0) + int(n)


def counts() -> dict:
    """{name: every thread's count summed}, copied."""
    with _lock:
        states = list(_threads)
    out = {}
    for state in states:
        for name, n in list(state.counts.items()):
            out[name] = out.get(name, 0) + n
    return out


def nbytes(obj) -> int:
    """Bytes of a tensor, or of nested tuples and lists of tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return sum(nbytes(o) for o in obj)


def snapshot() -> dict:
    """The table, copied: every thread's calls of a name together, in the
    order they started (see the module's docstring)."""
    with _lock:
        states = list(_threads)
    out = {}
    for state in states:
        for name, st in list(state.table.items()):
            got = out.setdefault(name, dict(count=0, seconds=0.0, h2d=0,
                                            d2h=0, d2d=0, calls=[]))
            got["count"] += st.count
            got["seconds"] += st.seconds
            got["h2d"] += st.h2d
            got["d2h"] += st.d2h
            got["d2d"] += st.d2d
            got["calls"] += list(st.calls)
    for got in out.values():
        calls = sorted(got["calls"])[-RING:] if len(states) > 1 \
            else got["calls"]
        got["calls"] = [Call._make(c) for c in calls]
        got["first"] = got["count"] - len(calls)
    return out


def reset() -> None:
    """Empty the table and the counters (every thread's) and this thread's
    stack of open spans."""
    with _lock:
        for state in _threads:
            state.table.clear()
            state.counts.clear()
    state = getattr(_local, "state", None)
    if state is not None:
        state.stack.clear()
