"""Spans the harness records around its own calls into the program, and
the reduction of a ``torch.profiler`` trace to what the per-layer metrics
read.

A span is a host interval around one call (``analyze``, ``refactorize``,
``solve``), kept in memory with the phase it fell in (``setup``, ``window``
or ``traced``).  While the profiler records, each span is also a
``record_function`` range named ``bench.<name>``, so that the trace shows
which call the host was in.

``reduce_trace`` joins each device operation of the trace to the call that
launched it by the trace's ``correlation`` id, and places the launch in
the harness span that encloses it (the arithmetic of the port's
``tools/profile_attrib.py``, copied).  A kernel of a replayed CUDA graph
carries the id of its ``cudaGraphLaunch``.  Every call the harness makes
returns host data, so a call's device work also ends inside its span; an
operation with no launch record is placed by its own start time.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

import torch

PREFIX = "bench."
WINDOW = "window"
# kernel-name fragments of each device-time group, first match wins
# (tools/profile_attrib.py's KERNEL_GROUPS)
KERNEL_GROUPS = (("block_chol", ("block_chol",)),
                 ("getrf", ("getrf", "getf2", "laswp", "lu_unpack",
                            "unpack_pivots")),
                 ("trsm", ("trsm", "trsv")),
                 ("gemm", ("gemm", "gemv", "cutlass", "xmma", "cublas")),
                 ("segment_reduce", ("segment",)),
                 ("index/scatter", ("index", "scatter", "gather", "put")),
                 ("cat/copy", ("cat", "copy", "memcpy", "memset")),
                 ("elementwise", ("elementwise", "vectorized", "unrolled")),
                 ("reduce", ("reduce",)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GRAPH_LAUNCH = "GraphLaunch"
TOP = 10


def kernel_group(name: str) -> str:
    low = name.lower()
    for g, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return g
    return "other"


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in union(intervals))


class Spans:
    """Host spans by phase and name, in seconds."""

    def __init__(self):
        self.phase = "setup"
        self.durations = collections.defaultdict(list)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = (torch.profiler.record_function(PREFIX + name)
               if self.profiling else contextlib.nullcontext())
        with rng:
            t = time.perf_counter()
            try:
                yield
            finally:
                self.durations[(self.phase, name)].append(
                    time.perf_counter() - t)

    def of(self, phase: str, name: str) -> list:
        return self.durations.get((phase, name), [])


def trace_events(prof) -> list:
    """The events of a finished profiler, through a Chrome trace written to
    and deleted from the process's temporary directory."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


class _SpanIndex:
    """The harness spans, sorted by start; they never overlap (the window
    that holds them all is kept apart)."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.spans[i][1]:
            return self.spans[i][2]
        return None

    def split(self, a: float, b: float):
        """(name, length) of the pieces of [a, b) inside each span, and of
        the rest (name None)."""
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        t = a
        while t < b:
            if i < len(self.spans) and self.spans[i][1] <= t:
                i += 1
                continue
            if i < len(self.spans) and self.spans[i][0] <= t:
                e = min(self.spans[i][1], b)
                yield self.spans[i][2], e - t
            else:
                e = min(self.spans[i][0], b) if i < len(self.spans) else b
                yield None, e - t
            t = e


def reduce_trace(events) -> dict:
    """What the per-layer metrics read from a trace whose host side holds
    one ``bench.window`` range around ``bench.<call>`` ranges:

    window_us, busy_us    the window's length and the union of every
                          device operation in it;
    calls                 {call: number of its spans in the window};
    graph_busy_us         {call: union of the kernels of the CUDA graphs
                          launched inside that call's spans};
    kernel_us, kernel_n   {call: {group: summed time / launches}};
    groups_us             {group: summed time} over the window;
    idle_us               {span the host was in: idle device time};
    ops, launched         device operations, and how many had a launch
                          record."""
    window = None
    spans = []
    launches = {}
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and "dur" in e \
                and e.get("name", "").startswith(PREFIX):
            s = float(e["ts"])
            iv = (s, s + float(e["dur"]), e["name"][len(PREFIX):])
            if iv[2] == WINDOW:
                window = iv
            else:
                spans.append(iv)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("name", ""))
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = window[0], window[1]
    index = _SpanIndex([s for s in spans if w0 <= s[0] < w1])
    calls = collections.Counter(s[2] for s in index.spans)
    graph_iv = collections.defaultdict(list)
    kernel_us = collections.defaultdict(collections.Counter)
    kernel_n = collections.defaultdict(collections.Counter)
    groups = collections.Counter()
    every = []
    n_ops = n_launched = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s = float(e["ts"])
        d = float(e["dur"])
        if s < w0 or s >= w1:
            continue
        n_ops += 1
        launch = launches.get(e.get("args", {}).get("correlation"))
        n_launched += launch is not None
        call = index.at(launch[0] if launch else s) or "harness"
        g = kernel_group(e.get("name", ""))
        iv = (s, min(s + d, w1))
        every.append(iv)
        if launch is not None and GRAPH_LAUNCH in launch[1]:
            graph_iv[call].append(iv)
        kernel_us[call][g] += d
        kernel_n[call][g] += 1
        groups[g] += d
    merged = union(every)
    idle = collections.Counter()
    edges = [w0] + [t for iv in merged for t in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        for name, d in index.split(a, b):
            idle[name or "harness"] += d
    return dict(window_us=w1 - w0, busy_us=sum(e - s for s, e in merged),
                calls=dict(calls),
                graph_busy_us={c: busy(iv) for c, iv in graph_iv.items()},
                kernel_us={c: dict(v) for c, v in kernel_us.items()},
                kernel_n={c: dict(v) for c, v in kernel_n.items()},
                groups_us=dict(groups), idle_us=dict(idle),
                ops=n_ops, launched=n_launched)


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the kernel groups that took most
    device time and the idle time by the call the host was in, in
    seconds, at most TOP of each."""
    top = lambda d: [[k, v / 1e6] for k, v in  # noqa: E731
                     collections.Counter(d).most_common(TOP)]
    return dict(device_ops=top(summary["groups_us"]),
                idle_gaps=top(summary["idle_us"]))
