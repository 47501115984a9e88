"""Per-phase attribution of the pf refactorization from a device profile:
the counterpart of tools/profile_attrib.py.

    python -m suitesparse_tpu_torch.tools.profile_attrib [matrix] [detail]

Builds the matrix's pf plan (default lap3d_28; ``detail`` adds the top 30
scopes and the top unattributed kernels), captures its ``pf_program``,
warms up, then profiles one run of the program's eager body under
``torch.profiler`` (CPU + CUDA).  ``cholesky/pf.py`` runs each piece of a
factor wave, and the assembly, in a ``record_function`` range labelled as
the reference's named scopes (``Fslice``, ``Fpotrf``, ``Fsyrk``,
``Fwrite``, ``Fscat`` per factor class; ``Assemble``), and each pair
projection in one range ``Qextend`` per pair class, around its extend-add
kernel (the reference's ``Qgather``, ``QplaceW``, ``QplaceR``,
``Qeinsum`` and ``Qscat``, which the pattern still reads in a trace of an
older tree).  Ranges exist only where kernels are launched
from the host, so the attribution is taken on the eager body; a replay of
the captured graph is then profiled in the same call for its device busy
time and kernel count, printed beside the eager run's.

Each device kernel goes to the innermost scope whose host range encloses
its launch: the kernel is joined to the CUDA API call that launched it by
the trace's ``correlation`` id, and the call is placed inside the
``user_annotation`` ranges of its own thread by time.  This does not rely
on torch operators: ``block_chol``, launched through ctypes
(``utils.cuda_build.launch``), lands in ``Fpotrf`` all the same.

``idle_by_range`` puts a trace's idle device time down to the innermost
host range open over it.  In a trace of the front end those ranges are
the program's spans (``utils/trace``): unlike the scopes, they exist
around a replay too.

Printed, as the reference prints them: the coarse phases (the scope's
prefix) in ms and %, and with ``detail`` the top scopes and the top
unattributed kernels; beyond the reference, a cross-table of phase by
kernel group (``KERNEL_GROUPS``).  ``attribute`` and ``summarize`` (and
``idle_by_range``) are pure functions of a parsed Chrome trace.

On the CPU (``device="cpu"``) no device time exists: the run records the
scopes' ranges only (their labels and counts).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["KERNEL_GROUPS", "SCOPE_RE", "attribute", "attribute_pf",
           "busy_us", "idle_by_range", "kernel_group", "pf_setup",
           "phase_of", "scope_of", "summarize", "trace_events"]

# the reference's scope pattern (tools/profile_attrib.py:57-59) and the
# port's Qextend, applied to "/" + a range's name
SCOPE_RE = re.compile(
    r"/((?:F(?:slice|potrf|syrk|write|scat)|"
    r"Q(?:gather|place|einsum|scat|extend)|Assemble)[\w]*)")
UNATTRIBUTED = "(unattributed)"
NO_RANGE = "(no range)"
# kernel-name fragments of each device-time group, first match wins
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
TOP_SCOPES = 30
TOP_UNATTRIBUTED = 12


def scope_of(name: str):
    """The scope label a range name carries (the last hit of SCOPE_RE),
    or None."""
    hits = SCOPE_RE.findall("/" + name)
    return hits[-1] if hits else None


def phase_of(scope) -> str:
    """The coarse phase of a scope: its letters (Fpotrf, QplaceW, ...)."""
    if scope is None:
        return UNATTRIBUTED
    return re.match(r"[A-Za-z]+", scope).group(0)


def kernel_group(name: str, groups=KERNEL_GROUPS) -> str:
    low = name.lower()
    for g, keys in groups:
        if any(k in low for k in keys):
            return g
    return "other"


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    """One kernel, copy or set of the trace, with its scope (None: its
    launch lies in no scope, or the trace has no launch call for it)."""

    name: str
    ts: float
    dur: float
    scope: object
    launched: bool


def attribute(events) -> list:
    """Each device op of ``events`` (Chrome-trace event dicts) with the
    innermost scope whose host range, on the launching thread, encloses
    the launch call that shares its ``correlation`` id."""
    launch = {}
    ranges = collections.defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], float(e["ts"]))
        elif cat == "user_annotation" and "dur" in e:
            sc = scope_of(e["name"])
            if sc is not None:
                ts = float(e["ts"])
                ranges[e["tid"]].append((ts, ts + float(e["dur"]), sc))
    by_tid = collections.defaultdict(list)
    for corr, (tid, ts) in launch.items():
        by_tid[tid].append((ts, corr))
    scope = {}
    for tid, calls in by_tid.items():
        # ranges nest on one thread: sweep in time order with a stack of
        # the open ones (outer first at equal starts)
        rs = sorted(ranges.get(tid, ()), key=lambda r: (r[0], -r[1]))
        stack, i = [], 0
        for ts, corr in sorted(calls):
            while i < len(rs) and rs[i][0] <= ts:
                stack.append(rs[i])
                i += 1
            while stack and stack[-1][1] <= ts:
                stack.pop()
            open_ = [r for r in stack if r[1] > ts]
            scope[corr] = open_[-1][2] if open_ else None
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            corr = e.get("args", {}).get("correlation")
            out.append(DeviceOp(e["name"], float(e["ts"]), float(e["dur"]),
                                scope.get(corr), corr in launch))
    return out


def summarize(ops) -> dict:
    """Tables of attributed device ops (``attribute``'s result), in ms:
    total (sum of durations) and busy (their union), per coarse phase,
    per scope, per phase and kernel group (time and count), and the
    unattributed ops by name."""
    phase = collections.Counter()
    scope = collections.Counter()
    cross = collections.defaultdict(collections.Counter)
    count = collections.defaultdict(collections.Counter)
    unattributed = collections.Counter()
    unlaunched = 0
    for op in ops:
        ph = phase_of(op.scope)
        g = kernel_group(op.name)
        phase[ph] += op.dur
        cross[ph][g] += op.dur
        count[ph][g] += 1
        if op.scope is None:
            unattributed[op.name] += op.dur
            unlaunched += not op.launched
        else:
            scope[op.scope] += op.dur
    total = sum(phase.values())
    ms = lambda c: {k: v / 1e3 for k, v in c.most_common()}  # noqa: E731
    return dict(
        ops=len(ops), total_ms=total / 1e3,
        busy_ms=busy_us([(o.ts, o.ts + o.dur) for o in ops]) / 1e3,
        attributed_share=(1.0 - phase[UNATTRIBUTED] / total) if total
        else 0.0,
        phase_ms=ms(phase), scope_ms=ms(scope),
        cross_ms={ph: ms(c) for ph, c in cross.items()},
        cross_count={ph: dict(c) for ph, c in count.items()},
        unattributed_ms=ms(unattributed), no_launch_record=unlaunched)


def idle_by_range(events, window=None) -> dict:
    """Idle device time of a trace put down to the innermost host range
    open over it.

    The window is the first ``user_annotation`` range named ``window``
    (else the extent of the device operations); the host ranges are those
    of its thread (else of the thread holding the most ranges).  Idle time
    is the window less the union of every device operation (kernel, copy,
    set); each idle piece goes to the innermost range that encloses it at
    that time, NO_RANGE where none does.  Returns, in microseconds,
    {"window_us", "busy_us", "idle_us": {range name: idle},
    "ranges": {range name: ranges starting in the window}}."""
    ranges = collections.defaultdict(list)
    ops = []
    for e in events:
        cat = e.get("cat")
        if "dur" not in e:
            continue
        ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat == "user_annotation":
            ranges[e["tid"]].append((ts, te, e["name"]))
        elif cat in DEVICE_CATS:
            ops.append((ts, te))
    found = [(tid, r) for tid, rs in ranges.items() for r in rs
             if window is not None and r[2] == window]
    if window is not None and not found:
        raise ValueError(f"the trace holds no range {window!r}")
    if found:
        tid, (w0, w1, _) = min(found, key=lambda f: f[1][0])
    else:
        if not ops:
            raise ValueError("the trace holds no device operation")
        tid = max(ranges, key=lambda t: len(ranges[t])) if ranges else None
        w0, w1 = min(s for s, _ in ops), max(e for _, e in ops)
    busy = []
    for s, e in sorted(ops):
        s, e = max(s, w0), min(e, w1)
        if s >= e:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = e
    if t < w1:
        gaps.append((t, w1))
    # ranges nest on one thread: sweep the gaps' pieces in time order with
    # a stack of the open ranges (outer first at equal starts)
    rs = sorted((r for r in ranges.get(tid, ()) if r[1] > w0 and r[0] < w1),
                key=lambda r: (r[0], -r[1]))
    cuts = sorted({w0, w1, *(t for r in rs for t in r[:2] if w0 < t < w1),
                   *(t for g in gaps for t in g)})
    idle = collections.Counter()
    stack, i, g = [], 0, 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(rs) and rs[i][0] <= a:
            stack.append(rs[i])
            i += 1
        stack = [r for r in stack if r[1] > a]
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        if g < len(gaps) and gaps[g][0] <= a:
            idle[stack[-1][2] if stack else NO_RANGE] += b - a
    return dict(window_us=w1 - w0,
                busy_us=sum(e - s for s, e in busy),
                idle_us=dict(idle.most_common()),
                ranges=dict(collections.Counter(
                    r[2] for r in rs if w0 <= r[0] < w1)))


def trace_events(prof, path=None) -> list:
    """The events of a finished ``torch.profiler.profile``, through its
    Chrome trace (kept at ``path`` when given)."""
    if path is not None:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    with tempfile.TemporaryDirectory() as d:
        return trace_events(prof, os.path.join(d, "trace.json"))


def _profile(fn, dev: torch.device, path=None) -> list:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return trace_events(prof, path)


def scope_ranges(events) -> collections.Counter:
    """How many ranges of each scope label the trace holds."""
    return collections.Counter(
        e["name"] for e in events if e.get("cat") == "user_annotation"
        and scope_of(e["name"]) == e["name"])


def attribute_pf(prog, vals, trace_dir=None, name="pf") -> dict:
    """Attribute one eager run of the pf program ``prog`` on ``vals``, and
    on the card profile one replay: the scope ranges recorded, the eager
    run's tables (``summarize``), and the eager and replay device busy
    times and kernel counts.  The traces are kept under ``trace_dir``
    when given."""
    dev = prog.device
    path = (lambda tag: None if trace_dir is None else os.path.join(
        trace_dir, f"attrib_{name}_{tag}.json"))
    prog(vals)                     # captured (on the card) and warm
    prog.eager(vals)
    ev = _profile(lambda: prog.eager(vals), dev, path("eager"))
    out = dict(scope_ranges=dict(scope_ranges(ev)), device=str(dev))
    if dev.type != "cuda":
        return out
    ops = attribute(ev)
    if not ops:
        raise RuntimeError(f"{name}: the profile recorded no device work")
    out["eager"] = summarize(ops)
    rops = attribute(_profile(lambda: prog(vals), dev, path("replay")))
    if not rops:
        raise RuntimeError(f"{name}: the replay's profile recorded no "
                           f"device work")
    out["replay"] = dict(
        ops=len(rops), total_ms=sum(o.dur for o in rops) / 1e3,
        busy_ms=busy_us([(o.ts, o.ts + o.dur) for o in rops]) / 1e3)
    return out


def pf_setup(name: str, device=None):
    """(A, sym, pf plan, float32 values tensor) of the synthetic matrix
    ``name`` (lap3d_28, fem3d_80000, ...), with the reference tools'
    options: the supernodal pf program."""
    from ..cholesky import analyze, super_symbolic
    from ..cholesky.super_numeric import _assemble_values, build_plan
    from ..core.common import default_common
    from ..io.generators import symmetrize_upper, synthetic_standin
    dev = resolve_device(device)
    A = synthetic_standin(name)
    if A is None:
        raise ValueError(f"{name!r} is not a synthetic matrix name")
    if A.stype == 0:
        A = symmetrize_upper(A)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    pfp = build_plan(ss).pf_plan(cm)
    vals = torch.as_tensor(_assemble_values(A, sym, ss, np.float32),
                           device=dev)
    return A, sym, pfp, vals


def _table(rows: dict, total_ms: float, width: int) -> None:
    for k, v in rows.items():
        print(f"  {k:{width}s} {v:9.2f} ms  {100.0 * v / total_ms:5.1f}%")


def print_attribution(res: dict, detail: bool = False) -> None:
    """The reference's tables, and the phase x kernel group cross-table."""
    if "eager" not in res:
        n = sum(res["scope_ranges"].values())
        print(f"device time: not measured ({res['device']}); {n} scope "
              f"ranges of {len(res['scope_ranges'])} labels", flush=True)
        return
    s, r = res["eager"], res["replay"]
    print(f"\ndevice total (eager body): {s['total_ms']:.2f} ms over "
          f"{s['ops']} device ops, busy {s['busy_ms']:.2f} ms, "
          f"{100 * s['attributed_share']:.1f}% attributed; replay busy "
          f"{r['busy_ms']:.2f} ms over {r['ops']} ops\n\n== coarse phases ==")
    _table(s["phase_ms"], s["total_ms"], 14)
    groups = sorted({g for c in s["cross_ms"].values() for g in c})
    print("\n== phase x kernel group (ms) ==")
    print("  " + " " * 14 + "".join(f"{g[:13]:>14s}" for g in groups))
    for ph in s["phase_ms"]:
        c = s["cross_ms"][ph]
        print(f"  {ph:14s}" + "".join(f"{c.get(g, 0.0):14.2f}"
                                      for g in groups))
    if detail:
        print(f"\n== top {TOP_SCOPES} scopes ==")
        _table(dict(list(s["scope_ms"].items())[:TOP_SCOPES]),
               s["total_ms"], 20)
        print("\n== top unattributed kernels ==")
        for nm, v in list(s["unattributed_ms"].items())[:TOP_UNATTRIBUTED]:
            print(f"  {nm[:60]:60s} {v:9.2f} ms")
    sys.stdout.flush()


def main(name: str = "lap3d_28", detail: bool = False,
         device=None) -> dict:
    """Build ``name``'s pf plan on ``device`` (the card unless "cpu" is
    asked for), attribute one refactorization and print the tables."""
    from ..cholesky.pf import pf_program
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    A, sym, pfp, vals = pf_setup(name, dev)
    prog = pf_program(pfp, np.float32, device=dev)
    t0 = time.perf_counter()
    prog(vals)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[{name}] fl={sym.flops:.3g} instr={len(pfp.instr_cls)} "
          f"first-call {time.perf_counter() - t0:.1f}s", flush=True)
    res = attribute_pf(prog, vals, name=name)
    print_attribution(res, detail)
    return res


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "lap3d_28",
         "detail" in sys.argv[2:])
