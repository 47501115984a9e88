"""Time the pf refactorization of one source tree, eager body and replay,
so that two versions of the factor program can be compared on one card.

    python3 suitesparse_tpu_torch/tools/bench_pf.py [--tree DIR]

imports ``suitesparse_tpu_torch`` from DIR (default: the tree that holds
this file), so a second tree unpacked beside the repository (for example
``git archive <commit> suitesparse_tpu_torch native | tar -x -C
build/parent``; without ``native/`` the tree orders lap3d_44 in Python,
which takes many minutes) runs with its own ``cholesky/pf.py`` and its
own kernel build.  Run the trees in turns (A, B, B, A) in one call to the
card.

It builds MATRIX's pf plan (lap3d_44) in float32 with the package's own
entry points (an older tree has none of the newer tools), captures
``pf_program``, then times ROUNDS rounds of the eager body and the replay,
each on the host clock ended by a sync, in an order that rotates from
round to round, and checks that every result equals the first replay's
bit for bit.  Where the tree's ``cholesky/pf.py`` has profiler ranges
(``pf._scope``), each round also runs the eager body with every range
entered through ``record_function`` ("eager_ranged", as if a profiler
listened) and with the ranges taken out ("eager_bare"), so that their
host cost is measured in pairs within the process; and the host cost of
one range is timed alone (RANGE_CALLS entries of ``pf._scope`` as
shipped and of ``record_function``), beside the ranges a body enters.
It prints one JSON line: the tree, the card's name and power limit
(nvidia-smi), the graph's node count, the times (medians, all rounds,
the medians of the per-round differences against eager_bare) and a
SHA-1 of the factor's bytes, so that two trees' factors can be compared.
It fails without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

MATRIX = "lap3d_44"
ROUNDS = 12
RANGE_CALLS = 100_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve()
                                          .parents[2]))
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_pf: no CUDA device", file=sys.stderr)
        return 2
    from suitesparse_tpu_torch.cholesky import analyze, super_symbolic
    from suitesparse_tpu_torch.cholesky import pf
    from suitesparse_tpu_torch.cholesky.super_numeric import (
        _assemble_values, build_plan)
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.io.generators import (symmetrize_upper,
                                                     synthetic_standin)
    if not pathlib.Path(pf.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"bench_pf: imported {pf.__file__}, not {tree}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    A = synthetic_standin(MATRIX)
    if A.stype == 0:
        A = symmetrize_upper(A)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    pfp = build_plan(ss).pf_plan(cm)
    vals = torch.as_tensor(_assemble_values(A, sym, ss, np.float32),
                           device="cuda")
    prog = pf.pf_program(pfp, np.float32, device="cuda")
    want = prog(vals)
    bodies = [("eager", prog.eager), ("replay", prog)]
    scoped = hasattr(pf, "_scope")
    if scoped:
        bodies += [("eager_ranged", _with_scope(pf, pf.record_function,
                                                prog.eager)),
                   ("eager_bare", _with_scope(
                       pf, lambda name: contextlib.nullcontext(),
                       prog.eager))]
    times = {key: [] for key, _ in bodies}
    for r in range(ROUNDS + 1):
        k = r % len(bodies)
        for key, fn in bodies[k:] + bodies[:k]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(vals)
            torch.cuda.synchronize()
            if r:
                times[key].append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(out, want):
                raise RuntimeError(f"bench_pf: {key} round {r} differs")
            del out
    res = dict(tree=str(tree), card=smi, matrix=MATRIX, rounds=ROUNDS,
               instr=int(len(pfp.instr_cls)), nodes=prog.nodes)
    for key, ts in times.items():
        res[f"{key}_ms"] = float(np.median(ts))
        res[f"{key}_ms_all"] = ts
    if scoped:
        for key in ("eager", "eager_ranged"):
            res[f"{key}_minus_bare_ms"] = float(np.median(
                np.subtract(times[key], times["eager_bare"])))
        entered = []
        _with_scope(pf, lambda name: entered.append(name) or
                    contextlib.nullcontext(), prog.eager)(vals)
        res["ranges_a_body"] = len(entered)
        res["range_host_us"] = {
            "shipped": _range_us(pf._scope),
            "record_function": _range_us(pf.record_function)}
    res["factor_sha1"] = hashlib.sha1(want.cpu().numpy().tobytes()).hexdigest()
    print(json.dumps(res), flush=True)
    return 0


def _with_scope(pf, scope, fn):
    """``fn`` run with pf's ranges entered through ``scope``."""
    def run(*args):
        saved = pf._scope
        pf._scope = scope
        try:
            return fn(*args)
        finally:
            pf._scope = saved
    return run


def _range_us(scope) -> float:
    """Host us a range of ``scope``, entered and left RANGE_CALLS times."""
    t0 = time.perf_counter()
    for _ in range(RANGE_CALLS):
        with scope("Fpotrf128x128"):
            pass
    return (time.perf_counter() - t0) / RANGE_CALLS * 1e6


if __name__ == "__main__":
    sys.exit(main())
