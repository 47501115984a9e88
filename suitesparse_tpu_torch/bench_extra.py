"""Package benchmarks beyond supernodal Cholesky: KLU, UMFPACK, SPQR and
GraphBLAS, each in the reference's own units.

    python -m suitesparse_tpu_torch.bench_extra [klu|umfpack|spqr|graphblas ...]
        [--klu M] [--umfpack M] [--spqr M] [--graphblas M] [--pagerank M]
        [--device cuda|cpu] [--out DIR]

The counterpart of the repository's ``bench_extra.py``, on the card unless
``--device cpu`` is asked for:

  klu        host ``klu_analyze``/``klu_factor``, then ``klu_device``'s
             refactor and solve programs; rate per the factor's flop count
             (klu_diagnostics.c)                   default circuit_20000
  umfpack    ``umf_symbolic``, the first ``umf_numeric``, refactors with
             the symbolic reused, ``umf_solve`` and its residual
                                                   default randunsym_20000
  spqr       ``qr_factorize`` refactors, ``qr_solve`` and ||A'r||
             (Franz6_id1959_aug; randunsym_5000 when that fixture is absent)
  graphblas  the plus_times SpGEMM of a pattern through ``cached_plan`` +
             ``spgemm_apply`` (lap3d_40), and 50 PageRank iterations
             (bcspwr10; the SpGEMM's matrix when that fixture is absent)

Only those two default fixtures fall back; a matrix named on the command
line that is missing fails the run.

Every timed region ends in ``torch.cuda.synchronize()``.  Each package runs
in a process of its own and prints its row on a ``RESULT:`` line; a package
that fails ends the run with a nonzero exit.  ``DIR`` (default
``build/bench`` in the checkout) receives ``extra.json``; nothing else is
written.  The last line of stdout is ``RESULT:`` and the JSON list of rows.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from .bench import DEFAULT_OUT, _sync, child_row, log
from .utils.device import default_dtype, resolve_device

__all__ = ["BENCHES", "bench_graphblas", "bench_klu", "bench_spqr",
           "bench_umfpack", "main"]

ONE_TIMEOUT = 5400           # seconds a package's process may take
# the reference's default fixtures; only these fall back when absent
SPQR_DEFAULT = "Franz6_id1959_aug"
PAGERANK_DEFAULT = "bcspwr10"


def timed(fn, dev: torch.device, repeats: int = 5) -> float:
    """s per call: one untimed call, then ``repeats`` calls ended by one
    sync (bench_extra.py:28-35)."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / repeats


def _omega(S, x, b) -> float:
    """||Sx - b||inf / (||S||inf ||x||inf + 1), the reference's residual
    for b = ones."""
    return float(np.abs(S @ x - b).max()
                 / (np.abs(S).sum(axis=1).max() * np.abs(x).max() + 1.0))


def _get(name: str):
    from .io import collection
    return collection.get(name)


def _get_or(name: str, default: str, fallback: str):
    """(name, matrix) of ``name``; when ``name`` is the reference's
    default fixture and it is absent, of ``fallback`` instead.  A matrix
    named otherwise that is missing raises."""
    try:
        return name, _get(name)
    except FileNotFoundError:
        if name != default:
            raise
    return fallback, _get(fallback)


def bench_klu(name: str = "circuit_20000", repeats: int = 10,
              device=None) -> dict:
    """KLU: the device refactor twin and the BTF level-set solve on a
    circuit-class matrix (klu_refactor.c: same pattern, new values, no
    pivoting); rate per the factor's flop count."""
    from .lu.klu import klu_analyze, klu_factor
    from .lu.klu_device import klu_device
    dev = resolve_device(device)
    A = _get(name)
    n = A.ncol
    sym = klu_analyze(A)
    t0 = time.perf_counter()
    num = klu_factor(A, sym)
    t_first = time.perf_counter() - t0
    plan, refactor, solve = klu_device(A, sym, num, device=dev)
    dt = np.dtype(default_dtype(dev))
    avals = torch.as_tensor(A.data.astype(dt), device=dev)
    t_re = timed(lambda: refactor(avals)[0][-1], dev, repeats)
    factors, Rs, ok = refactor(avals)
    b = torch.ones(n, dtype=avals.dtype, device=dev)
    t_sv = timed(lambda: solve(factors, Rs, avals, b), dev, repeats)
    x = solve(factors, Rs, avals, b).double().cpu().numpy()
    res = _omega(A.to_scipy().astype(np.float64), x, 1.0)
    log(f"[klu:{name}] n={n} nnz={A.nnz} fl={num.flops:.4g} host-first "
        f"{t_first:.3f} s; device refactor {t_re * 1e3:.3f} ms "
        f"({num.flops / t_re / 1e6:.1f} Mflop/s), solve {t_sv * 1e3:.3f} "
        f"ms, residual {res:.2e}")
    return {
        "metric": f"klu_device_refactor_ms[{name}]",
        "value": t_re * 1e3, "unit": "ms",
        "n": n, "nnz": int(A.nnz), "flops": float(num.flops),
        "refactor_mflops": num.flops / t_re / 1e6,
        "solve_ms": t_sv * 1e3, "residual": res,
        "host_factor_s": t_first, "device": dev.type,
    }


def _panel_entries(num) -> int:
    """Entries of the numeric's L and U panels; a numeric split into BTF
    blocks sums its blocks' (the reference takes the size of the top-level
    arrays, which such a numeric does not have)."""
    if num.Lb is not None:
        return int(num.Lb.numel() + num.Ub.numel())
    return sum(_panel_entries(b) for b in num.bnums if b is not None)


def bench_umfpack(name: str = "randunsym_20000", repeats: int = 5,
                  device=None) -> dict:
    """UMFPACK class: the multifrontal LU refactorization of an
    unsymmetric pattern with its symbolic analysis reused (umfpack.h's
    Info[NUMERIC_TIME] protocol)."""
    from .lu.multifrontal import umf_numeric, umf_solve, umf_symbolic
    dev = resolve_device(device)
    A = _get(name)
    n = A.ncol
    t0 = time.perf_counter()
    S = umf_symbolic(A)
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    num = umf_numeric(A, S, device=dev)          # capture + first numeric
    _sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(repeats):
        num = umf_numeric(A, S, device=dev)      # pattern fixed
    _sync(dev)
    t_num = (time.perf_counter() - t0) / repeats
    x = umf_solve(num, np.ones(n))
    res = _omega(A.to_scipy().astype(np.float64), x, 1.0)
    lnz = _panel_entries(num)
    log(f"[umfpack:{name}] n={n} nnz={A.nnz} symbolic {t_sym:.2f} s "
        f"first-numeric {t_first:.2f} s refactor {t_num * 1e3:.1f} ms "
        f"residual {res:.2e}")
    return {
        "metric": f"umfpack_refactor_ms[{name}]",
        "value": t_num * 1e3, "unit": "ms",
        "n": n, "nnz": int(A.nnz), "panel_entries": lnz,
        "symbolic_s": t_sym, "first_numeric_s": t_first, "residual": res,
        "device": dev.type,
    }


def bench_spqr(name: str = SPQR_DEFAULT, repeats: int = 5,
               device=None) -> dict:
    """SPQR: the rank-revealing multifrontal QR and the least-squares
    solve (SuiteSparseQR's backslash, qrdemo.cpp); randunsym_5000 when
    the default fixture is absent (bench_extra.py:123-127)."""
    from .qr.spqr import qr_factorize, qr_solve, qr_symbolic
    dev = resolve_device(device)
    name, A = _get_or(name, SPQR_DEFAULT, "randunsym_5000")
    m, n = A.nrow, A.ncol
    S = qr_symbolic(A)
    t0 = time.perf_counter()
    num = qr_factorize(A, S, device=dev)
    _sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(repeats):
        num = qr_factorize(A, S, device=dev)
    _sync(dev)
    t_fac = (time.perf_counter() - t0) / repeats
    b = np.ones(m)
    x = qr_solve(A, b, device=dev)
    Sf = A.to_scipy().astype(np.float64)
    atr = float(np.abs(Sf.T @ (Sf @ x - b)).max())
    log(f"[spqr:{name}] {m}x{n} nnz={A.nnz} rank={num.rank} first "
        f"{t_first:.2f} s factor {t_fac * 1e3:.1f} ms ||A'r|| {atr:.2e}")
    return {
        "metric": f"spqr_factorize_ms[{name}]",
        "value": t_fac * 1e3, "unit": "ms",
        "m": m, "n": n, "nnz": int(A.nnz), "rank": int(num.rank),
        "lsq_optimality": atr, "first_s": t_first, "device": dev.type,
    }


def bench_graphblas(name: str = "lap3d_40",
                    pagerank_name: str = PAGERANK_DEFAULT,
                    repeats: int = 10, device=None) -> dict:
    """GraphBLAS: the plus_times SpGEMM (GB_AxB_saxpy3 class) and the
    PageRank loop program (dpagerank.c)."""
    from .graphblas.algorithms import pagerank
    from .ops.spgemm import cached_plan, spgemm_apply
    dev = resolve_device(device)
    A = _get(name)
    if A.stype != 0:
        A = A.to_full_storage()
    n = A.ncol
    plan = cached_plan(A, A)
    av = A.data if A.data is not None else np.ones(A.nnz)
    t_mxm = timed(lambda: spgemm_apply(plan, av, av, "plus_times",
                                       device=dev), dev, repeats)
    mxm_rate = 2.0 * plan.flops / t_mxm / 1e6
    gname, G = _get_or(pagerank_name, PAGERANK_DEFAULT, name)
    if G.stype != 0:
        G = G.to_full_storage()
    t0 = time.perf_counter()
    pagerank(G, max_iter=50, tol=0.0, device=dev)
    t_first = time.perf_counter() - t0
    reps = max(repeats // 2, 1)
    t0 = time.perf_counter()
    for _ in range(reps):
        r = pagerank(G, max_iter=50, tol=0.0, device=dev)
    t_pr = (time.perf_counter() - t0) / reps
    edges_per_s = 50.0 * G.nnz / t_pr
    log(f"[graphblas] mxm[{name}] n={n} flops={plan.flops:.4g} "
        f"{t_mxm * 1e3:.3f} ms ({mxm_rate:.0f} Mflop/s); pagerank[{gname}] "
        f"n={G.ncol} 50 iters {t_pr * 1e3:.2f} ms "
        f"({edges_per_s / 1e6:.1f} Medge/s)")
    return {
        "metric": f"graphblas_mxm_mflops[{name}]",
        "value": mxm_rate, "unit": "Mflop/s",
        "mxm_ms": t_mxm * 1e3, "mxm_flops": int(plan.flops),
        "pagerank_matrix": gname, "pagerank_ms_50it": t_pr * 1e3,
        "pagerank_first_s": t_first,
        "pagerank_medges_per_s": edges_per_s / 1e6,
        "pagerank_sum": float(np.sum(r)), "device": dev.type,
    }


BENCHES = {
    "klu": bench_klu,
    "umfpack": bench_umfpack,
    "spqr": bench_spqr,
    "graphblas": bench_graphblas,
}


def _run_one(key: str, args) -> dict:
    """``key``'s row from a process of its own."""
    argv = ["--one", key, "--device", args.device, "--out", str(args.out)]
    for k in (*BENCHES, "pagerank"):
        if getattr(args, k):
            argv += [f"--{k}", getattr(args, k)]
    return child_row("suitesparse_tpu_torch.bench_extra", argv, ONE_TIMEOUT,
                     f"[extra] {key}")


def _run_in_process(key: str, args) -> dict:
    kw = {"device": args.device}
    if getattr(args, key):
        kw["name"] = getattr(args, key)
    if key == "graphblas" and args.pagerank:
        kw["pagerank_name"] = args.pagerank
    return BENCHES[key](**kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m suitesparse_tpu_torch.bench_extra",
        description="KLU, UMFPACK, SPQR and GraphBLAS rows in the "
                    "reference's units.")
    ap.add_argument("which", nargs="*", metavar="PACKAGE",
                    help=f"of {', '.join(BENCHES)} (default: all four)")
    for key in BENCHES:
        ap.add_argument(f"--{key}", default=None, metavar="MATRIX",
                        help=f"{key}'s matrix (default: the reference's)")
    ap.add_argument("--pagerank", default=None, metavar="MATRIX",
                    help="PageRank's graph (default bcspwr10)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT)
    ap.add_argument("--one", default=None, choices=list(BENCHES),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    unknown = set(args.which) - set(BENCHES)
    if unknown:
        ap.error(f"unknown packages {sorted(unknown)}")
    resolve_device(args.device)
    if args.one:
        row = _run_in_process(args.one, args)
        print("RESULT:" + json.dumps(row), flush=True)
        return 0
    rows = [_run_one(key, args) for key in BENCHES
            if not args.which or key in args.which]
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "extra.json").write_text(json.dumps(rows, indent=1))
    print("RESULT:" + json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
