"""Headline benchmark of the port: supernodal Cholesky factor and solve.

    python -m suitesparse_tpu_torch.bench [--matrix a,b] [--repeats N]
        [--no-baseline] [--device cuda|cpu] [--out DIR]

The counterpart of the repository's ``bench.py`` (its protocol, step by
step), on the card unless ``--device cpu`` is asked for:

  factor rate  = fl / t_refactor            (cholmod_demo.c:598-601)
  solve rate   = 4 lnz / t_solve, at 1 and 32 right-hand sides (:602-608)
  residual     = ||Ax-b||inf / (||A||1 ||x||inf + ||b||inf) after 3
                 float64 refinement steps   (:453-503)

beside a measured dense-GEMM roofline (float32 with TF32 off, and
bfloat16, 8192^3 on the card), the ``syrk_bf16`` A/B and scipy's ``splu``
factor time on the host (``vs_baseline``).  On the card every rate is held
under 105% of the H100 peak it can reach (``tools.microbench.PEAKS``): a
reading above it means the timing is wrong, and the run fails.

Every timed region ends in ``torch.cuda.synchronize()``.  A refactor is
timed as the reference's ``timed``: one call, then ``repeats`` calls with
one sync; a call over 0.2 s is synchronized each time, and the previous
output is dropped before the next call, so that two factor buffers (5.8 GB
each at lap3d_64) never live at once.  The solves are the plan's solve
programs (``super_numeric.solve_program``: the permutation on the card,
one program per pattern), the port's form of the reference's jitted
``wave_solve_llt``.

Each matrix runs in a process of its own (its plans, programs and graph
pools die with it), which prints its row on a ``RESULT:`` line.  A matrix
or phase that fails ends the run with a nonzero exit; the one row that may
be left out is a genuine reference fixture whose file is absent here
(``[bench] skipped: fixture absent``).  Default matrices: bcsstk16,
lap3d_28, lap3d_44, fem3d_80000 and lap3d_64 on the card, bcsstk16 and
lap3d_12 on the CPU.  The per-matrix log goes to stderr; ``DIR`` (default
``build/bench`` in the checkout) receives ``detail.json`` (the roofline and
every row) and ``splu_cache.json`` (the ``splu`` times, keyed by a host and
scipy fingerprint).  Nothing else is written.  The last line of stdout is
one JSON object: the factor rate on the matrix of most flops.

The package benchmarks beyond Cholesky (KLU, UMFPACK, SPQR, GraphBLAS) are
``python -m suitesparse_tpu_torch.bench_extra``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import platform
import subprocess
import sys
import time

import numpy as np
import torch

from .utils.device import default_dtype, resolve_device, torch_dtype

__all__ = ["bench_matrix", "child_row",
           "fixture_absent", "log", "main", "measure_gemm_roofline",
           "timed"]

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "build" / "bench"
MATRICES = {"cuda": ["bcsstk16", "lap3d_28", "lap3d_44", "fem3d_80000",
                     "lap3d_64"],
            "cpu": ["bcsstk16", "lap3d_12"]}
GEMM_SIZE = {"cuda": 8192, "cpu": 1024}
SERIALIZE_S = 0.2            # calls longer than this are synchronized each
REFINE_STEPS = 3
DEVICE_RESIDUAL_MAX = 1e-4   # the float32 device-resident solve, unrefined
ONE_TIMEOUT = 9000           # seconds a matrix's process may take


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, repeats: int, dev: torch.device, keep_out: bool = False):
    """(single_s, amortized_s[, out]): one untimed call, one call ended by
    a sync, then ``repeats`` calls ended by one sync (bench.py:48-77).
    Calls over SERIALIZE_S are synchronized each time, and the previous
    output is dropped before the next call.  keep_out: also return the
    last output."""
    out = fn()
    _sync(dev)
    out = None
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    single = time.perf_counter() - t0
    serialize = single > SERIALIZE_S
    t0 = time.perf_counter()
    for _ in range(repeats):
        if serialize:
            out = None
        out = fn()
        if serialize:
            _sync(dev)
    _sync(dev)
    amort = (time.perf_counter() - t0) / repeats
    return (single, amort, out) if keep_out else (single, amort)


def measure_gemm_roofline(dtype: torch.dtype, dev: torch.device,
                          size: int, iters: int = 8) -> float:
    """GFLOP/s of chained size^3 products (each takes the last one's
    result) in full float32 (TF32 off) or bfloat16, ended by a sync; on the
    card held under 105% of the H100 peak of the type."""
    from .tools.microbench import check_peak, matmul_precision
    g = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn((size, size), generator=g).to(dtype=dtype, device=dev)
    b = torch.randn((size, size), generator=g).to(dtype=dtype, device=dev)
    with matmul_precision("highest"):
        c = a @ b
        _sync(dev)
        t0 = time.perf_counter()
        c = a
        for _ in range(iters):
            c = c @ b
        _sync(dev)
    rate = 2 * size ** 3 * iters / (time.perf_counter() - t0)
    if dev.type == "cuda":
        name = "float32" if dtype == torch.float32 else "bfloat16"
        check_peak(rate, name, f"{name} {size}^3 product")
    return rate / 1e9


def fixture_absent(name: str) -> bool:
    """True for a genuine reference fixture (io.fixtures) that neither the
    collection cache nor the reference checkout holds here."""
    from .io import collection, fixtures
    if name.split("/")[-1] not in fixtures._FIXTURES:
        return False
    try:
        collection.get(name)
    except FileNotFoundError:
        return True
    return False


def _fingerprint() -> str:
    import scipy
    return f"{platform.node()}|scipy-{scipy.__version__}"


def _splu_time(name: str, Sf, cache_path: pathlib.Path) -> float:
    """scipy SuperLU's factor time of ``Sf`` on the host, cached in
    ``cache_path`` under the matrix name with the host and scipy
    fingerprint (bench.py:213-236); a cached time of another host or scipy
    is measured again."""
    import scipy.sparse.linalg as spla
    try:
        cache = json.loads(cache_path.read_text())
    except (OSError, ValueError):
        cache = {}
    ent = cache.get(name)
    fprint = _fingerprint()
    if isinstance(ent, dict) and ent.get("fingerprint") == fprint:
        return float(ent["time_s"])
    t0 = time.perf_counter()
    spla.splu(Sf.tocsc())
    t = time.perf_counter() - t0
    cache[name] = {"time_s": t, "fingerprint": fprint}
    cache_path.parent.mkdir(parents=True, exist_ok=True)
    cache_path.write_text(json.dumps(cache, indent=1))
    return t


def _refined(f, A, Sf, b, cm) -> float:
    """Residual of the solve through ``f`` after REFINE_STEPS float64
    refinement steps on the host."""
    from .cholesky import residual_norm, solve_super
    x = solve_super(f, b, "A", cm).astype(np.float64)
    for _ in range(REFINE_STEPS):
        x = x + solve_super(f, b - Sf @ x, "A", cm).astype(np.float64)
    return residual_norm(A, x, b)


def _graph_pool_gib(prog) -> float:
    """GiB the allocator holds in a captured program's graph pool."""
    pool = tuple(prog.graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool) / 2**30


def bench_matrix(name: str, repeats: int, gemm_f32: float, device=None,
                 splu_cache=None, return_factor: bool = False):
    """One matrix through the reference's protocol (bench.py:100-300) on
    ``device`` (the card unless "cpu" is asked for) in float32 on the card
    and float64 on the CPU; returns its row.
    ``gemm_f32``: the measured float32 GEMM GFLOP/s the factor rate is set
    against.  ``splu_cache``: the path of the splu cache, or None to skip
    the baseline.  return_factor: also return the refactor's panels
    (plan.total entries) as a host array."""
    from .cholesky import analyze, super_symbolic
    from .cholesky.kernels import block_chol
    from .cholesky.pf import block_chol_shapes, pf_numeric, pf_program
    from .cholesky.super_numeric import (SuperFactor, _assemble_values,
                                         bind_solve_factor, build_plan,
                                         solve_program)
    from .cholesky.api import residual_norm
    from .core.common import default_common
    from .io import collection
    from .io.generators import symmetrize_upper
    from .tools.microbench import check_peak

    dev = resolve_device(device)
    dtype = np.dtype(default_dtype(dev))
    dt = torch_dtype(dtype)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    A = collection.get(name)
    if A.stype == 0:
        A = symmetrize_upper(A)
    n = A.ncol
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"

    t0 = time.perf_counter()
    sym = analyze(A, cm)
    t_sym = time.perf_counter() - t0
    ss = super_symbolic(A, sym, cm)
    t_ss = time.perf_counter() - t0 - t_sym
    plan = build_plan(ss)
    pfp = plan.pf_plan(cm)
    t_plan = time.perf_counter() - t0 - t_sym - t_ss
    plan.wave_plan(solve_only=True)
    t_analyze = time.perf_counter() - t0
    # the plan's two switches sized for the reference's 16 GB chip
    # (pf.py's projection workspace cap, supernodal.py's bucket merging)
    est = float(np.sum(np.diff(ss.sn_rowptr) * np.diff(ss.super)))
    switches = dict(pf_workspace_cap="4 CAP" if plan.total * 4 < (2 << 30)
                    else "CAP",
                    bucket_merge=bool(est * 4 < (256 << 20)))
    log(f"[{name}] n={n} nnz(A)={A.nnz} lnz={sym.lnz} fl={sym.flops:.4g} "
        f"nsuper={ss.nsuper} buckets={plan.nbuckets} "
        f"instr={len(pfp.instr_cls)} fcls={len(pfp.fmeta)} "
        f"pcls={len(pfp.pmeta)} qcls={len(pfp.qmeta)} "
        f"projfl={pfp.proj_flops:.3g} buf={pfp.buf} total={plan.total} "
        f"{switches} analyze={t_analyze:.2f}s (etree {t_sym:.2f} + super "
        f"{t_ss:.2f} + plan {t_plan:.2f} + solve maps)")

    vd = torch.as_tensor(_assemble_values(A, sym, ss, dtype), device=dev)
    t0 = time.perf_counter()
    Lx = pf_numeric(vd, pfp, dtype, device=dev)
    _sync(dev)
    t_first = time.perf_counter() - t0
    prog = pf_program(pfp, dtype, device=dev)
    capture = dict(warmup_s=prog.warmup_s, capture_s=prog.capture_s,
                   graph_nodes=prog.nodes,
                   graph_pool_gib=_graph_pool_gib(prog) if cuda else None)
    log(f"[{name}] first factor {t_first:.2f} s: {json.dumps(capture)}")

    # the refactorization: values change, pattern fixed; the first
    # factor is dropped before the timing, whose last output is the factor
    Lx = None
    l0 = block_chol.launches
    t_single, t_factor, Lx = timed(
        lambda: pf_numeric(vd, pfp, dtype, device=dev), repeats, dev,
        keep_out=True)
    # timed makes repeats + 2 calls: each launches the plan's count on the
    # card, none on the CPU (the plain version)
    shapes = block_chol_shapes(pfp)
    plan_launches = sum(shapes.values())
    timed_launches = block_chol.launches - l0
    if cuda and timed_launches != plan_launches * (repeats + 2):
        raise RuntimeError(
            f"{name}: block_chol launched {timed_launches} times in "
            f"{repeats + 2} refactors, the plan's count is {plan_launches} "
            f"a factor")
    per_factor = timed_launches // (repeats + 2)
    again = pf_numeric(vd, pfp, dtype, device=dev)
    bit_identical = bool(torch.equal(again, Lx))
    again = None
    if not bit_identical:
        raise RuntimeError(f"{name}: two refactorizations differ")
    gflops = sym.flops / t_factor / 1e9
    if cuda:
        check_peak(gflops * 1e9, "float32", f"{name} factor rate")
    log(f"[{name}] refactor {t_factor * 1e3:.3f} ms (single call "
        f"{t_single * 1e3:.3f}) -> {gflops:.1f} GFLOP/s")

    # the device-resident solve: b and x on the device, P and P' inside
    # the program; its residual must make it a solve in its own right
    b = np.ones(n)
    f = SuperFactor(plan=plan, Lx=Lx, perm=sym.perm, minor=n, dtype=dtype)
    t0 = time.perf_counter()
    bind_solve_factor(f, cm)          # the panels copied in; Dinv built
    _sync(dev)
    t_dinv = time.perf_counter() - t0
    sp1 = solve_program(plan, "A", 1, dt, dev, cm)
    b1 = torch.ones((n, 1), dtype=dt, device=dev)
    _, t_solve = timed(lambda: sp1(b1), repeats, dev)
    solve_gflops = 4 * sym.lnz / t_solve / 1e9
    xdev = sp1(b1)[:, 0].double().cpu().numpy()
    res_dev = residual_norm(A, xdev, b)
    if not res_dev < DEVICE_RESIDUAL_MAX:
        raise RuntimeError(f"{name}: device-resident solve residual "
                           f"{res_dev:.2e} (not a solve)")

    Sf = A.to_scipy().astype(np.float64)
    res = _refined(f, A, Sf, b, cm)
    log(f"[{name}] solve {t_solve * 1e3:.3f} ms -> {solve_gflops:.2f} "
        f"GFLOP/s; device residual {res_dev:.2e}; residual after "
        f"{REFINE_STEPS} steps {res:.2e}")
    t_base = (_splu_time(name, Sf, pathlib.Path(splu_cache))
              if splu_cache else None)

    sp32 = solve_program(plan, "A", 32, dt, dev, cm)
    b32 = torch.ones((n, 32), dtype=dt, device=dev)
    _, t_solve32 = timed(lambda: sp32(b32), max(repeats // 2, 1), dev)
    solve32_gflops = 4 * sym.lnz * 32 / t_solve32 / 1e9
    if cuda:
        check_peak(solve_gflops * 1e9, "float32", f"{name} solve rate")
        check_peak(solve32_gflops * 1e9, "float32", f"{name} 32-RHS rate")
    factor = Lx[:plan.total].cpu().numpy() if return_factor else None

    # bf16 A/B: the SYRK and the pair placements from bfloat16 inputs,
    # refined the same way; the float32 factor and its program go first
    f = Lx = None
    pfp._cache.pop(prog.key)
    prog = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    _, t_bf16, Lxb = timed(
        lambda: pf_numeric(vd, pfp, dtype, syrk_bf16=True, device=dev),
        repeats, dev, keep_out=True)
    bf16_gflops = sym.flops / t_bf16 / 1e9
    if cuda:
        check_peak(bf16_gflops * 1e9, "bfloat16", f"{name} bf16 factor rate")
    fb = SuperFactor(plan=plan, Lx=Lxb, perm=sym.perm, minor=n, dtype=dtype)
    bf16_residual = _refined(fb, A, Sf, b, cm)
    log(f"[{name}] bf16 A/B: refactor {t_bf16 * 1e3:.3f} ms -> "
        f"{bf16_gflops:.1f} GFLOP/s ({gflops:.1f}); residual "
        f"{bf16_residual:.2e} ({res:.2e})")

    row = dict(name=name, n=n, fl=float(sym.flops), lnz=int(sym.lnz),
               t_analyze=t_analyze, t_factor=t_factor, gflops=gflops,
               t_solve=t_solve, solve_gflops=solve_gflops,
               solve32_gflops=solve32_gflops, residual=res, t_base=t_base,
               bf16_gflops=bf16_gflops, bf16_residual=bf16_residual,
               t_first=t_first, pct_gemm_peak=100.0 * gflops / gemm_f32,
               t_single=t_single, t_solve32=t_solve32, t_bf16=t_bf16,
               t_dinv=t_dinv, residual_device=res_dev, **capture,
               peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                             if cuda else None),
               nsuper=int(ss.nsuper), buckets=int(plan.nbuckets),
               instr=int(len(pfp.instr_cls)), buf=int(pfp.buf),
               total=int(plan.total), **switches,
               bit_identical=bit_identical,
               block_chol_per_factor=per_factor,
               block_chol_plan=plan_launches,
               block_chol_timed_launches=timed_launches,
               block_chol_timed_calls=repeats + 2,
               block_chol_shapes=[[W, Np, c] for (W, Np), c
                                  in sorted(shapes.items())],
               block_chol_launches=block_chol.launches,
               device=dev.type, dtype=dtype.name)
    log(f"[{name}] first factor {t_first * 1e3:.1f} ms, refactor "
        f"{t_factor * 1e3:.3f} ms -> {gflops:.1f} GFLOP/s "
        f"({row['pct_gemm_peak']:.1f}% of the measured float32 GEMM); "
        f"solve32 {t_solve32 * 1e3:.2f} ms -> {solve32_gflops:.1f} GFLOP/s; "
        f"splu " + (f"{t_base:.3f} s ({t_base / t_factor:.0f}x)"
                    if t_base else "skipped"))
    return (row, factor) if return_factor else row


def child_row(module: str, args: list, timeout: float, what: str) -> dict:
    """The row that ``python -m module args`` prints on its one
    ``RESULT:`` line, run from the checkout's root with this process's
    stderr; an exit other than 0 or another count of rows ends this run
    with a nonzero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                          stdout=subprocess.PIPE, stderr=None,
                          timeout=timeout, text=True)
    rows = [json.loads(line[len("RESULT:"):])
            for line in proc.stdout.splitlines()
            if line.startswith("RESULT:")]
    if proc.returncode != 0 or len(rows) != 1:
        raise SystemExit(f"{what} failed (exit {proc.returncode}, "
                         f"{len(rows)} RESULT lines)")
    return rows[0]


def _run_one(name: str, args) -> dict:
    """``name``'s row from a process of its own (bench.py:304-333)."""
    argv = ["--one", name, "--repeats", str(args.repeats), "--gemm-f32",
            repr(args.gemm_f32), "--device", args.device, "--out",
            str(args.out)] + (["--no-baseline"] if args.no_baseline else [])
    return child_row("suitesparse_tpu_torch.bench", argv, ONE_TIMEOUT,
                     f"[bench] {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m suitesparse_tpu_torch.bench",
        description="Supernodal Cholesky factor and solve rates, the "
                    "reference's bench.py protocol.")
    ap.add_argument("--matrix", default=None,
                    help="comma-separated matrix names (default: the "
                         "reference's list for the device)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip scipy's splu factor time")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gemm-f32", type=float, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    splu_cache = None if args.no_baseline else args.out / "splu_cache.json"

    if args.one:
        row = bench_matrix(args.one, args.repeats, args.gemm_f32, dev,
                           splu_cache=splu_cache)
        print("RESULT:" + json.dumps(row), flush=True)
        return 0

    size = GEMM_SIZE[dev.type]
    args.gemm_f32 = measure_gemm_roofline(torch.float32, dev, size)
    gemm_bf16 = measure_gemm_roofline(torch.bfloat16, dev, size)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[bench] device={dev.type}"
        + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
           else " (host rates)")
        + f"; measured GEMM roofline ({size}^3): float32 (TF32 off) "
          f"{args.gemm_f32:.0f} GFLOP/s, bfloat16 {gemm_bf16:.0f} GFLOP/s")
    names = (args.matrix.split(",") if args.matrix
             else MATRICES[dev.type])
    results = []
    for name in names:
        if fixture_absent(name):
            log(f"[bench] skipped: fixture absent: {name}")
            continue
        results.append(_run_one(name, args))
    if not results:
        raise SystemExit("[bench] no matrix was benchmarked")

    detail = {
        "gemm_roofline_gflops": {"float32": args.gemm_f32,
                                 "bfloat16": gemm_bf16, "size": size},
        "matmul_precision": "float32, TF32 off",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "cholesky": results,
    }
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "detail.json").write_text(json.dumps(detail, indent=1))
    head = max(results, key=lambda r: r["fl"])
    print(json.dumps({
        "metric": f"supernodal_cholesky_factor_gflops[{head['name']}]",
        "value": round(head["gflops"], 2),
        "unit": "GFLOP/s",
        "vs_baseline": (round(head["t_base"] / head["t_factor"], 3)
                        if head.get("t_base") else None),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
