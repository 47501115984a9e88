#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (suitesparse_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``suitesparse_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path -- supernodal Cholesky analysis, pass-forward factor,
refactorization, inverted diagonal blocks, device-resident solves and
float64 iterative refinement -- on two full-size stand-in matrices
(lap3d_44, n = 85,184; fem3d_80000, an irregular tetrahedral mesh), and
checks what comes out.  Then it drives the sparse-product slice: on
lap3d_44's full symmetric pattern the BCSR product (the ``bcsr_spmm``
kernel), the segment SpMM program, sfmult, the Gustavson SpGEMM, ssmult
and a min_plus mxv, each against a host oracle; and on two graphs of
n = 1,000,000 PageRank, BFS (device pull and host push) and triangle
counting.  Then the dispatch-floor probes (``scale_blocks`` and
``scale_gather`` of ``csrc/dispatch_probe.cu`` bit for bit against their
plain versions, and the probe tool's ``main()``), and the Cholesky front
end on lap3d_44: ``spsolve_chol``, ``CholeskySolver`` refactorizations,
the wave program and the bfloat16 SYRK option, each refined in float64.
Last the LU family (``[lu]``, no kernel of the port on its path): the
multifrontal LU (umf_symbolic, umf_numeric refactorizations, umf_solve
with float64 refinement) on cd3d_44, a convection-diffusion operator
built here, and on randunsym_5000; a singular case; and KLU on
circuit_4000, on the host and through its device twin with a sweep of
value sets.  Any failed check raises and the script exits nonzero;
nothing is caught and carried on.  Without a CUDA device, or without the package beside
it, it exits nonzero and prints no result.

It also profiles one refactorization of each matrix with torch.profiler,
by default and with ``Common.cholesky.trsm_inv = False``: the Chrome
traces go to ``build/profiles/profile_<matrix>[_trsm_inv_false].json``
(~30 MB each, gitignored), and a ``[profile]`` line for each gives
the device busy time (union of the kernel intervals), the idle share
against the median of the unprofiled refactorizations, and the device
time per kernel group and for the top kernels.

``block_chol`` is timed at each (W, Np) of one lap3d_44 factor with 50
launches queued behind a spin kernel, so that the host's enqueue rate does
not set the time of a kernel shorter than its launch; it and its yardstick
``torch.linalg.cholesky_ex``, which waits on the host and cannot be
queued, are also timed by their device busy time under torch.profiler.

Output: one line per phase, then a ``{"kernels": [...]}`` line, the card's
name and power limit (nvidia-smi), and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MATRICES = ("lap3d_44", "fem3d_80000")
PROFILE_DIR = os.path.join(ROOT, "build", "profiles")
RESIDUAL_MAX = 1e-11          # after 3 float64 refinement steps
# f32 peak outside the tensor cores, dense TF32 tensor-core peak and HBM
# rate of one H100 SXM (NVIDIA data sheet, 700 W); the batched Cholesky
# runs on the CUDA cores, the BCSR product on the tensor cores (3xTF32)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# the port's CUDA sources, csrc/<name>.cu
KERNELS = ("block_chol", "bcsr_spmm", "dispatch_probe")
DISPATCH_G = (64, 256)        # grid sizes of the dispatch-floor probes
# grid sizes they are checked at: chunk counts that are no multiple of the
# persistent grid, and grids smaller than the SM count
DISPATCH_CHECK_G = (1, 3, 64, 131, 256, 257)
# block_chol timing: launches a timed run, and the spin that holds the
# stream while the host enqueues them (~10 ms at the H100's ~2 GHz)
QUEUED_REPS = 50
HOLD_CYCLES = 20_000_000
BUSY_TRACE_S = 0.05            # least host time a busy-time trace spans
FRONT_MATRIX = "lap3d_44"
REFINE_STEPS = 3
REFACTOR_REPS = 5
OPS_MATRIX = "lap3d_44"
GRAPH_N = 1_000_000
# the [lu] phase: multifrontal LU (cd3d_44, randunsym_5000), a singular
# case, and KLU's device twin on circuit_like(KLU_N) with a sweep of
# KLU_SWEEP value sets
LU_PECLET = 0.5                # cell Peclet number of cd3d
LU_REPS = 5
LU_REFINE = 3
LU_OMEGA_MAX = 1e-11           # after LU_REFINE float64 refinement steps
LU_OMEGA_RAW_MAX = 1e-5        # the float32 factor's solve, unrefined
LU_SEED = 7
KLU_N = 4000
KLU_SWEEP = 8
KLU_RES_MAX = 1e-4             # float32 device solves
# kernel-name fragments of each device-time group in a profile
GROUPS = (("block_chol", ("block_chol",)),
          ("getrf", ("getrf", "getf2", "laswp", "lu_unpack",
                     "unpack_pivots")),
          ("trsm", ("trsm", "trsv")),
          ("gemm", ("gemm", "gemv", "cutlass", "xmma", "cublas")),
          ("segment_reduce", ("segment",)),
          ("index/scatter", ("index", "scatter", "gather", "put")),
          ("cat/copy", ("cat", "copy", "memcpy", "memset")),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("reduce", ("reduce",)))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def sync():
    import torch
    torch.cuda.synchronize()


def host_time(fn):
    """(seconds, result) of fn() on the host clock, ended by a sync."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return time.perf_counter() - t0, out


def event_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    sync()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    sync()
    return e0.elapsed_time(e1) / reps


def kernel_ms(fn) -> float:
    """ms per call of QUEUED_REPS back-to-back calls queued behind a spin
    kernel (the probe tool's ``device_time``), so that the events time
    the device's work and not the host's enqueue rate (a launch costs the
    host longer than a small kernel runs); it raises
    unless the host queued every call before the spin let go."""
    from suitesparse_tpu_torch.tools.microbench_dispatch import device_time
    return device_time(fn, [()], reps=QUEUED_REPS,
                       hold_cycles=HOLD_CYCLES) * 1e3


def busy_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """ms per call of the device's busy time under torch.profiler: the
    union of the kernel and copy intervals of at least ``reps`` calls
    (as many more as fill BUSY_TRACE_S of host time), which leaves out
    the gaps between them (and so any wait on the host).  Traces of a few
    ms now and then came back with no device work at all on an H100, so
    each trace lasts BUSY_TRACE_S, and an empty one is taken again, up to
    ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    sync()
    path = os.path.join(PROFILE_DIR, "busy.json")
    for attempt in range(1, tries + 1):
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            calls, t0 = 0, time.perf_counter()
            while calls < reps or time.perf_counter() - t0 < BUSY_TRACE_S:
                fn()
                calls += 1
            sync()
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and "dur" in e]
        if spans:
            return _busy_us(spans) / 1e3 / calls
        log(f"[kernel] busy_ms: trace {attempt} of {tries} recorded no "
            f"device work")
    raise RuntimeError(f"check failed: {tries} traces recorded no device "
                       f"work")


def spd_batch(rng, W, Np, dtype, npad=0):
    """Seeded SPD batch (W, Np, Np) with ``npad`` padded trailing rows
    (zero rows/columns, unit pivot through pe), on the card."""
    import torch
    M = rng.standard_normal((W, Np, Np))
    S = M @ M.transpose(0, 2, 1) / Np + np.eye(Np)
    pe = np.zeros((W, Np))
    if npad:
        S[:, Np - npad:, :] = 0.0
        S[:, :, Np - npad:] = 0.0
        pe[:, Np - npad:] = 1.0
    return (torch.as_tensor(S, dtype=dtype, device="cuda"),
            torch.as_tensor(pe, dtype=dtype, device="cuda"))


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_setup():
    import torch
    from suitesparse_tpu_torch.utils import cuda_build
    from suitesparse_tpu_torch.utils.native import get_lib
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    log(f"[setup] torch.backends.cuda.matmul.allow_tf32={tf32} "
        f"float32_matmul_precision={prec}")
    check(not tf32 and prec == "highest",
          "float32 matmuls must run in full float32 (no TF32)")
    lib = get_lib()
    log(f"[setup] native/libsstpu.so loaded: {lib is not None} "
        f"({'native AMD/partitioner' if lib is not None else 'Python fallbacks'})")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for fut in [pool.submit(cuda_build.build, n) for n in KERNELS]:
            fut.result()
    log(f"[setup] built {list(KERNELS)} with {cuda_build.nvcc()} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        for line in (cuda_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[setup] ptxas {name}: {line.strip()}")


def phase_kernel_vs_plain():
    """block_chol kernel vs its plain version at every Np it takes (every
    multiple of 8 in 8..128, ragged last panels included), W in
    {1, 4, 37, 512}; then a negative pivot in the first, a middle and the
    last panel, where the NaN pattern must be the plain version's."""
    import torch
    from suitesparse_tpu_torch.cholesky.kernels import (block_chol,
                                                        block_chol_plain)
    rng = np.random.default_rng(0)
    # tolerances: kernel and plain run the same rank-1 updates in the same
    # column order, but the kernel fuses each multiply-subtract (FMA) and
    # computes rsqrt with the device intrinsic, so results differ by
    # rounding accumulated over Np steps: ~Np ulp of the working type
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    worst = {}
    nps = range(8, 129, 8)
    for Np in nps:
        for W in (1, 4, 37, 512):
            S64, pe64 = spd_batch(rng, W, Np, torch.float64, npad=Np // 8)
            for dt in (torch.float64, torch.float32):
                S, pe = S64.to(dt), pe64.to(dt)
                K = block_chol(S, pe)
                P = block_chol_plain(S, pe)
                sync()
                err = rel_err(K, P)
                check(torch.isfinite(K).all().item(),
                      f"non-finite kernel output W={W} Np={Np} {dt}")
                check(bool((torch.tril(K, -1) == 0).all()),
                      f"nonzero below the diagonal W={W} Np={Np} {dt}")
                check(err <= tol[dt],
                      f"block_chol vs plain W={W} Np={Np} {dt}: {err:.2e}")
                worst[dt] = max(worst.get(dt, 0.0), err)
    log(f"[kernel] block_chol vs plain, every Np in 8..128 step 8, W in "
        f"1/4/37/512: max relative error f64 {worst[torch.float64]:.3e} "
        f"(tol 1e-12), f32 {worst[torch.float32]:.3e} (tol 1e-5)")
    # NaN contract: a negative pivot must come out as NaN, as in the plain
    for Np in nps:
        S64, pe64 = spd_batch(rng, 4, Np, torch.float64)
        for w, c in ((1, 1), (2, Np // 2), (3, Np - 3)):
            S64[w, c, c] = -5.0
        for dt in (torch.float64, torch.float32):
            K = block_chol(S64.to(dt), pe64.to(dt))
            P = block_chol_plain(S64.to(dt), pe64.to(dt))
            sync()
            check(all(bool(torch.isnan(K[w]).any()) for w in (1, 2, 3)),
                  f"no NaN on an indefinite block, Np={Np} {dt}")
            check(bool(torch.isfinite(K[0]).all()),
                  f"NaN leaked into the definite block, Np={Np} {dt}")
            check(torch.equal(torch.isnan(K), torch.isnan(P)),
                  f"kernel and plain disagree on the NaN pattern, Np={Np}")
    log("[kernel] NaN on a non-positive pivot in the first, a middle and "
        "the last panel, the plain version's pattern: held at every Np "
        "(f64, f32)")


def phase_small_parity():
    """laplacian_3d(12), f64: the port on the card vs the port on the CPU
    (plain versions), through the pass-forward program."""
    from suitesparse_tpu_torch.cholesky import (analyze, factorize_super,
                                                super_symbolic)
    from suitesparse_tpu_torch.cholesky.kernels import block_chol
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.io.generators import laplacian_3d
    A = laplacian_3d(12)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    l0 = block_chol.launches
    fg = factorize_super(A, sym, ss, common=cm, dtype=np.float64,
                         device="cuda")
    fc = factorize_super(A, sym, ss, common=cm, dtype=np.float64,
                         device="cpu")
    launched = block_chol.launches - l0
    tot = fg.plan.total
    err = rel_err(fg.Lx[:tot].cpu(), fc.Lx[:tot])
    check(fg.ok and fc.ok, "small factor not positive definite")
    check(err <= 1e-12, f"lap3d_12 cuda vs cpu factor: {err:.2e}")
    check(launched > 0, "block_chol not launched by the small factor")
    log(f"[small] lap3d_12 f64 factor, cuda vs cpu plain: relative "
        f"{err:.3e} (tol 1e-12); block_chol launches {launched}")


def factor_shapes(pfp):
    """{(W, Np): launches} of block_chol in one pass-forward factor."""
    from suitesparse_tpu_torch.cholesky.pf import _POTRF_MAXNP
    nf = len(pfp.fmeta)
    shapes = {}
    for cid in pfp.instr_cls.tolist():
        if cid >= nf:
            continue
        Np, Mb, W = pfp.fmeta[cid][:3]
        if Np <= _POTRF_MAXNP:
            bb = min(Np, 128)
            shapes[(W, bb)] = shapes.get((W, bb), 0) + Np // bb
    return shapes


def _group(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "other"


def _busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def profile_refactor(name, run, refactor_ms: float, outdir: str) -> dict:
    """Profile one refactorization ``run()`` with torch.profiler and break
    its device time down by kernel group.  The profiler slows the host, so
    the idle share is taken against ``refactor_ms``, the median of the
    unprofiled refactorizations; the profiled run's own share is given
    beside it."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        wall, _ = host_time(run)
    path = os.path.join(outdir, f"profile_{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    check(kern, f"{name}: the profiler recorded no device kernels")
    by_group, by_name = {}, {}
    for e in kern:
        g = _group(e["name"])
        by_group[g] = by_group.get(g, 0.0) + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy_ms = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kern]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(matrix=name, refactor_median_ms=refactor_ms,
                refactor_profiled_ms=wall * 1e3, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / refactor_ms,
                idle_share_profiled=1.0 - busy_ms / (wall * 1e3),
                kernels=len(kern), trace=path,
                group_ms={g: v / 1e3 for g, v in sorted(
                    by_group.items(), key=lambda kv: -kv[1])},
                top_ms=[(n[:90], v / 1e3) for n, v in top])


def run_matrix(name: str, reps: int):
    import torch
    from suitesparse_tpu_torch.cholesky import (analyze, factorize_super,
                                                residual_norm, solve_super,
                                                super_symbolic)
    from suitesparse_tpu_torch.cholesky.kernels import block_chol
    from suitesparse_tpu_torch.cholesky.pf import pf_numeric
    from suitesparse_tpu_torch.cholesky.super_numeric import (
        _assemble_values, build_plan)
    from suitesparse_tpu_torch.cholesky.wave import (solve_dinv,
                                                     wave_solve_llt)
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.io.generators import (symmetrize_upper,
                                                     synthetic_standin)
    A = synthetic_standin(name)
    if A.stype == 0:
        A = symmetrize_upper(A)
    n = A.ncol
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"
    t0 = time.perf_counter()
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    plan = build_plan(ss)
    pfp = plan.pf_plan(cm)
    wp = plan.wave_plan(solve_only=True)
    t_an = time.perf_counter() - t0
    log(f"[{name}] n={n} nnz(A)={A.nnz} lnz={sym.lnz} fl={sym.flops:.4g} "
        f"nsuper={ss.nsuper} buckets={plan.nbuckets} "
        f"instr={len(pfp.instr_cls)} buf={pfp.buf} analyze+plan={t_an:.2f}s")

    torch.cuda.reset_peak_memory_stats()
    l0 = block_chol.launches
    t_first, f = host_time(lambda: factorize_super(
        A, sym, ss, plan=plan, common=cm, device="cuda"))
    per_factor = block_chol.launches - l0
    check(f.ok, f"{name}: factor not positive definite (minor {f.minor})")
    check(f.Lx.dtype == torch.float32, f"{name}: factor dtype {f.Lx.dtype}")
    check(per_factor > 0, f"{name}: block_chol not launched")
    check(per_factor == sum(factor_shapes(pfp).values()),
          f"{name}: launches {per_factor} differ from the plan's count")
    vd = torch.as_tensor(_assemble_values(A, sym, ss, np.float32),
                         device="cuda")
    t_ref = []
    first = None
    for _ in range(reps):
        t, Lx = host_time(lambda: pf_numeric(vd, pfp, np.float32,
                                             device="cuda"))
        t_ref.append(t)
        first = Lx if first is None else first
    identical = torch.equal(first, Lx) and torch.equal(f.Lx, Lx)
    check(identical, f"{name}: refactorizations are not bit-identical")
    del first, Lx
    t_refactor = float(np.median(t_ref))
    prof = profile_refactor(
        name, lambda: pf_numeric(vd, pfp, np.float32, device="cuda"),
        t_refactor * 1e3, PROFILE_DIR)
    log("[profile] " + json.dumps(prof))

    t_dinv, Dv = host_time(lambda: solve_dinv(wp, f.Lx))
    f._dinv = Dv
    perm = torch.as_tensor(sym.perm, device="cuda")
    invp = np.empty(n, dtype=np.int64)
    invp[sym.perm] = np.arange(n)
    invp = torch.as_tensor(invp, device="cuda")
    b = np.ones(n)
    b1 = torch.ones((n, 1), dtype=torch.float32, device="cuda")
    b32 = torch.as_tensor(np.random.default_rng(1).standard_normal((n, 32)),
                          dtype=torch.float32, device="cuda")
    ms1 = event_ms(lambda: wave_solve_llt(wp, f.Lx, b1, Dv, perm, invp), reps)
    ms32 = event_ms(lambda: wave_solve_llt(wp, f.Lx, b32, Dv, perm, invp),
                    reps)
    xdev = wave_solve_llt(wp, f.Lx, b1, Dv, perm, invp)[:, 0]
    check(tuple(xdev.shape) == (n,) and bool(torch.isfinite(xdev).all()),
          f"{name}: device solve shape/finiteness")
    res_dev = residual_norm(A, xdev.double().cpu().numpy(), b)
    check(res_dev < 1e-4, f"{name}: device solve residual {res_dev:.2e}")

    Sf = A.to_scipy().astype(np.float64)
    x = solve_super(f, b, "A", cm).astype(np.float64)
    res0 = residual_norm(A, x, b)
    for _ in range(3):
        x = x + solve_super(f, b - Sf @ x, "A", cm).astype(np.float64)
    res = residual_norm(A, x, b)
    check(res <= RESIDUAL_MAX, f"{name}: residual {res:.3e} > {RESIDUAL_MAX}")
    peak = torch.cuda.max_memory_allocated()   # one factor and its solves

    # the backward-stable TRSM (Common.cholesky.trsm_inv = False): every
    # factor wave through torch.linalg's Cholesky and triangular solve, so
    # block_chol never runs
    cmt = default_common()
    cmt.cholesky.supernodal = "supernodal"
    cmt.cholesky.program = "pf"
    cmt.cholesky.trsm_inv = False
    l0 = block_chol.launches
    ft = factorize_super(A, sym, ss, plan=plan, common=cmt, device="cuda")
    check(ft.ok, f"{name}: trsm_inv=False factor minor {ft.minor}")
    t_tri = []
    for _ in range(reps):
        t, Lt = host_time(lambda: pf_numeric(vd, pfp, np.float32,
                                             device="cuda", trsm_inv=False))
        t_tri.append(t)
    check(torch.equal(Lt, ft.Lx),
          f"{name}: trsm_inv=False refactorizations are not bit-identical")
    check(block_chol.launches == l0, f"{name}: trsm_inv=False launched "
          f"block_chol")
    del Lt
    t_tri_med = float(np.median(t_tri))
    prof_tri = profile_refactor(
        f"{name}_trsm_inv_false",
        lambda: pf_numeric(vd, pfp, np.float32, device="cuda",
                           trsm_inv=False), t_tri_med * 1e3, PROFILE_DIR)
    log("[profile] " + json.dumps(prof_tri))
    tot = plan.total
    d_tri = rel_err(ft.Lx[:tot], f.Lx[:tot])
    # two float32 factors of one matrix by two TRSMs
    check(d_tri <= 1e-3, f"{name}: trsm_inv=False vs default {d_tri:.3e}")
    xt = solve_super(ft, b, "A", cmt).astype(np.float64)
    for _ in range(3):
        xt = xt + solve_super(ft, b - Sf @ xt, "A", cmt).astype(np.float64)
    res_tri = residual_norm(A, xt, b)
    check(res_tri <= RESIDUAL_MAX,
          f"{name}: trsm_inv=False residual {res_tri:.3e} > {RESIDUAL_MAX}")
    del ft
    row = dict(matrix=name, n=n, lnz=int(sym.lnz), flops=float(sym.flops),
               instr=int(len(pfp.instr_cls)), analyze_s=t_an,
               first_factor_s=t_first, refactor_ms=t_refactor * 1e3,
               refactor_ms_all=[t * 1e3 for t in t_ref],
               factor_gflops=sym.flops / t_refactor / 1e9,
               dinv_ms=t_dinv * 1e3, solve1_ms=ms1, solve32_ms=ms32,
               solve1_gflops=4 * sym.lnz / (ms1 * 1e-3) / 1e9,
               solve32_gflops=32 * 4 * sym.lnz / (ms32 * 1e-3) / 1e9,
               residual_f32=res0, residual_refined=res,
               bit_identical_refactor=bool(identical),
               trsm_inv_false_refactor_ms=t_tri_med * 1e3,
               trsm_inv_false_refactor_ms_all=[t * 1e3 for t in t_tri],
               trsm_inv_false_device_busy_ms=prof_tri["device_busy_ms"],
               trsm_inv_false_idle_share=prof_tri["idle_share"],
               trsm_inv_false_rel_diff=d_tri,
               trsm_inv_false_residual_refined=res_tri,
               peak_mem_gib=peak / 2**30,
               block_chol_launches_per_factor=per_factor)
    log(f"[{name}] " + json.dumps(row))
    return row, factor_shapes(pfp)


def kernel_line(shapes, launches, dev_kind):
    """Time block_chol at the (W, Np) shapes of one lap3d_44 factor on the
    device's clock, queued behind a spin (``kernel_ms``: the gaps between
    launches included), beside its plain version, its bound and the
    yardstick ``torch.linalg.cholesky_ex`` on the precomputed S + diag(pe).
    The yardstick waits on the host at W >= 2, so it cannot be queued: it
    is timed by its device busy time (``busy_ms``, gaps left out) at every
    shape, and so is the kernel, beside its queued time."""
    import torch
    from suitesparse_tpu_torch.cholesky.kernels import (block_chol,
                                                        block_chol_plain)
    rng = np.random.default_rng(2)
    keys = ("ms", "busy_ms", "plain_ms", "bound_ms", "library_ms",
            "bytes_ms", "ops_ms")
    tot = dict.fromkeys(keys, 0.0)
    max_abs = 0.0
    w1 = None
    for (W, Np), cnt in sorted(shapes.items()):
        S, pe = spd_batch(rng, W, Np, torch.float32, npad=Np // 8)
        A = S + torch.diag_embed(pe)
        K = block_chol(S, pe)
        P = block_chol_plain(S, pe)
        check(rel_err(K, P) <= 1e-5,
              f"block_chol vs plain at the main path's W={W} Np={Np}")
        L, info = torch.linalg.cholesky_ex(A)
        check(int(info.abs().max()) == 0 and rel_err(L.mT, K) <= 1e-5,
              f"cholesky_ex vs block_chol at W={W} Np={Np}")
        max_abs = max(max_abs, float((K - P).abs().max()))
        ms = kernel_ms(lambda: block_chol(S, pe))
        busy = busy_ms(lambda: block_chol(S, pe))
        lib = busy_ms(lambda: torch.linalg.cholesky_ex(A))
        plain = event_ms(lambda: block_chol_plain(S, pe), 3)
        t_bytes = (2 * W * Np * Np + W * Np) * 4 / PEAK_BYTES * 1e3
        t_ops = W * Np ** 3 / 3 / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"[kernel] block_chol W={W} Np={Np} x{cnt}/factor: "
            f"{ms * 1e3:.2f} us queued, {busy * 1e3:.2f} us busy (plain "
            f"{plain * 1e3:.1f} us, bound {bound * 1e3:.3f} us by "
            f"{'bytes' if t_bytes >= t_ops else 'operations'}, "
            f"torch.linalg.cholesky_ex {lib * 1e3:.2f} us busy) on "
            f"{dev_kind}")
        if (W, Np) == (1, 128):
            w1 = dict(ms=ms, busy_ms=busy, library_ms=lib)
            log(f"[kernel] block_chol latency of one 128 x 128 factor (W=1, "
                f"Np=128): {ms * 1e3:.2f} us queued, {busy * 1e3:.2f} us "
                f"busy on the device's clock; torch.linalg.cholesky_ex "
                f"{lib * 1e3:.2f} us busy")
        for k, v in zip(keys, (ms, busy, plain, bound, lib, t_bytes, t_ops)):
            tot[k] += cnt * v
    log(f"[kernel] block_chol per lap3d_44 factor: {tot['ms']:.4f} ms "
        f"queued, {tot['busy_ms']:.4f} ms busy (torch.linalg.cholesky_ex "
        f"{tot['library_ms']:.4f} ms busy, bound {tot['bound_ms']:.4f} ms) "
        f"on {dev_kind}")
    return dict(name="block_chol", route="cuda",
                source="suitesparse_tpu_torch/csrc/block_chol.cu",
                replaces="suitesparse_tpu/cholesky/pallas_kernels.py:68",
                launches=launches, max_abs_err=max_abs,
                ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"],
                bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                          else "operations"),
                library_ms=tot["library_ms"],
                busy_ms=tot["busy_ms"],
                ms_w1_np128=w1 and w1["ms"],
                busy_ms_w1_np128=w1 and w1["busy_ms"],
                library_ms_w1_np128=w1 and w1["library_ms"],
                timed_as=f"one lap3d_44 factor's launches, shape by shape: "
                         f"ms with {QUEUED_REPS} launches queued behind a "
                         f"spin kernel (gaps between launches included); "
                         f"busy_ms and library_ms (torch.linalg.cholesky_ex "
                         f"on the precomputed S + diag(pe)) as device busy "
                         f"time under torch.profiler (gaps left out)")


# -- the sparse-product slice ----------------------------------------------

def rel_err_np(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def random_bcsr(rng, m, n, density):
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.ops.spmv import to_bcsr
    S = sp.random(m, n, density, random_state=rng, format="csc")
    return S, to_bcsr(SparseCSC.from_scipy(S))


def bcsr_vs_plain(bc, X):
    """(kernel result, plain result, relative error) on the card."""
    from suitesparse_tpu_torch.ops.spmv import bcsr_spmm, bcsr_spmm_plain
    blocks, cols = bc.device_arrays(X.device)
    K = bcsr_spmm(bc, X)
    P = bcsr_spmm_plain(blocks, cols, X, bc.nslots, bc.shape)
    sync()
    return K, P, rel_err(K, P)


def phase_bcsr_vs_plain():
    """bcsr_spmm kernel vs its plain version on seeded random BCSR: one
    block, m and n not multiples of 128, k in {1, 7, 32, 50, 64, 128, 130,
    256} (every column tile, 16-byte and 4-byte X copies), rows with pad
    slots.  Tolerance 1e-5 relative in float32: both sum up to
    128 * nslots products in float32, in another order, the kernel each
    as three TF32 products (3xTF32, at most 3 * 2^-20 a product).  Then
    Inf and NaN in A, in X and in X's block 0 (pad slots): the kernel's
    isnan/isinf pattern and the signs of its infinities must be the plain
    version's."""
    import torch
    from suitesparse_tpu_torch.tools.bench_bcsr import inf_nan_case
    rng = np.random.default_rng(5)
    worst = 0.0
    for m, n, d, k in ((90, 100, 0.3, 1), (128, 128, 0.2, 50),
                       (1000, 700, 0.01, 1), (1000, 700, 0.01, 50),
                       (1000, 700, 0.01, 130), (700, 1100, 0.0001, 7),
                       (3000, 2500, 0.002, 64), (1000, 700, 0.01, 32),
                       (600, 900, 0.02, 128), (500, 400, 0.03, 256)):
        S, bc = random_bcsr(rng, m, n, d)
        X = torch.as_tensor(rng.standard_normal((n, k)),
                            dtype=torch.float32, device="cuda")
        K, P, err = bcsr_vs_plain(bc, X)
        nz = (bc.blocks.reshape(bc.nrb, bc.nslots, -1) != 0).any(2).sum(1)
        check(tuple(K.shape) == (m, k) and bool(torch.isfinite(K).all()),
              f"bcsr_spmm shape/finiteness at m={m} n={n} k={k}")
        check(err <= 1e-5, f"bcsr_spmm vs plain m={m} n={n} k={k}: {err:.2e}")
        ref = S @ X.double().cpu().numpy()
        e_ref = rel_err_np(K.double().cpu().numpy(), ref)
        check(e_ref <= 1e-5,
              f"bcsr_spmm vs scipy m={m} n={n} k={k}: {e_ref:.2e}")
        worst = max(worst, err)
        log(f"[kernel] bcsr_spmm m={m} n={n} k={k}: nrb={bc.nrb} "
            f"nslots={bc.nslots} pad slots={int((bc.nslots - nz).sum())} "
            f"vs plain {err:.3e}, vs scipy float64 {e_ref:.3e}")
    log(f"[kernel] bcsr_spmm vs plain, random cases: max relative error "
        f"{worst:.3e} (tol 1e-5)")
    bc, Xh = inf_nan_case(np.random.default_rng(11))
    K, P, _ = bcsr_vs_plain(bc, torch.as_tensor(Xh, device="cuda"))
    fin = torch.isfinite(P)
    check(bool(torch.isnan(P).any()) and bool(torch.isinf(P).any()),
          "the Inf/NaN case has no Inf or NaN in the plain result")
    check(torch.equal(torch.isnan(K), torch.isnan(P))
          and torch.equal(torch.isinf(K), torch.isinf(P))
          and torch.equal(torch.sign(K[torch.isinf(K)]),
                          torch.sign(P[torch.isinf(P)])),
          "bcsr_spmm's Inf/NaN pattern differs from plain's")
    e_fin = rel_err(K[fin], P[fin])
    check(e_fin <= 1e-5, f"bcsr_spmm's finite entries vs plain {e_fin:.2e}")
    log(f"[kernel] bcsr_spmm with Inf/NaN in A, X and X's block 0: "
        f"{int(torch.isnan(P).sum())} NaN and {int(torch.isinf(P).sum())} "
        f"Inf entries, the plain version's pattern and signs; finite "
        f"entries {e_fin:.3e} from plain")


def ops_matrix():
    """lap3d_44's full symmetric pattern in float32, and its scipy form."""
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.io.generators import synthetic_standin
    A = synthetic_standin(OPS_MATRIX).to_full_storage()
    A = SparseCSC(A.indptr, A.indices, A.data.astype(np.float32), A.shape)
    return A, A.to_scipy().astype(np.float64)


def run_ops(A, S):
    """The slice's products on lap3d_44, each against a host float64
    oracle; returns (row, BCSR, {k: X})."""
    import torch
    from suitesparse_tpu_torch.graphblas import mxv
    from suitesparse_tpu_torch.models import sfmult, ssmult
    from suitesparse_tpu_torch.ops import (bcsr_spmm, spgemm, spmm_program,
                                           to_bcsr)
    from suitesparse_tpu_torch.tools.bench_bcsr import K_WIDTHS
    n = A.ncol
    t_bcsr, bc = host_time(lambda: to_bcsr(A))
    check(bc.nrb * bc.nslots == 666 * 7,
          f"lap3d_44 BCSR is {bc.nrb} x {bc.nslots}, expected 666 x 7")
    real = int((bc.blocks.reshape(bc.nrb * bc.nslots, -1) != 0).any(1).sum())
    log(f"[ops] {OPS_MATRIX} n={n} nnz={A.nnz}: to_bcsr {t_bcsr:.2f} s, "
        f"{bc.nrb} block rows x {bc.nslots} slots ({real} nonzero blocks, "
        f"{bc.blocks.nbytes / 1e6:.1f} MB of float32 blocks)")
    rng = np.random.default_rng(6)
    row = dict(matrix=OPS_MATRIX, n=n, nnz=A.nnz, to_bcsr_s=t_bcsr,
               nrb=bc.nrb, nslots=bc.nslots, nonzero_blocks=real)
    Xs = {}
    for k in K_WIDTHS:
        Xh = rng.standard_normal((n, k)).astype(np.float32)
        X = torch.as_tensor(Xh, device="cuda")
        Xs[k] = X
        ref = S @ Xh.astype(np.float64)
        t, Y = host_time(lambda: bcsr_spmm(bc, X))
        e_bcsr = rel_err_np(Y.double().cpu().numpy(), ref)
        check(tuple(Y.shape) == (n, k) and e_bcsr <= 1e-5,
              f"bcsr_spmm k={k} vs scipy: {e_bcsr:.2e}")
        run = spmm_program(A, device="cuda")
        Z = run(A.data, X)
        e_seg = rel_err_np(Z.double().cpu().numpy(), ref)
        check(Z.dtype == torch.float32 and e_seg <= 1e-5,
              f"spmm_program k={k} vs scipy: {e_seg:.2e}")
        # no atomics on either path: a second call is bit-identical
        check(torch.equal(bcsr_spmm(bc, X), Y)
              and torch.equal(run(A.data, X), Z),
              f"k={k}: a repeated product is not bit-identical")
        ts, F = host_time(lambda: sfmult(A, Xh, device="cuda"))
        e_sf = rel_err_np(F.astype(np.float64), ref)
        check(e_sf <= 1e-5, f"sfmult k={k} vs scipy: {e_sf:.2e}")
        log(f"[ops] k={k}: bcsr_spmm {e_bcsr:.3e} (first call {t * 1e3:.2f} "
            f"ms), spmm_program {e_seg:.3e}, sfmult {e_sf:.3e} "
            f"({ts:.2f} s, {k} column programs) relative to scipy float64; "
            f"repeated products bit-identical")
        row[f"rel_err_k{k}"] = dict(bcsr_spmm=e_bcsr, spmm_program=e_seg,
                                    sfmult=e_sf)
    ref = (S @ S).tocsc()
    ref.sort_indices()
    prods = []
    for name, fn in (("spgemm", lambda: spgemm(A, A, device="cuda")),
                     ("ssmult", lambda: ssmult(A, A, device="cuda"))):
        t, C = host_time(fn)
        prods.append(C.data)
        check(np.array_equal(C.indptr, ref.indptr)
              and np.array_equal(C.indices, ref.indices),
              f"{name}(A, A) pattern differs from scipy's")
        e = rel_err_np(C.data.astype(np.float64), ref.data)
        check(C.data.dtype == np.float32 and e <= 1e-5,
              f"{name}(A, A) values vs scipy: {e:.2e}")
        log(f"[ops] {name}(A, A): nnz {C.nnz}, pattern identical, values "
            f"{e:.3e} relative to scipy float64; {t:.2f} s "
            f"(plan cached after the first)")
        row[f"{name}_s"] = t
        row[f"{name}_rel_err"] = e
    check(np.array_equal(prods[0], prods[1]),
          "spgemm and ssmult (the same program) are not bit-identical")
    x = rng.uniform(-1, 1, n).astype(np.float32)
    t, y = host_time(lambda: mxv(A, x, "min_plus", device="cuda"))
    Sr = A.to_scipy().tocsr()
    terms = Sr.data + x[Sr.indices]                       # float32, as y
    want = np.minimum.reduceat(terms, Sr.indptr[:-1])
    check(bool(np.array_equal(y.cpu().numpy(), want)),
          "mxv min_plus differs from the numpy oracle")
    log(f"[ops] mxv min_plus: identical to the numpy oracle ({t * 1e3:.1f} "
        f"ms, first call)")
    row["mxv_min_plus_ms"] = t * 1e3
    return row, bc, Xs


def ring_chords(n, seed):
    """Ring + 3n random chords: connected, ~4 edges a vertex (the JAX
    package's at-scale algorithm tests)."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), rng.integers(0, n, 3 * n)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, 3 * n)])
    keep = src != dst
    S = sp.csc_matrix((np.ones(keep.sum()), (src[keep], dst[keep])),
                      shape=(n, n))
    S.sum_duplicates()
    S.data[:] = 1.0
    return SparseCSC.from_scipy(S)


def symmetric_random(n, seed):
    """Symmetrized random graph with 4n edges (the same tests')."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 4 * n)
    dst = rng.integers(0, n, 4 * n)
    keep = src != dst
    S = sp.csc_matrix((np.ones(keep.sum()), (src[keep], dst[keep])),
                      shape=(n, n))
    return SparseCSC.from_scipy(((S + S.T) != 0).astype(float).tocsc())


def pagerank_oracle(A, damping=0.85, tol=1e-9, max_iter=30):
    """numpy float64 power iteration with the reference's stopping rule;
    returns (rank, iterations)."""
    n = A.shape[0]
    rows = A.indices
    cols = np.repeat(np.arange(n), np.diff(A.indptr))
    w = 1.0 / np.maximum(np.bincount(rows, minlength=n), 1)[rows]
    r = np.full(n, 1.0 / n)
    delta, it = np.inf, 0
    while delta > tol and it < max_iter:
        y = np.bincount(cols, weights=w * r[rows], minlength=n)
        rnew = damping * y + (1.0 - damping) / n
        rnew = rnew + (r.sum() - rnew.sum()) / n
        delta = np.abs(rnew - r).sum()
        r, it = rnew, it + 1
    return r, it


def run_graph():
    """PageRank, BFS and triangle counting at n = GRAPH_N on the card."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch.graphblas import (bfs_levels, pagerank,
                                                 triangle_count)
    n = GRAPH_N
    t_gen, G = host_time(lambda: ring_chords(n, 21))
    row = dict(n=n, ring_chords_nnz=G.nnz, gen_s=t_gen)
    t_pr, pr = host_time(lambda: pagerank(G, max_iter=30, device="cuda"))
    want, iters = pagerank_oracle(G)
    e = rel_err_np(pr.astype(np.float64), want)
    check(np.array_equal(pagerank(G, max_iter=30, device="cuda"), pr),
          "a second pagerank is not bit-identical")
    # the iteration the port stopped at: the least cap that gives the same
    # ranks (a cap at or past the stop changes nothing), by bisection
    lo, hi = 1, 30
    while lo < hi:
        mid = (lo + hi) // 2
        if np.array_equal(pagerank(G, max_iter=mid, device="cuda"), pr):
            hi = mid
        else:
            lo = mid + 1
    port_iters = lo
    check(pr.shape == (n,) and abs(float(pr.sum()) - 1.0) <= 1e-3,
          f"pagerank sum {pr.sum()}")
    check(e <= 1e-5, f"pagerank vs numpy power iteration: {e:.2e}")
    log(f"[graph] ring+chords n={n} nnz={G.nnz}: pagerank {t_pr:.3f} s "
        f"({port_iters} iterations = host syncs; the float64 oracle "
        f"stopped at {iters}), sum {pr.sum():.6f}, "
        f"{e:.3e} relative to numpy float64; a second run bit-identical")
    t_dev, lv = host_time(lambda: bfs_levels(G, 0, "device",
                                                   device="cuda"))
    t_push, lp = host_time(lambda: bfs_levels(G, 0, "push"))
    check(lv.dtype == np.int32 and np.array_equal(lv, lp),
          "bfs device differs from push")
    check(bool((lv >= 0).all()), "bfs: the ring graph is connected")
    log(f"[graph] bfs from 0: device {t_dev:.3f} s, push {t_push:.3f} s, "
        f"identical, depth {int(lv.max())} (one host sync a level)")
    H = symmetric_random(n, 23)
    t_tc, tc = host_time(lambda: triangle_count(H, device="cuda"))
    t_tc2, tc2 = host_time(lambda: triangle_count(H, device="cuda"))
    L = sp.tril(H.to_scipy(), -1).tocsc()
    want_tc = int((L @ L.T).multiply(L).sum())
    check(tc == tc2 == want_tc, f"triangle_count {tc} vs scipy {want_tc}")
    log(f"[graph] symmetric random n={n} nnz={H.nnz}: triangle_count "
        f"{tc} = scipy's; {t_tc:.2f} s with the host plan, {t_tc2:.2f} s "
        f"with the plan cached")
    row.update(pagerank_s=t_pr, pagerank_iters=port_iters,
               pagerank_oracle_iters=iters, pagerank_rel_err=e,
               bfs_device_s=t_dev, bfs_push_s=t_push, bfs_depth=int(lv.max()),
               symmetric_nnz=H.nnz, triangles=tc, triangle_s=t_tc,
               triangle_cached_s=t_tc2)
    return row


def bcsr_kernel_line(bc, Xs, S, launches, dev_kind):
    """Check and time bcsr_spmm on lap3d_44's block table at each k with
    the BCSR bench's ``measure`` (the code that times two source trees
    against each other), beside its plain version, its bound and torch's
    BSR product (cuSPARSE, a yardstick the port never calls).  The bound
    is that of the design in use: the kernel runs each product as three
    TF32 products on the tensor cores, so it is the larger of the bytes
    over the HBM rate and 3 x flops over the dense TF32 peak; the
    CUDA-core bound of float32 FMAs (flops over 67 TFLOP/s, which the
    parent design could not beat) is kept beside it as
    ``bound_f32_cuda_core_ms``."""
    import torch
    from suitesparse_tpu_torch.ops.spmv import bcsr_spmm_plain
    from suitesparse_tpu_torch.tools.bench_bcsr import (K_WIDTHS, REPS,
                                                        measure)
    blocks, cols = bc.device_arrays(torch.device("cuda"))
    m, n = bc.shape
    ncb = -(-n // bc.bk)
    # the library's BSR holds only the nonzero blocks (pad slots dropped)
    keep = (blocks.reshape(blocks.shape[0], -1) != 0).any(1)
    counts = keep.view(bc.nrb, bc.nslots).sum(1)
    crow = torch.zeros(bc.nrb + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(counts, 0)
    B = torch.sparse_bsr_tensor(crow, cols[keep].long(), blocks[keep],
                                size=(bc.nrb * bc.bm, ncb * bc.bk))
    nslot = bc.nrb * bc.nslots
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, f32_ms=0.0)
    extra = {}
    max_abs = 0.0
    for k in K_WIDTHS:
        X = Xs[k]
        r = measure(bc, X, S)
        ms, err = r["ms"], r["rel_err_plain"]
        max_abs = max(max_abs, r["max_abs_err"])
        P = bcsr_spmm_plain(blocks, cols, X, bc.nslots, bc.shape)
        Xp = torch.zeros((ncb * bc.bk, k), device="cuda")
        Xp[:n] = X
        Z = (B @ Xp)[:m]
        check(rel_err(Z, P) <= 1e-5, f"BSR library product k={k}")
        plain = event_ms(lambda: bcsr_spmm_plain(blocks, cols, X, bc.nslots,
                                                 bc.shape), 20)
        lib = event_ms(lambda: B @ Xp, 20)
        # every slot is a dense 128 x 128 x k product (pad slots included,
        # as the kernel computes them); each input read once, the output
        # written once
        flops = nslot * 2 * bc.bm * bc.bk * k
        nbytes = blocks.numel() * 4 + cols.numel() * 4 + X.numel() * 4 \
            + m * k * 4
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
        t_f32 = max(t_bytes, flops / PEAK_F32_FLOPS * 1e3)
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernel] bcsr_spmm {OPS_MATRIX} k={k}: {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s of the product; plain "
            f"{plain:.4f} ms, bound {bound:.4f} ms by {by} (3xTF32 on the "
            f"tensor cores; float32 CUDA cores {t_f32:.4f} ms), torch BSR @ "
            f"dense {lib:.4f} ms) vs plain {err:.3e}, vs scipy float64 "
            f"{r['rel_err_scipy']:.3e} on {dev_kind}")
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                       ("library_ms", lib), ("bytes_ms", t_bytes),
                       ("ops_ms", t_ops), ("f32_ms", t_f32)):
            tot[key] += v
        extra.update({f"ms_k{k}": ms, f"plain_ms_k{k}": plain,
                      f"bound_ms_k{k}": bound, f"bound_by_k{k}": by,
                      f"bound_f32_cuda_core_ms_k{k}": t_f32,
                      f"library_ms_k{k}": lib, f"rel_err_plain_k{k}": err,
                      f"rel_err_scipy_k{k}": r["rel_err_scipy"]})
    return dict(name="bcsr_spmm", route="cuda",
                source="suitesparse_tpu_torch/csrc/bcsr_spmm.cu",
                replaces="suitesparse_tpu/ops/spmv.py:154",
                launches=launches, max_abs_err=max_abs,
                ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"],
                bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                          else "operations"),
                library_ms=tot["library_ms"],
                bound_f32_cuda_core_ms=tot["f32_ms"],
                bound_as="max(bytes / 3.35 TB/s, 3 x flops / 495 TFLOP/s "
                         "TF32): three TF32 products a product (3xTF32); "
                         "bound_f32_cuda_core_ms: flops / 67 TFLOP/s "
                         "float32",
                timed_as=f"one call at each k in {list(K_WIDTHS)} on "
                         f"{OPS_MATRIX}'s block table, summed (the BCSR "
                         f"bench's measure: CUDA events over {REPS} "
                         f"launches)",
                **extra)


# -- the dispatch-floor probes ----------------------------------------------

def phase_dispatch_vs_plain() -> dict:
    """scale_blocks and scale_gather vs their plain versions on the card,
    bit for bit (one float32 multiply by the same constant), at every G of
    DISPATCH_CHECK_G, offsets reversed, random and sparse (only the named
    rows compared); overlapping windows and a misaligned buffer refused.
    Returns the largest |kernel - plain| of each (0.0 when they agree)."""
    import torch
    from suitesparse_tpu_torch.tools import microbench_dispatch as probe
    rng = np.random.default_rng(8)
    worst = dict(scale_blocks=0.0, scale_gather=0.0)
    for G in DISPATCH_CHECK_G:
        rows = G * probe.ROWS
        buf = torch.as_tensor(rng.standard_normal((rows, probe.COLS)),
                              dtype=torch.float32, device="cuda")
        P = probe.scale_blocks_plain(buf, G)
        K = probe.scale_blocks(buf, G)
        sync()
        worst["scale_blocks"] = max(worst["scale_blocks"],
                                    float((K - P).abs().max()))
        check(torch.equal(K, P), f"scale_blocks G={G} differs from plain")
        for order in ("reversed", "random", "sparse"):
            offs = (np.arange(G)[::-1] * probe.ROWS if order == "reversed"
                    else rng.permutation(G) * probe.ROWS
                    if order == "random" else
                    probe.sparse_offsets(rng, G))
            table = probe.GatherTable(offs, rows)
            named = table.row_index(buf.device)
            Pg = probe.scale_gather_plain(table, buf)
            check(torch.equal(Pg[named], P[named]),
                  "plain scale_gather differs from plain scale_blocks")
            Kg = probe.scale_gather(table, buf)
            sync()
            worst["scale_gather"] = max(
                worst["scale_gather"],
                float((Kg[named] - Pg[named]).abs().max()))
            check(torch.equal(Kg[named], Pg[named]),
                  f"scale_gather G={G} {order} differs from plain")
    refused = []
    try:
        probe.scale_gather(np.array([0, probe.ROWS // 2]), buf)
    except ValueError:
        refused.append("overlapping offsets")
    flat = torch.zeros(probe.ROWS * probe.COLS + 1, device="cuda")
    try:
        probe.scale_blocks(flat[1:].view(probe.ROWS, probe.COLS), 1)
    except RuntimeError:
        refused.append("a misaligned buffer")
    check(len(refused) == 2, f"the probes refused only {refused}")
    log(f"[dispatch] scale_blocks and scale_gather vs plain at G in "
        f"{list(DISPATCH_CHECK_G)}, reversed, random and sparse offsets: "
        f"bit-identical (max |diff| {worst}); refused {' and '.join(refused)}")
    return worst


def dispatch_kernel_lines(res, launches, max_abs, dev_kind):
    """The kernels-line entries of the two probes from ``main()``'s device
    times (CUDA events over 20 launches queued behind a spin kernel, on
    buffers that together exceed the L2 cache), beside their plain
    versions (timed the same way) and their bound, summed over the grid
    sizes; ``torch.mul`` is the library call of the same function.  Each
    also carries its one-block time (warm) and host times per call from
    the launch-floor line, beside torch.mul's."""
    from suitesparse_tpu_torch.tools import microbench_dispatch as probe
    out = []
    floor = res["floor"]
    for name, key, line, gathered, fkey in (
            ("scale_blocks", "kernel", 69, False, "kernel"),
            ("scale_gather", "gathered", 92, True, "gather")):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0)
        extra = {"ms_G1": floor[f"{fkey}_device_s"] * 1e3,
                 "host_ms_G1": floor[f"{fkey}_host_s"] * 1e3,
                 "library_ms_G1": floor["mul_device_s"] * 1e3,
                 "library_host_ms_G1": floor["mul_host_s"] * 1e3}
        for G in DISPATCH_G:
            r = res[key][G]
            rows = G * probe.ROWS
            bufs = probe.cold_buffers(G, "cuda")
            if gathered:
                table = probe.GatherTable(np.arange(G)[::-1] * probe.ROWS,
                                          rows)
                plain = probe.device_time(probe.scale_gather_plain,
                                          [(table, b) for b in bufs]) * 1e3
            else:
                plain = probe.device_time(probe.scale_blocks_plain,
                                          [(b, G) for b in bufs]) * 1e3
            del bufs
            # each block read once and written once (and the offset table
            # read once); one multiply per element
            nbytes = 2 * rows * probe.COLS * 4 + (4 * G if gathered else 0)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = rows * probe.COLS / PEAK_F32_FLOPS * 1e3
            ms, lib = r["device_s"] * 1e3, r["mul_s"] * 1e3
            log(f"[kernel] {name} G={G}: {ms * 1e3:.2f} us on the device "
                f"({ms * 1e3 / G:.3f} us/block), {r['host_s'] * 1e6:.2f} us "
                f"a call on the host clock (torch.mul "
                f"{r['mul_host_s'] * 1e6:.2f}); plain {plain * 1e3:.2f} us, "
                f"torch.mul {lib * 1e3:.2f} us, bound "
                f"{max(t_bytes, t_ops) * 1e3:.2f} us by bytes on {dev_kind}")
            for k, v in (("ms", ms), ("plain_ms", plain),
                         ("bound_ms", max(t_bytes, t_ops)),
                         ("library_ms", lib), ("bytes_ms", t_bytes),
                         ("ops_ms", t_ops)):
                tot[k] += v
            extra.update({f"ms_G{G}": ms, f"host_ms_G{G}": r["host_s"] * 1e3,
                          f"plain_ms_G{G}": plain, f"library_ms_G{G}": lib,
                          f"library_host_ms_G{G}": r["mul_host_s"] * 1e3,
                          f"bound_ms_G{G}": max(t_bytes, t_ops)})
        out.append(dict(
            name=name, route="cuda",
            source="suitesparse_tpu_torch/csrc/dispatch_probe.cu",
            replaces=f"tools/microbench_dispatch.py:{line}",
            launches=launches[name], max_abs_err=max_abs[name],
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                      else "operations"),
            library_ms=tot["library_ms"],
            timed_as=f"one launch at each G in {list(DISPATCH_G)} (CUDA "
                     f"events over 20 launches queued behind a spin kernel, "
                     f"L2-cold, in the probe's main()), summed; *_G1: one "
                     f"warm block, the launch-floor line",
            **extra))
    return out


# -- the Cholesky front end ---------------------------------------------------

def run_front():
    """spsolve_chol, CholeskySolver, the wave program and syrk_bf16 on
    FRONT_MATRIX at full size, float32 factors on the card, each solve
    refined REFINE_STEPS times in float64 on the host."""
    import torch
    from suitesparse_tpu_torch.cholesky import (CholeskySolver, cholesky,
                                                residual_norm, spsolve_chol)
    from suitesparse_tpu_torch.cholesky.super_numeric import _assemble_values
    from suitesparse_tpu_torch.cholesky.wave import wave_numeric
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.io.generators import (symmetrize_upper,
                                                     synthetic_standin)
    A = synthetic_standin(FRONT_MATRIX)
    if A.stype == 0:
        A = symmetrize_upper(A)
    n = A.ncol
    b = np.random.default_rng(9).standard_normal(n)
    Sf = A.to_scipy().astype(np.float64)

    def common(**opts):
        cm = default_common()
        cm.cholesky.supernodal = "supernodal"
        cm.cholesky.program = "pf"
        for k, v in opts.items():
            setattr(cm.cholesky, k, v)
        return cm

    def refined(solve):
        """Residual of the raw solve and after each refinement step."""
        x = solve(b).astype(np.float64)
        res = [residual_norm(A, x, b)]
        for _ in range(REFINE_STEPS):
            x = x + solve(b - Sf @ x).astype(np.float64)
            res.append(residual_norm(A, x, b))
        return res

    t_sp, x = host_time(lambda: spsolve_chol(A, b, common(),
                                             refine_steps=REFINE_STEPS))
    res_sp = residual_norm(A, x, b)
    check(res_sp <= RESIDUAL_MAX,
          f"spsolve_chol residual {res_sp:.3e} > {RESIDUAL_MAX}")
    log(f"[front] {FRONT_MATRIX} n={n}: spsolve_chol (analysis, float32 "
        f"factor on the card, {REFINE_STEPS} float64 refinement steps) "
        f"{t_sp:.2f} s, residual {res_sp:.3e} (limit {RESIDUAL_MAX})")

    t_an, solver = host_time(lambda: cholesky(A, common(), device="cuda"))
    f0 = solver.factor
    check(f0.Lx.device.type == "cuda" and f0.Lx.dtype == torch.float32,
          f"CholeskySolver factor on {f0.Lx.device} {f0.Lx.dtype}")
    t_r1, _ = host_time(lambda: solver.refactorize(A))
    L1 = solver.factor.Lx
    t_r2, _ = host_time(lambda: solver.refactorize(A))
    L2 = solver.factor.Lx
    check(torch.equal(f0.Lx, L1) and torch.equal(L1, L2),
          "CholeskySolver refactorizations are not bit-identical")
    res_pf = refined(solver.solve)
    check(res_pf[-1] <= RESIDUAL_MAX, f"pf residual {res_pf[-1]:.3e}")
    tot = solver.plan.total
    Lpf = L2[:tot]
    log(f"[front] cholesky() {t_an:.2f} s; refactorize x2 {t_r1:.3f} / "
        f"{t_r2:.3f} s, bit-identical; residuals raw and refined {res_pf}")

    tsolver = CholeskySolver(sym=solver.sym, common=common(trsm_inv=False),
                             ss=solver.ss, plan=solver.plan, device="cuda")
    t_t1, _ = host_time(lambda: tsolver.refactorize(A))
    Lt1 = tsolver.factor.Lx
    t_t2, _ = host_time(lambda: tsolver.refactorize(A))
    check(tsolver.factor.ok and torch.equal(Lt1, tsolver.factor.Lx),
          "trsm_inv=False refactorizations are not bit-identical")
    del Lt1
    d_tri = rel_err(tsolver.factor.Lx[:tot], Lpf)
    check(d_tri <= 1e-3, f"trsm_inv=False vs default factor {d_tri:.3e}")
    res_tri = refined(tsolver.solve)
    check(res_tri[-1] <= RESIDUAL_MAX,
          f"trsm_inv=False residual {res_tri[-1]:.3e}")
    log(f"[front] trsm_inv=False (torch.linalg Cholesky + triangular "
        f"solve in every factor wave): refactorize x2 {t_t1:.3f} / "
        f"{t_t2:.3f} s (default {t_r1:.3f} / {t_r2:.3f} s), bit-identical; "
        f"relative difference to the default factor {d_tri:.3e}; "
        f"residuals raw and refined {res_tri}")
    del tsolver

    t_wp, wp = host_time(lambda: solver.plan.wave_plan())
    wsolver = CholeskySolver(sym=solver.sym, common=common(program="wave"),
                             ss=solver.ss, plan=solver.plan, device="cuda")
    t_w1, _ = host_time(lambda: wsolver.refactorize(A))
    check(wsolver.factor.ok, f"wave factor minor {wsolver.factor.minor}")
    vd = torch.as_tensor(_assemble_values(A, solver.sym, solver.ss,
                                          np.float32), device="cuda")
    t_wave = []
    for _ in range(REFACTOR_REPS):
        t, Lw = host_time(lambda: wave_numeric(vd, wp, np.float32,
                                               device="cuda"))
        t_wave.append(t)
    check(torch.equal(Lw, wsolver.factor.Lx),
          "wave refactorizations are not bit-identical")
    del Lw
    d_wave = rel_err(wsolver.factor.Lx[:tot], Lpf)
    # two float32 factors of one matrix by other operation orders
    check(d_wave <= 1e-3, f"wave vs pf factor {d_wave:.3e}")
    res_wave = refined(wsolver.solve)
    check(res_wave[-1] <= RESIDUAL_MAX, f"wave residual {res_wave[-1]:.3e}")
    log(f"[front] wave program: {len(wp.instr_cls)} waves in "
        f"{len(wp.classes)} classes, plan {t_wp:.2f} s, first factor "
        f"{t_w1:.3f} s, refactor median {np.median(t_wave) * 1e3:.1f} ms "
        f"(all {[round(t * 1e3, 1) for t in t_wave]}), bit-identical; "
        f"relative difference to the pf factor {d_wave:.3e}; residuals "
        f"{res_wave}")

    bsolver = CholeskySolver(sym=solver.sym, common=common(syrk_bf16=True),
                             ss=solver.ss, plan=solver.plan, device="cuda")
    t_b, _ = host_time(lambda: bsolver.refactorize(A))
    d_bf16 = rel_err(bsolver.factor.Lx[:tot], Lpf)
    # float32 refactorizations without the option are bit-identical, so
    # any difference is the bf16 rounding (2**-9 relative a value)
    check(1e-5 < d_bf16 < 1e-2,
          f"syrk_bf16 factor vs float32 factor {d_bf16:.3e}")
    res_bf16 = refined(bsolver.solve)
    check(all(r1 < r0 for r0, r1 in zip(res_bf16, res_bf16[1:])),
          f"refinement of the bf16 factor does not contract: {res_bf16}")
    log(f"[front] syrk_bf16 (pf): factor {t_b:.3f} s, relative difference "
        f"to the float32 factor {d_bf16:.3e}; residual raw {res_bf16[0]:.3e}"
        f", after each refinement step {res_bf16[1:]}")
    return dict(matrix=FRONT_MATRIX, n=n, spsolve_chol_s=t_sp,
                spsolve_chol_residual=res_sp, cholesky_s=t_an,
                refactorize_s=[t_r1, t_r2], pf_residuals=res_pf,
                trsm_inv_false_refactorize_s=[t_t1, t_t2],
                trsm_inv_false_vs_default_rel=d_tri,
                trsm_inv_false_residuals=res_tri,
                wave_plan_s=t_wp, wave_first_factor_s=t_w1,
                wave_refactor_ms=float(np.median(t_wave)) * 1e3,
                wave_refactor_ms_all=[t * 1e3 for t in t_wave],
                wave_waves=int(len(wp.instr_cls)),
                wave_vs_pf_rel=d_wave, wave_residuals=res_wave,
                bf16_factor_s=t_b, bf16_vs_f32_rel=d_bf16,
                bf16_residuals=res_bf16)


# ---------------------------------------------------------------------------
# The LU family: multifrontal LU (umf_*) and KLU's device twin
# ---------------------------------------------------------------------------

def cd3d(m: int, p: float = LU_PECLET):
    """The 7-point first-order upwind convection-diffusion operator on the
    m^3 grid: the Kronecker sum of tridiag(-(1+p), 2+p, -1) along each
    axis (cell Peclet number p) -- a symmetric pattern with unsymmetric
    values, n = m^3."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    T = sp.diags([np.full(m - 1, -(1.0 + p)), np.full(m, 2.0 + p),
                  np.full(m - 1, -1.0)], [-1, 0, 1])
    eye = sp.identity(m)
    A = (sp.kron(sp.kron(T, eye), eye) + sp.kron(sp.kron(eye, T), eye)
         + sp.kron(sp.kron(eye, eye), T))
    return SparseCSC.from_scipy(sp.csc_matrix(A))


def lu_matrices():
    """The [lu] phase's multifrontal matrices: (name, A)."""
    from suitesparse_tpu_torch.io.generators import random_unsym
    return (("cd3d_44", cd3d(44)),
            ("randunsym_5000", random_unsym(5000, density=0.008)))


def omega(A, x, b, system="A") -> float:
    """umf_solve's componentwise backward error of x for ``system``."""
    S = A.to_scipy()
    S = S.conj().T if system == "At" else S
    r = b - S @ x
    return float(np.abs(r).max() / max(
        A.norm(np.inf) * np.abs(x).max() + np.abs(b).max(), 1e-300))


def same_numeric(a, b) -> bool:
    """Bit-identical L and U buffers and block pivots."""
    import torch
    return (torch.equal(a.Lb, b.Lb) and torch.equal(a.Ub, b.Ub)
            and all(torch.equal(p, q) for la, lb in zip(a.pivs, b.pivs)
                    for p, q in zip(la, lb)))


def run_lu_matrix(name, A) -> dict:
    """umf_symbolic, a first umf_numeric on the card, LU_REPS
    refactorizations with the same symbolic (bit-identical; the median of
    their host-side value scaling and permutation beside it), one profiled
    refactorization, and umf_solve for systems A and At: the float32
    factor's own omega <= LU_OMEGA_RAW_MAX, and after LU_REFINE float64
    refinement steps omega <= LU_OMEGA_MAX with no escalation to host
    KLU."""
    import torch
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.lu import umf_numeric, umf_solve, umf_symbolic
    n = A.ncol
    cm = default_common()
    t0 = time.perf_counter()
    S = umf_symbolic(A, cm)
    t_sym = time.perf_counter() - t0
    check(S.singles is None, f"{name}: took the BTF path")
    plan = S.plan
    log(f"[lu] {name} n={n} nnz={A.nnz} strategy={S.strategy} "
        f"plan.total={plan.total} buckets={plan.nbuckets} "
        f"levels={len(plan.levels)} umf_symbolic {t_sym:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    t_first, num = host_time(lambda: umf_numeric(A, S, cm))
    check(not num.singular, f"{name}: numeric flagged singular")
    check(num.Lb.device.type == "cuda", f"{name}: factor on {num.Lb.device}")
    t_ref, t_val = [], []
    for _ in range(LU_REPS):
        v0 = cm.info["time_umf_values"]
        t, again = host_time(lambda: umf_numeric(A, S, cm))
        t_ref.append(t)
        t_val.append(cm.info["time_umf_values"] - v0)
        check(same_numeric(num, again),
              f"{name}: refactorizations are not bit-identical")
        del again
    t_med = float(np.median(t_ref))
    prof = profile_refactor(f"lu_{name}", lambda: umf_numeric(A, S, cm),
                            t_med * 1e3, PROFILE_DIR)
    log("[profile] " + json.dumps(prof))
    rng = np.random.default_rng(LU_SEED)
    solves = {}
    for system in ("A", "At"):
        b = rng.standard_normal(n)
        t_raw, x0 = host_time(lambda: umf_solve(num, b, system, refine=0,
                                                common=default_common()))
        w_raw = omega(A, x0, b, system)
        check(w_raw <= LU_OMEGA_RAW_MAX,
              f"{name} {system}: unrefined omega {w_raw:.3e} > "
              f"{LU_OMEGA_RAW_MAX}")
        cs = default_common()
        t_sol, x = host_time(lambda: umf_solve(num, b, system,
                                               refine=LU_REFINE, A=A,
                                               common=cs))
        steps = [cs.info[k] for k in sorted(cs.info)
                 if k.startswith("umf_omega_")]
        w = omega(A, x, b, system)
        check(tuple(x.shape) == (n,) and bool(np.isfinite(x).all()),
              f"{name} {system}: solution shape/finiteness")
        check("umf_escalated" not in cs.info,
              f"{name} {system}: escalated to host KLU")
        check(w <= LU_OMEGA_MAX,
              f"{name} {system}: omega {w:.3e} > {LU_OMEGA_MAX}")
        solves[system] = dict(solve_raw_s=t_raw, omega_raw=w_raw,
                              solve_refined_s=t_sol, omega_steps=steps,
                              omega_final=w)
    return dict(matrix=name, n=n, nnz=int(A.nnz), strategy=S.strategy,
                plan_total=int(plan.total), buckets=int(plan.nbuckets),
                levels=len(plan.levels), umf_symbolic_s=t_sym,
                first_numeric_s=t_first, refactor_ms=t_med * 1e3,
                refactor_ms_all=[t * 1e3 for t in t_ref],
                host_values_ms=float(np.median(t_val)) * 1e3,
                bit_identical_refactor=True,
                device_busy_ms=prof["device_busy_ms"],
                idle_share=prof["idle_share"], solves=solves,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def run_lu_singular() -> dict:
    """cd3d_12 with one row's values set to stored zeros, singletons off so
    the device numeric runs: flagged singular, status SINGULAR."""
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.core.status import Status
    from suitesparse_tpu_torch.lu import umf_numeric, umf_symbolic
    A = cd3d(12)
    row = A.ncol // 2
    data = A.data.copy()
    data[A.indices == row] = 0.0
    A0 = SparseCSC(A.indptr, A.indices, data, A.shape)
    check(A0.nnz == A.nnz, "the zeroed row's entries were dropped")
    cm = default_common()
    cm.lu.singletons = False
    num = umf_numeric(A0, umf_symbolic(A0, cm), cm)
    check(num.Lb.device.type == "cuda", f"singular case on {num.Lb.device}")
    check(num.singular, "cd3d_12 with a zero row: not flagged singular")
    check(cm.status == Status.SINGULAR, f"cd3d_12 zero row: {cm.status}")
    return dict(matrix="cd3d_12_zero_row", n=A.ncol, row=row,
                singular=True, status=cm.status.name)


def run_klu() -> dict:
    """KLU on circuit_like(KLU_N): klu_analyze/klu_factor/klu_refactor/
    klu_solve on the host in float64 through the native kernel (the klu_host
    tool), then klu_device on the card: LU_REPS refactorizations
    (bit-identical), one profiled, the solve against the host's, a batched
    sweep of KLU_SWEEP value sets, and a zero pivot that flips ``ok``."""
    import torch
    from suitesparse_tpu_torch.cholesky import residual_norm
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.io.generators import circuit_like
    from suitesparse_tpu_torch.lu import klu_device
    from suitesparse_tpu_torch.tools import klu_host
    n = KLU_N
    A = circuit_like(n)
    rng = np.random.default_rng(LU_SEED)
    b = rng.standard_normal(n)
    sym, num, xh, host = klu_host.run(A, b)
    log(f"[lu] circuit_{n} host KLU (native {host['native']}): "
        f"{json.dumps(host)}")

    t_plan, (plan, refactor, solve) = host_time(
        lambda: klu_device(A, sym, num))
    av = torch.as_tensor(A.data, dtype=torch.float32, device="cuda")
    t_ref, first = [], None
    for _ in range(LU_REPS):
        t, out = host_time(lambda: refactor(av))
        t_ref.append(t)
        first = first or out
        check(all(torch.equal(f, g) for f, g in zip(first[0], out[0]))
              and torch.equal(first[1], out[1]) and bool(out[2]),
              f"circuit_{n}: device refactorizations differ or not ok")
    factors, Rs, ok = first
    check(Rs.device.type == "cuda", f"circuit_{n}: klu_device on {Rs.device}")
    t_med = float(np.median(t_ref))
    prof = profile_refactor(f"klu_circuit_{n}", lambda: refactor(av),
                            t_med * 1e3, PROFILE_DIR)
    log("[profile] " + json.dumps(prof))
    ms_solve = []
    for _ in range(LU_REPS):
        t, x = host_time(lambda: solve(factors, Rs, av, b))
        ms_solve.append(t * 1e3)
    xd = x.double().cpu().numpy()
    res_d = residual_norm(A, xd, b)
    rel_h = float(np.abs(xd - xh).max() / np.abs(xh).max())
    check(res_d <= KLU_RES_MAX,
          f"circuit_{n} device residual {res_d:.3e} > {KLU_RES_MAX}")
    check(rel_h <= KLU_RES_MAX,
          f"circuit_{n} device vs host solution {rel_h:.3e}")

    scale = rng.uniform(0.9, 1.1, (KLU_SWEEP, A.nnz))
    vals = torch.as_tensor(A.data[None, :] * scale, dtype=torch.float32,
                           device="cuda")
    t_sw, (fs, Rss, oks) = host_time(lambda: refactor(vals))
    t_sws, xs = host_time(lambda: solve(fs, Rss, vals, b))
    check(tuple(xs.shape) == (KLU_SWEEP, n) and bool(oks.all()),
          f"circuit_{n} sweep: shape {tuple(xs.shape)}, ok {oks.tolist()}")
    res_sw = []
    for s in range(KLU_SWEEP):
        At = SparseCSC(A.indptr, A.indices, A.data * scale[s], A.shape)
        res_sw.append(residual_norm(At, xs[s].double().cpu().numpy(), b))
    check(max(res_sw) <= KLU_RES_MAX,
          f"circuit_{n} sweep residuals {max(res_sw):.3e} > {KLU_RES_MAX}")
    del fs, Rss, xs, vals

    # a zero pivot: every entry of the first pivot column set to zero
    zero = A.data.copy()
    j = int(sym.q[0])
    zero[A.indptr[j]:A.indptr[j + 1]] = 0.0
    _, _, ok0 = refactor(torch.as_tensor(zero, dtype=torch.float32,
                                         device="cuda"))
    check(not bool(ok0), f"circuit_{n}: a zero pivot left ok True")
    return dict(matrix=f"circuit_{n}", n=n, nnz=int(A.nnz),
                blocks=host["blocks"], largest_block=host["largest_block"],
                host_native=host["native"],
                host_analyze_s=host["klu_analyze_s"],
                host_factor_s=host["klu_factor_s"],
                host_refactor_s=host["klu_refactor_s"],
                host_solve_s=host["klu_solve_s"],
                host_residual=host["residual"], device_plan_s=t_plan,
                device_refactor_ms=t_med * 1e3,
                device_refactor_ms_all=[t * 1e3 for t in t_ref],
                device_busy_ms=prof["device_busy_ms"],
                idle_share=prof["idle_share"],
                device_solve_ms=float(np.median(ms_solve)),
                device_residual=res_d, device_vs_host_rel=rel_h,
                bit_identical_refactor=True, sweep=KLU_SWEEP,
                sweep_refactor_ms=t_sw * 1e3, sweep_solve_ms=t_sws * 1e3,
                sweep_residual_max=max(res_sw), zero_pivot_ok=bool(ok0))


def run_lu() -> list:
    """The [lu] phase: the multifrontal LU on each of lu_matrices(), the
    singular case and KLU; one ``[lu] {json}`` line per matrix."""
    rows = []
    for name, A in lu_matrices():
        rows.append(run_lu_matrix(name, A))
        del A
    rows.append(run_lu_singular())
    rows.append(run_klu())
    for row in rows:
        log(f"[lu] {json.dumps(row)}")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "suitesparse_tpu_torch")):
        print("chip_smoke: the suitesparse_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[setup] card: {smi}")

    phase_setup()
    phase_kernel_vs_plain()
    phase_small_parity()
    os.makedirs(PROFILE_DIR, exist_ok=True)

    from suitesparse_tpu_torch.cholesky.kernels import block_chol
    block_chol.launches = 0            # the main path's count starts here
    rows = {}
    shapes = None
    for name in MATRICES:
        rows[name], sh = run_matrix(name, REFACTOR_REPS)
        shapes = shapes or sh
    launches = block_chol.launches
    check(launches > 0, "main path never launched block_chol")
    log(f"[main] block_chol launches on the main path: {launches}")
    kline = kernel_line(shapes, launches, kind)
    log(f"[time] cholesky phases done at {time.perf_counter() - t_start:.1f} s")

    # the sparse-product slice
    from suitesparse_tpu_torch.ops.spmv import bcsr_spmm
    phase_bcsr_vs_plain()
    A, S = ops_matrix()
    bcsr_spmm.launches = 0             # the slice's count starts here
    block_chol.launches = 0
    ops_row, bc, Xs = run_ops(A, S)
    graph_row = run_graph()
    slice_launches = bcsr_spmm.launches
    check(slice_launches > 0, "the slice's path never launched bcsr_spmm")
    log(f"[main] bcsr_spmm launches on the slice's path: {slice_launches} "
        f"(block_chol {block_chol.launches})")
    log(f"[ops] {json.dumps(ops_row)}")
    log(f"[graph] {json.dumps(graph_row)}")
    bline = bcsr_kernel_line(bc, Xs, S, slice_launches, kind)
    del A, S, bc, Xs
    log(f"[time] sparse-product phases done at "
        f"{time.perf_counter() - t_start:.1f} s")

    # the dispatch-floor probes: their path is the probe tool's main()
    from suitesparse_tpu_torch.tools import microbench_dispatch as probe
    worst = phase_dispatch_vs_plain()
    probe.scale_blocks.launches = 0    # the probe path's count starts here
    probe.scale_gather.launches = 0
    res = probe.main(grids=DISPATCH_G)
    plaunch = dict(scale_blocks=probe.scale_blocks.launches,
                   scale_gather=probe.scale_gather.launches)
    check(all(plaunch.values()), f"the probe path skipped a kernel: {plaunch}")
    log(f"[main] probe launches on the probe path: {plaunch}")
    log(f"[dispatch] launch floors (s): {json.dumps(res['floor'])}; eager "
        f"op (chain) {json.dumps(res['chain'])}")
    log(f"[dispatch] launch route (s a call): {json.dumps(res['route'])}")
    dlines = dispatch_kernel_lines(res, plaunch, worst, kind)

    # the Cholesky front end
    block_chol.launches = 0            # the front end's count starts here
    front = run_front()
    check(block_chol.launches > 0, "the front end never launched block_chol")
    log(f"[main] block_chol launches on the front-end path: "
        f"{block_chol.launches}")
    log(f"[front] {json.dumps(front)}")

    # the LU family: no kernel of the port lies on its path
    probes = (block_chol, bcsr_spmm, probe.scale_blocks, probe.scale_gather)
    for k in probes:
        k.launches = 0                 # the LU path's count starts here
    run_lu()
    lu_launches = {k.__name__: k.launches for k in probes}
    log(f"[main] kernel launches on the LU path: {json.dumps(lu_launches)}")
    check(not any(lu_launches.values()),
          f"a kernel of the port ran on the LU path: {lu_launches}")
    log(f"[time] lu phase done at {time.perf_counter() - t_start:.1f} s")

    log(f"[done] {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": [kline, bline] + dlines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
