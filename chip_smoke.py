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
Then the LU family (``[lu]``, no kernel of the port on its path): the
multifrontal LU (umf_symbolic, umf_numeric refactorizations, umf_solve
with float64 refinement) on cd3d_44, a convection-diffusion operator
built here, and on randunsym_5000; a singular case; and KLU on
circuit_4000, on the host and through its device twin with a sweep of
value sets.  Then the QR family (``[qr]``, no kernel of the port on its
path either): the multifrontal QR (qr_symbolic, qr_factorize
refactorizations, the least-squares solve through Q'b and the host R
solve) on grad3d_32_tik, a Tikhonov-damped 3-D gradient built here, and
on randunsym_5000, each against a float64 oracle; the keep_q paths
(spqr_null, spqr_pinv, qr_min2norm, qr_qmult, qr_q) on grad3d_16; and the
Factorize/backslash front door on an SPD, an unsymmetric, a rectangular
and a symmetric indefinite matrix, block_chol counted for each.  Last
the distributed layer (``[dist]``, no kernel of the port on its path):
rank processes of ``suitesparse_tpu_torch/tools/multihost_dryrun.py``
that share this card, over gloo through a ``file://`` store under
``build/dist``: lap3d_44 at 4 ranks (the plan digest agreed by every rank,
5 bit-identical refactorizations, the gathered factor against the
single-process wave program, the distributed solve refined in float64,
the collectives of a factor and of a solve counted against the plan's,
bytes and per-phase times per rank, peak memory) and a block-cyclic
Cholesky of a dense 4096^2 SPD matrix; lap3d_28 at 2 ranks, lap3d_10 - 3I
(NOT_POSDEF with the single-process minor) and one lap3d_16 bucket
through the legacy level step; lap3d_16 at one rank over NCCL.  The P
ranks take turns on one card, so their times measure correctness, memory
and the cost of each phase, not scaling.  Any failed check raises and the script exits nonzero;
nothing is caught and carried on.  Without a CUDA device, or without the package beside
it, it exits nonzero and prints no result.

It also profiles one refactorization of each matrix with torch.profiler,
by default and with ``Common.cholesky.trsm_inv = False``: the Chrome
traces go to ``build/profiles/profile_<matrix>[_trsm_inv_false].json``
(~30 MB each, gitignored), and a ``[profile]`` line for each gives
the device busy time (union of the kernel intervals), the idle share
against the median of the unprofiled refactorizations, and the device
time per kernel group and for the top kernels.

It attributes one eager run of lap3d_44's pf body by the reference's
phase scopes (``[attrib]``, ``suitesparse_tpu_torch/tools/
profile_attrib.py``: coarse phases, phase x kernel group, every block_chol
launch under ``Fpotrf``, eager against replay busy time), times the pf
program with pieces removed on lap3d_28 in pairs with the full program
(``[ablate]``, ``tools/ablate_pf.py``), and runs the primitive and
precision probes (``[probes]``: ``tools/microbench.py``,
``microbench_dense.py``, ``probe_precision.py``, ``probe_prec_e2e.py``,
``diag_residual.py``), each reading under 105% of the H100 peak it names.

``block_chol`` is timed at each (W, Np) of one lap3d_44 factor with 50
launches queued behind a spin kernel, so that the host's enqueue rate does
not set the time of a kernel shorter than its launch; it and its yardstick
``torch.linalg.cholesky_ex``, which waits on the host and cannot be
queued, are also timed by their device busy time under torch.profiler.

Every refactorization and solve of the Cholesky, LU and KLU paths runs
as a device program (``suitesparse_tpu_torch/utils/programs.py``): captured
once per plan into a CUDA graph, then replayed.  Each program's replay is
timed in pairs against its eager body in this run (alternating which goes
first), checked bit for bit against it, and reported with its warm-up and
capture seconds, graph node count and graph pool; the refactor profiles
are taken of both.  The solve programs are per pattern: 5 refactor ->
solve rounds on lap3d_44 and cd3d_44 time them (a factor copied in, then
replays) against the per-factor form (a capture for each factor).  Each
distributed rank times its programs between the collectives against
their eager bodies; PageRank and BFS run as loop programs of 1, 4, 8 and
16 steps against the one-sync loops (host syncs counted); single spmv and
spgemm applies are timed eager against replay.

After the Cholesky phases, ``[bench]`` runs the port's benchmark entry
point, ``python -m suitesparse_tpu_torch.bench``, on the reference's
headline matrix lap3d_64 (n = 262,144) without the splu baseline, in its
own processes: the reference's row (refactor, 1- and 32-RHS solve rates,
residual after 3 float64 steps, the bfloat16 SYRK A/B), the pf program's
capture, graph nodes and pool, and peak memory; its block_chol launches
count on the main path.  Then ``python -m
suitesparse_tpu_torch.bench_extra`` gives the KLU, UMFPACK, SPQR and
GraphBLAS rows at circuit_4000, randunsym_5000 and lap3d_40.  Its files
go to ``build/bench/smoke``.

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
TIMED_MATRIX = MATRICES[0]         # block_chol is timed at its shapes
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
# stream while the host enqueues them (~25 ms at the H100's ~2 GHz; a slow
# host has taken 11.2 ms to enqueue the 50 launches)
QUEUED_REPS = 50
HOLD_CYCLES = 50_000_000
BUSY_TRACE_S = 0.05            # least host time a busy-time trace spans
FRONT_MATRIX = "lap3d_44"
REFINE_STEPS = 3
REFACTOR_REPS = 5
SOLVE_ROUNDS = 5               # refactor -> solve rounds of the two forms
APPLY_REPS = 20                # pairs of a single spmv / spgemm apply
LOOP_STEPS_TRIED = (1, 4, 8, 16)   # pagerank/bfs steps a program run
DIST_PAIRS = 3                 # pairs of each rank program
DIST_TOP_MIN = 512             # a top-front threshold that leaves runs of
#                                replicated top waves (lap3d_28, P = 2)
OPS_MATRIX = "lap3d_44"
SOLVE_FORMS_MATRIX = "lap3d_44"
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
LU_FORMS_MATRIX = "cd3d_44"
KLU_N = 4000
KLU_SWEEP = 8
KLU_SWEEP_REPS = 2             # pairs of the sweep (about 2 s a run)
KLU_RES_MAX = 1e-4             # float32 device solves
# the [qr] phase: grad3d_QR_TIK_K_tik = [G; QR_TIK_MU I] and randunsym_5000
# through qr_symbolic/qr_factorize/qr_rsolve, the keep_q paths on
# grad3d_QR_Q_K (qr_q at grad3d_QR_QQ_K), and Factorize/backslash
QR_TIK_K = 32
QR_RU_N = 5000                 # bench_extra.py:122-127's fallback size
QR_TIK_MU = 2.0
QR_TIK_MAX = 1e-5              # cond 2: the float32 solution vs float64
QR_RANDUNSYM_MAX = 1e-4        # kappa_1 4.39 (host estimate), PERF.md
QR_KEEPQ_MAX = 1e-4            # grad3d_16 in float32 vs float64 (kappa 18)
QR_Q_K = 16
QR_QQ_K = 6
QR_REPS = 5
QR_SEED = 8
FD_SPD_K = 32                  # 33 buckets: the pf program, block_chol
FD_LU_K = 20
FD_QR_K = 12
FD_INDEF_K = 10
FD_RES_MAX = 1e-5              # float32 factors, no refinement
# the [dist] phase: ranks of suitesparse_tpu_torch/tools/multihost_dryrun.py
# sharing cuda:0 over gloo (a file:// store under build/dist), one over
# NCCL: lap3d_DIST_K at DIST_P ranks, lap3d_DIST_P2_K at 2, lap3d_DIST_NCCL_K
# at 1, lap3d_DIST_INDEF_K - 3I, one lap3d_DIST_LEVEL_K bucket, and a dense
# DIST_BC_N^2 SPD matrix block-cyclic at DIST_P ranks
DIST_K = 44
DIST_P = 4
DIST_P2_K = 28
DIST_NCCL_K = 16
DIST_INDEF_K = 10
DIST_LEVEL_K = 16
DIST_BC_N = 4096
DIST_BC_NB = 128
DIST_GATHER_MAX = 1e-5         # float32 gather() vs the single-process wave
DIST_BC_MAX = 1e-5             # float32 block-cyclic vs float64 host
DIST_TIMEOUT = 600
DIST_SEED = 11
# the [attrib] phase: one eager pf body of ATTRIB_MATRIX attributed by
# phase scope (tools/profile_attrib.py), beside a replay's busy time
ATTRIB_MATRIX = "lap3d_44"
ATTRIB_SHARE_MIN = 0.95        # eager device time under named scopes
ATTRIB_BUSY_GAP = 0.05         # |eager - replay| / replay device busy
# [ablate]: tools/ablate_pf.py's variants, each replay in pairs with full
ABLATE_MATRIX = "lap3d_28"
# [probes]: the primitive and precision probes at their smallest settings
PREC_E2E_MATRIX = "lap3d_20"
DIAG_MATRIX = "lap3d_20"
DIAG_STEPS = 3
# [bench]: the port's bench entry point (suitesparse_tpu_torch/bench.py) on
# the reference's headline matrix with 3 timed refactors where the
# reference times 5 (each ~0.41 s, twice: float32 and bf16); then
# bench_extra's four rows at the sizes the [lu], [qr] and [ops] phases run
BENCH_MATRIX = "lap3d_64"
BENCH_REPEATS = 3
BENCH_TIMEOUT = 900
BENCH_OUT = os.path.join(ROOT, "build", "bench", "smoke")
BENCH_EXTRA_ARGS = ("--klu", "circuit_4000", "--umfpack", "randunsym_5000",
                    "--spqr", "randunsym_5000", "--graphblas", "lap3d_40")
BENCH_REF_KEYS = ("name", "n", "fl", "lnz", "t_analyze", "t_factor",
                  "gflops", "t_solve", "solve_gflops", "solve32_gflops",
                  "residual", "t_base", "bf16_gflops", "bf16_residual",
                  "t_first", "pct_gemm_peak")
# kernel-name fragments of each device-time group of a QR refactor
# (cuSOLVER/MAGMA geqrf and its helpers); the Cholesky and LU groups are
# profile_attrib.KERNEL_GROUPS
QR_GROUPS = (("geqrf", ("geqr", "larfg", "larft", "larfb", "geqrf")),
             ("orgqr/householder", ("orgqr", "ungqr", "orgtr", "larf")),
             ("gemm", ("gemm", "gemv", "cutlass", "xmma", "cublas")),
             ("index/scatter", ("index", "scatter", "gather", "put")),
             ("cat/copy", ("cat", "copy", "memcpy", "memset", "fill")),
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
    from suitesparse_tpu_torch.tools.profile_attrib import busy_us
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
            return busy_us(spans) / 1e3 / calls
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


def profile_refactor(name, run, refactor_ms: float, outdir: str,
                     groups=None) -> dict:
    """Profile one refactorization ``run()`` with torch.profiler and break
    its device time down by kernel group.  The profiler slows the host, so
    the idle share is taken against ``refactor_ms``, the median of the
    unprofiled refactorizations; the profiled run's own share is given
    beside it."""
    import torch
    from torch.profiler import ProfilerActivity
    from suitesparse_tpu_torch.tools.profile_attrib import (KERNEL_GROUPS,
                                                            busy_us,
                                                            kernel_group)
    groups = groups or KERNEL_GROUPS
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
        g = kernel_group(e["name"], groups)
        by_group[g] = by_group.get(g, 0.0) + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy_ms = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kern]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    calls = {}
    for e in kern:
        calls[e["name"]] = calls.get(e["name"], 0) + 1
    return dict(matrix=name, refactor_median_ms=refactor_ms,
                refactor_profiled_ms=wall * 1e3, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / refactor_ms,
                idle_share_profiled=1.0 - busy_ms / (wall * 1e3),
                kernels=len(kern), trace=path,
                group_ms={g: v / 1e3 for g, v in sorted(
                    by_group.items(), key=lambda kv: -kv[1])},
                top_ms=[(n[:90], v / 1e3) for n, v in top],
                top_calls=[(n[:90], c) for n, c in sorted(
                    calls.items(), key=lambda kv: -kv[1])[:8]])


def free_device_memory():
    """Collect the last phase's plans (their programs hold graph pools)
    and return the cached blocks to the device."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def tree_equal(a, b) -> bool:
    """Bit-identical tensors, or tuples/lists of them."""
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(tree_equal(x, y) for x, y in zip(a, b))


def graph_pool_bytes(prog) -> int:
    """Bytes of the device memory the allocator holds in a program's
    private graph pool."""
    import torch
    pool = tuple(prog.graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def program_stats(prog) -> dict:
    """A captured program's warm-up and capture seconds, node count and
    graph pool."""
    return dict(warmup_s=prog.warmup_s, capture_s=prog.capture_s,
                graph_nodes=prog.nodes,
                graph_pool_gib=graph_pool_bytes(prog) / 2**30)


def peak_gib(fn) -> float:
    """Peak device memory above what was allocated before, over one call
    of ``fn`` (its result freed before the next reading)."""
    import torch
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    sync()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def sync_free(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): a body that
    waits on the host raises."""
    import torch

    def run(*a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return run


def pairs(name, prog, inputs, reps, want=None, no_sync=False) -> dict:
    """One untimed round, then ``reps`` rounds of the program's eager
    body and its replay on the same inputs, alternating which runs first,
    each timed on the host clock ended by a sync; every result must equal
    ``want`` (default: the first result) bit for bit.  ``no_sync``: the
    eager body runs under ``sync_free``."""
    eager, replay = [], []
    body = sync_free(prog.eager) if no_sync else prog.eager
    for r in range(reps + 1):
        order = ((eager, body), (replay, prog))
        for times, fn in (order if r % 2 == 0 else order[::-1]):
            t, out = host_time(lambda: fn(*inputs))
            if r:
                times.append(t * 1e3)
            if want is None:
                want = out
            check(tree_equal(out, want), f"{name}: replay and eager body "
                  f"differ")
            del out
    return dict(eager_ms=float(np.median(eager)), eager_ms_all=eager,
                replay_ms=float(np.median(replay)), replay_ms_all=replay,
                bit_identical=True)


def chain(progs, x):
    """x through the programs (or functions) ``progs`` in turn."""
    for p in progs:
        x = p(x)
    return x


def solve_forms(name, rounds, refactor, bind, other, per_pattern, bodies_of,
                rhs):
    """``rounds`` refactorizations (``refactor(r)`` -> a factor), each
    followed by its solves in two forms, in turns which goes first: per
    pattern (``bind(factor)``, the copy in, timed alone, then the replays
    of the programs ``per_pattern[k]``, chained, for each width k) and per
    factor (new programs over the factor's own buffers, the bodies
    ``bodies_of(factor, k)``: warm-up, capture and replay).  Each solution
    of one form equals the other's and the per-pattern programs' eager
    bodies (sync-free) bit for bit.  ``rhs`` {k: input}; the factor
    ``other`` is bound before each round, so that every timed copy is a
    real one."""
    import torch
    from suitesparse_tpu_torch.utils.programs import DeviceProgram
    bind(other)
    for k, ps in per_pattern.items():
        chain(ps, rhs[k])              # every per-pattern program captured
    rows = []
    for r in range(rounds):
        f = refactor(r)
        bind(f)            # what a new factor pays once either way (Dinv)
        bind(other)

        def pattern():
            t_copy, _ = host_time(lambda: bind(f))
            t, xs = host_time(lambda: {k: chain(ps, rhs[k])
                                       for k, ps in per_pattern.items()})
            return dict(copy_ms=t_copy * 1e3, solve_ms=t * 1e3,
                        total_ms=(t_copy + t) * 1e3), xs

        def factor():
            made = [DeviceProgram(f"{name}_per_factor", (name, k, i), body,
                                  "cuda", library=ps[i].library)
                    for k, ps in per_pattern.items()
                    for i, body in enumerate(bodies_of(f, k))]
            by_k = {}
            for p in made:
                by_k.setdefault(p.key[1], []).append(p)
            t, xs = host_time(lambda: {k: chain(ps, rhs[k])
                                       for k, ps in by_k.items()})
            return dict(
                total_ms=t * 1e3,
                warmup_s=sum(p.warmup_s for p in made),
                capture_s=sum(p.capture_s for p in made),
                graph_nodes=sum(p.nodes for p in made),
                graph_pool_gib=sum(graph_pool_bytes(p)
                                   for p in made) / 2**30), xs

        order = [("per_pattern", pattern), ("per_factor", factor)]
        got = {nm: fn() for nm, fn in (order if r % 2 == 0
                                       else order[::-1])}
        for k, ps in per_pattern.items():
            want = chain([sync_free(p.eager) for p in ps], rhs[k])
            check(torch.equal(got["per_pattern"][1][k], want)
                  and torch.equal(got["per_factor"][1][k], want),
                  f"{name} round {r} k={k}: the two forms or the eager "
                  f"body differ")
        rows.append({nm: v[0] for nm, v in got.items()})
        del got, f
    med = {nm: {key: float(np.median([row[nm][key] for row in rows]))
                for key in rows[0][nm]} for nm in rows[0]}
    return dict(rounds=rows, median=med,
                speedup=med["per_factor"]["total_ms"]
                / med["per_pattern"]["total_ms"])


def run_matrix(name: str, reps: int):
    """One full-size matrix through the main path: the first factor (the
    pf program's warm-up and capture), the refactor in pairs (eager body
    against replay, default, trsm_inv=False and syrk_bf16), a profile of
    each route, the inverted diagonal blocks, the 1- and 32-RHS solves in
    pairs, and float64 refinement."""
    import torch
    from suitesparse_tpu_torch.cholesky.pf import block_chol_shapes
    from suitesparse_tpu_torch.cholesky import (analyze, factorize_super,
                                                residual_norm, solve_super,
                                                super_symbolic)
    from suitesparse_tpu_torch.cholesky.kernels import block_chol
    from suitesparse_tpu_torch.cholesky.pf import pf_program
    from suitesparse_tpu_torch.cholesky.super_numeric import (
        SuperFactor, _solve_body, bind_solve_factor, build_plan,
        solve_program)
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
    t_an = time.perf_counter() - t0
    log(f"[{name}] n={n} nnz(A)={A.nnz} lnz={sym.lnz} fl={sym.flops:.4g} "
        f"nsuper={ss.nsuper} buckets={plan.nbuckets} "
        f"instr={len(pfp.instr_cls)} buf={pfp.buf} analyze+plan={t_an:.2f}s")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    l0 = block_chol.launches
    t_first, f = host_time(lambda: factorize_super(
        A, sym, ss, plan=plan, common=cm, device="cuda"))
    per_factor = block_chol.launches - l0
    capture_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    prog = pf_program(pfp, np.float32, device="cuda")
    check(f.ok, f"{name}: factor not positive definite (minor {f.minor})")
    check(f.Lx.dtype == torch.float32, f"{name}: factor dtype {f.Lx.dtype}")
    check(prog.graph is not None, f"{name}: the pf program was not captured")
    check(per_factor > 0, f"{name}: block_chol not launched")
    check(per_factor == sum(block_chol_shapes(pfp).values())
          and prog.per_replay == (per_factor,),
          f"{name}: launches {per_factor} (per replay {prog.per_replay}) "
          f"differ from the plan's count")
    vd = prog.static[0].clone()
    cap = program_stats(prog)
    log(f"[{name}] pf program captured: {json.dumps(cap)}; first factor "
        f"{t_first:.2f} s")
    l0 = block_chol.launches
    pf_pairs = pairs(name, prog, (vd,), reps, want=f.Lx)
    check(block_chol.launches - l0 == (reps + 1) * 2 * per_factor,
          f"{name}: block_chol launches over the pairs")
    mem = dict(eager_peak_gib=peak_gib(lambda: prog.eager(vd)),
               replay_peak_gib=peak_gib(lambda: prog(vd)),
               capture_peak_gib=capture_peak,
               graph_pool_gib=cap["graph_pool_gib"])
    # a second factor leaves the first one's buffer as it was
    keep = f.Lx.clone()
    other = prog(2.0 * vd)
    check(torch.equal(f.Lx, keep) and not torch.equal(other, f.Lx),
          f"{name}: a second factor changed the first")
    del keep, other
    t_refactor = pf_pairs["replay_ms"] / 1e3
    prof = profile_refactor(name, lambda: prog(vd), t_refactor * 1e3,
                            PROFILE_DIR)
    log("[profile] " + json.dumps(prof))
    prof_eager = profile_refactor(f"{name}_eager", lambda: prog.eager(vd),
                                  pf_pairs["eager_ms"], PROFILE_DIR)
    log("[profile] " + json.dumps(prof_eager))
    if name == ATTRIB_MATRIX:
        run_attrib(name, prog, vd, per_factor)

    # the solves, in pairs: A with perm and invperm inside the program;
    # one program per pattern, reading the bound factor
    b1 = torch.ones((n, 1), dtype=torch.float32, device="cuda")
    b32 = torch.as_tensor(np.random.default_rng(1).standard_normal((n, 32)),
                          dtype=torch.float32, device="cuda")
    t_dinv, _ = host_time(lambda: solve_super(f, np.ones(n), "A", cm))
    R = bind_solve_factor(f, cm)
    dinv = dict(pairs(f"{name} dinv", R.dinv, (), 1, want=f._dinv,
                      no_sync=True), **program_stats(R.dinv))
    solves = {}
    for k, bk in ((1, b1), (32, b32)):
        sp = solve_program(plan, "A", k, torch.float32, "cuda", cm)
        sp.prepare(bk)
        check(sp.graph is not None, f"{name}: solve k={k} not captured")
        solves[k] = dict(pairs(f"{name} solve k={k}", sp, (bk,), reps,
                               no_sync=True), **program_stats(sp))
    ms1, ms32 = solves[1]["replay_ms"], solves[32]["replay_ms"]
    resident = (R.Lx.numel() + R.Dv.numel()) * 4 + 2 * n * 8
    forms = None
    if name == SOLVE_FORMS_MATRIX:
        perm = torch.as_tensor(f.perm, device="cuda")
        invperm = torch.argsort(perm)
        forms = solve_forms(
            f"{name} solve A", SOLVE_ROUNDS,
            lambda r: SuperFactor(plan=plan, Lx=prog(vd * (1.0 + 0.25 * r)),
                                  perm=f.perm, minor=n, dtype=np.float32),
            lambda g: bind_solve_factor(g, cm), f,
            {k: [solve_program(plan, "A", k, torch.float32, "cuda", cm)]
             for k in (1, 32)},
            lambda g, k: [_solve_body(plan, "A", True, cm, g.Lx, g._dinv,
                                      perm, invperm)],
            {1: b1, 32: b32})
        forms["resident_gib"] = resident / 2**30
        log(f"[{name}] solve forms: {json.dumps(forms)}")
        bind_solve_factor(f, cm)
    xdev = solve_program(plan, "A", 1, torch.float32, "cuda", cm)(b1)[:, 0]
    check(tuple(xdev.shape) == (n,) and bool(torch.isfinite(xdev).all()),
          f"{name}: device solve shape/finiteness")
    b = np.ones(n)
    res_dev = residual_norm(A, xdev.double().cpu().numpy(), b)
    check(res_dev < 1e-4, f"{name}: device solve residual {res_dev:.2e}")

    Sf = A.to_scipy().astype(np.float64)
    x = solve_super(f, b, "A", cm).astype(np.float64)
    res0 = residual_norm(A, x, b)
    for _ in range(REFINE_STEPS):
        x = x + solve_super(f, b - Sf @ x, "A", cm).astype(np.float64)
    res = residual_norm(A, x, b)
    check(res <= RESIDUAL_MAX, f"{name}: residual {res:.3e} > {RESIDUAL_MAX}")
    peak = torch.cuda.max_memory_allocated()   # one factor and its solves

    # syrk_bf16 (pf): its own program, bit-identical to its eager body
    bprog = pf_program(pfp, np.float32, syrk_bf16=True, device="cuda")
    bf16_pairs = dict(pairs(f"{name} syrk_bf16", bprog, (vd,), 1),
                      **program_stats(bprog))
    pfp._cache.pop(bprog.key)
    del bprog

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
    tprog = pf_program(pfp, np.float32, trsm_inv=False, device="cuda")
    check(tprog.graph is not None,
          f"{name}: the trsm_inv=False program was not captured")
    tri_pairs = dict(pairs(f"{name} trsm_inv=False", tprog, (vd,), reps,
                           want=ft.Lx), **program_stats(tprog))
    check(block_chol.launches == l0, f"{name}: trsm_inv=False launched "
          f"block_chol")
    t_tri_med = tri_pairs["replay_ms"] / 1e3
    prof_tri = profile_refactor(
        f"{name}_trsm_inv_false", lambda: tprog(vd), t_tri_med * 1e3,
        PROFILE_DIR)
    log("[profile] " + json.dumps(prof_tri))
    prof_tri_eager = profile_refactor(
        f"{name}_trsm_inv_false_eager", lambda: tprog.eager(vd),
        tri_pairs["eager_ms"], PROFILE_DIR)
    log("[profile] " + json.dumps(prof_tri_eager))
    tot = plan.total
    d_tri = rel_err(ft.Lx[:tot], f.Lx[:tot])
    # two float32 factors of one matrix by two TRSMs
    check(d_tri <= 1e-3, f"{name}: trsm_inv=False vs default {d_tri:.3e}")
    xt = solve_super(ft, b, "A", cmt).astype(np.float64)
    for _ in range(REFINE_STEPS):
        xt = xt + solve_super(ft, b - Sf @ xt, "A", cmt).astype(np.float64)
    res_tri = residual_norm(A, xt, b)
    check(res_tri <= RESIDUAL_MAX,
          f"{name}: trsm_inv=False residual {res_tri:.3e} > {RESIDUAL_MAX}")
    del ft, tprog
    row = dict(matrix=name, n=n, lnz=int(sym.lnz), flops=float(sym.flops),
               instr=int(len(pfp.instr_cls)), analyze_s=t_an,
               first_factor_s=t_first, capture=cap, memory=mem,
               refactor_ms=t_refactor * 1e3,
               refactor_ms_all=pf_pairs["replay_ms_all"],
               eager_refactor_ms=pf_pairs["eager_ms"],
               eager_refactor_ms_all=pf_pairs["eager_ms_all"],
               device_busy_ms=prof["device_busy_ms"],
               idle_share=prof["idle_share"],
               eager_device_busy_ms=prof_eager["device_busy_ms"],
               eager_idle_share=prof_eager["idle_share"],
               factor_gflops=sym.flops / t_refactor / 1e9,
               dinv_and_first_solve_ms=t_dinv * 1e3, dinv=dinv,
               solve_resident_gib=resident / 2**30, solve_forms=forms,
               solve1_ms=ms1,
               solve32_ms=ms32, solves=solves,
               solve1_gflops=4 * sym.lnz / (ms1 * 1e-3) / 1e9,
               solve32_gflops=32 * 4 * sym.lnz / (ms32 * 1e-3) / 1e9,
               residual_f32=res0, residual_refined=res,
               bit_identical_refactor=True, syrk_bf16=bf16_pairs,
               trsm_inv_false=tri_pairs,
               trsm_inv_false_device_busy_ms=prof_tri["device_busy_ms"],
               trsm_inv_false_idle_share=prof_tri["idle_share"],
               trsm_inv_false_eager_device_busy_ms=prof_tri_eager[
                   "device_busy_ms"],
               trsm_inv_false_eager_idle_share=prof_tri_eager["idle_share"],
               trsm_inv_false_rel_diff=d_tri,
               trsm_inv_false_residual_refined=res_tri,
               peak_mem_gib=peak / 2**30,
               block_chol_launches_per_factor=per_factor)
    log(f"[{name}] " + json.dumps(row))
    return row, block_chol_shapes(pfp)


def run_attrib(name, prog, vd, per_factor) -> dict:
    """[attrib]: one eager run of the pf program's body attributed to the
    reference's phase scopes by tools/profile_attrib.py (coarse phases,
    the phase x kernel group table, the top scopes and what is left),
    beside one replay's device busy time and kernel count.  Checks: at
    least ATTRIB_SHARE_MIN of the eager device time under named scopes,
    every block_chol launch of the body under an Fpotrf scope (a factor's
    count), and the eager and replay busy times within ATTRIB_BUSY_GAP."""
    from suitesparse_tpu_torch.tools import profile_attrib
    t0 = time.perf_counter()
    res = profile_attrib.attribute_pf(prog, vd, PROFILE_DIR, name)
    profile_attrib.print_attribution(res, detail=True)
    e, r = res["eager"], res["replay"]
    cc = e["cross_count"]
    in_potrf = cc.get("Fpotrf", {}).get("block_chol", 0)
    every = sum(c.get("block_chol", 0) for c in cc.values())
    gap = abs(e["busy_ms"] - r["busy_ms"]) / r["busy_ms"]
    out = dict(matrix=name, scope_ranges=sum(res["scope_ranges"].values()),
               scope_labels=len(res["scope_ranges"]),
               attributed_share=e["attributed_share"],
               block_chol_in_fpotrf=in_potrf, block_chol_eager=every,
               block_chol_per_factor=per_factor,
               eager_busy_ms=e["busy_ms"], eager_kernels=e["ops"],
               replay_busy_ms=r["busy_ms"], replay_kernels=r["ops"],
               busy_gap=gap, no_launch_record=e["no_launch_record"],
               phase_ms=e["phase_ms"], cross_ms=e["cross_ms"],
               unattributed_top=list(e["unattributed_ms"].items())[:8],
               seconds=time.perf_counter() - t0)
    log("[attrib] " + json.dumps(out))
    check(e["attributed_share"] >= ATTRIB_SHARE_MIN,
          f"{name}: {e['attributed_share']:.3f} of the eager device time "
          f"under named scopes")
    check(in_potrf == every == per_factor,
          f"{name}: block_chol in Fpotrf {in_potrf}, in the body {every}, "
          f"a factor {per_factor}")
    check(gap <= ATTRIB_BUSY_GAP, f"{name}: eager busy {e['busy_ms']:.2f} "
          f"against replay {r['busy_ms']:.2f} ms")
    return out


def run_ablate() -> dict:
    """[ablate]: tools/ablate_pf.py on ABLATE_MATRIX: full (checked bit
    for bit and node for node against pf_program) and each variant,
    replays in pairs."""
    from suitesparse_tpu_torch.tools import ablate_pf, profile_attrib
    t0 = time.perf_counter()
    A, sym, pfp, vals = profile_attrib.pf_setup(ABLATE_MATRIX, "cuda")
    res = ablate_pf.ablate(pfp, vals)
    check(set(res) == set(ablate_pf.VARIANTS) - {"full"}
          and all(r["ms"] > 0 and r["nodes"] > 0 for r in res.values()),
          f"ablate: {res}")
    out = dict(matrix=ABLATE_MATRIX, instr=int(len(pfp.instr_cls)),
               variants=res, seconds=time.perf_counter() - t0)
    log("[ablate] " + json.dumps(out))
    return out


def run_probes() -> dict:
    """[probes]: the primitive and precision probes of the port's tools,
    each at its smallest setting; every reading under 105% of the H100
    peak it names (the tools raise otherwise), the matmul settings back
    to full float32 after the precision probe, and the refined residuals
    of the end-to-end probe (full float32) and of diag_residual within
    RESIDUAL_MAX."""
    import torch
    from suitesparse_tpu_torch.tools import (diag_residual, microbench,
                                             microbench_dense,
                                             probe_prec_e2e,
                                             probe_precision)
    t0 = time.perf_counter()
    out = dict(microbench=microbench.main(),
               microbench_dense={"x".join(map(str, k)): v for k, v in
                                 microbench_dense.main().items()},
               precision=probe_precision.main())
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "probe_precision left TF32 on")
    out["prec_e2e"] = probe_prec_e2e.main(PREC_E2E_MATRIX)
    check(all(r["finite"] for r in out["prec_e2e"].values())
          and out["prec_e2e"]["highest"]["residuals"][-1] <= RESIDUAL_MAX,
          f"prec_e2e: {out['prec_e2e']}")
    diag = diag_residual.main(DIAG_MATRIX, DIAG_STEPS)
    out["diag_residual"] = {f"trsm_inv={t} {p}": [h[0] for h in hist]
                            for (t, p), hist in diag.items()}
    check(all(hist[-1][0] <= RESIDUAL_MAX for hist in diag.values()),
          f"diag_residual: {out['diag_residual']}")
    out["seconds"] = time.perf_counter() - t0
    log("[probes] " + json.dumps(out))
    return out


def bench_module(module, args) -> str:
    """stdout of ``python -m module args`` from the checkout's root (its
    log goes to this script's stderr); a nonzero exit fails the check."""
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          stdout=subprocess.PIPE, text=True,
                          timeout=BENCH_TIMEOUT)
    check(proc.returncode == 0, f"{module} exited {proc.returncode}")
    return proc.stdout


def run_bench() -> dict:
    """[bench]: ``python -m suitesparse_tpu_torch.bench`` on BENCH_MATRIX
    with --no-baseline (its matrix in a process of its own), then
    ``bench_extra``'s four rows.  Checks: the last line's shape; every key
    of the reference's row non-null but t_base; the device-resident
    solve's residual and the one after 3 float64 steps; two refactors bit
    for bit; every rate (GEMM roofline, factor, solves, bf16 factor) under
    105% of the H100 peak of its type; block_chol launched per factor as
    often as the plan says; four extra rows with finite values."""
    from suitesparse_tpu_torch.tools.microbench import PEAK_MARGIN, PEAKS
    t0 = time.perf_counter()
    out = bench_module("suitesparse_tpu_torch.bench", (
        "--matrix", BENCH_MATRIX, "--no-baseline", "--repeats",
        str(BENCH_REPEATS), "--out", BENCH_OUT))
    last = json.loads(out.strip().splitlines()[-1])
    check(set(last) == {"metric", "value", "unit", "vs_baseline"}
          and last["metric"] == f"supernodal_cholesky_factor_gflops"
                                f"[{BENCH_MATRIX}]"
          and last["vs_baseline"] is None, f"bench last line {last}")
    with open(os.path.join(BENCH_OUT, "detail.json")) as fh:
        detail = json.load(fh)
    (row,) = detail["cholesky"]
    roof = detail["gemm_roofline_gflops"]
    missing = [k for k in BENCH_REF_KEYS if k != "t_base" and row[k] is None]
    check(not missing and row["t_base"] is None,
          f"bench: null keys {missing}")
    check(row["residual_device"] < 1e-4,
          f"bench: device solve residual {row['residual_device']:.2e}")
    check(row["residual"] <= RESIDUAL_MAX,
          f"bench: residual {row['residual']:.3e} > {RESIDUAL_MAX}")
    check(row["bit_identical"], "bench: two refactors differ")
    rates = dict(gemm_float32=(roof["float32"], "float32"),
                 gemm_bfloat16=(roof["bfloat16"], "bfloat16"),
                 factor=(row["gflops"], "float32"),
                 solve=(row["solve_gflops"], "float32"),
                 solve32=(row["solve32_gflops"], "float32"),
                 bf16_factor=(row["bf16_gflops"], "bfloat16"))
    for what, (gf, peak) in rates.items():
        check(0 < gf * 1e9 <= PEAK_MARGIN * PEAKS[peak],
              f"bench: {what} {gf:.1f} GFLOP/s against the {peak} peak")
    check(row["block_chol_timed_launches"]
          == row["block_chol_plan"] * row["block_chol_timed_calls"]
          and row["block_chol_plan"] > 0,
          f"bench: block_chol {row['block_chol_timed_launches']} launches in "
          f"{row['block_chol_timed_calls']} refactors, the plan's count "
          f"{row['block_chol_plan']} a factor")
    log(f"[bench] {json.dumps(row)}")
    log(f"[bench] {BENCH_MATRIX}: capture {row['capture_s']:.2f} s (warm-up "
        f"{row['warmup_s']:.2f} s), {row['graph_nodes']} graph nodes, pool "
        f"{row['graph_pool_gib']:.2f} GiB; peak memory "
        f"{row['peak_mem_gib']:.2f} GiB; GEMM roofline {json.dumps(roof)}")
    t_extra = time.perf_counter()
    out = bench_module("suitesparse_tpu_torch.bench_extra",
                       BENCH_EXTRA_ARGS + ("--out", BENCH_OUT))
    last = out.strip().splitlines()[-1]
    check(last.startswith("RESULT:"), f"bench_extra last line {last!r}")
    extra = json.loads(last[len("RESULT:"):])
    check(len(extra) == 4 and all(
        np.isfinite(r["value"]) and r["value"] > 0 for r in extra),
        f"bench_extra rows {extra}")
    for r in extra:
        log(f"[bench] extra {json.dumps(r)}")
    return dict(row=row, extra=extra,
                block_chol_launches=row["block_chol_launches"],
                block_chol_shapes={(W, Np): c for W, Np, c
                                   in row["block_chol_shapes"]},
                extra_s=time.perf_counter() - t_extra,
                seconds=time.perf_counter() - t0)


def run_unrolled() -> dict:
    """lap3d_10 (few buckets: the unrolled program) in float32: its
    replay against its eager body, bit for bit, and a solve."""
    import torch
    from suitesparse_tpu_torch.cholesky import (analyze, factorize_super,
                                                residual_norm, solve_super,
                                                super_symbolic)
    from suitesparse_tpu_torch.cholesky.super_numeric import (
        build_plan, factor_program)
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.io.generators import laplacian_3d
    A = laplacian_3d(10)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    plan = build_plan(ss)
    check(plan.resolve_program(cm) == "unrolled",
          "lap3d_10 does not take the unrolled program")
    f = factorize_super(A, sym, ss, plan=plan, common=cm)
    prog = factor_program(plan, cm, np.float32, "cuda")
    check(f.ok and prog.graph is not None, "unrolled program not captured")
    res = pairs("lap3d_10 unrolled", prog, (prog.static[0].clone(),),
                REFACTOR_REPS, want=f.Lx)
    b = np.ones(A.ncol)
    x = solve_super(f, b, "A", cm)
    r = residual_norm(A, x.astype(np.float64), b)
    check(r < 1e-4, f"lap3d_10 unrolled solve residual {r:.2e}")
    out = dict(matrix="lap3d_10", program="unrolled", residual_f32=r,
               **res, **program_stats(prog))
    log(f"[small] {json.dumps(out)}")
    return out


def kernel_line(shapes, launches, dev_kind):
    """Hold block_chol against its plain version (1e-5 relative, float32)
    and against ``torch.linalg.cholesky_ex`` at every (W, Np) shape of
    every main-path matrix (``shapes``: {matrix: {(W, Np): launches a
    factor}}, the bench's lap3d_64 included).  At the shapes of one
    lap3d_44 factor (TIMED_MATRIX) also time it on the device's clock,
    queued behind a spin (``kernel_ms``: the gaps between launches
    included), beside its plain version, its bound and the yardstick
    ``torch.linalg.cholesky_ex`` on the precomputed S + diag(pe).  The
    yardstick waits on the host at W >= 2, so it cannot be queued: it is
    timed by its device busy time (``busy_ms``, gaps left out) at every
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
    timed = shapes[TIMED_MATRIX]
    every = sorted(set().union(*shapes.values()))
    for W, Np in every:
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
        cnt = timed.get((W, Np))
        if cnt is None:
            continue
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
    log(f"[kernel] block_chol held against its plain version at "
        f"{len(every)} shapes of {', '.join(shapes)}: max abs err "
        f"{max_abs:.3e}")
    log(f"[kernel] block_chol per {TIMED_MATRIX} factor: {tot['ms']:.4f} ms "
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
                compared_at={m: len(sh) for m, sh in shapes.items()},
                timed_as=f"one {TIMED_MATRIX} factor's launches, shape by "
                         f"shape: "
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
    from suitesparse_tpu_torch.ops.spgemm import cached_plan
    applies = dict(spmv_k1=spmv_pairs(A, Xs[32][:, 0].contiguous()),
                   spmm_k32=spmv_pairs(A, Xs[32]),
                   spgemm_AA=spgemm_pairs(cached_plan(A, A), A.data, A.data,
                                          "times"))
    log(f"[ops] single applies on {OPS_MATRIX}'s pattern, eager against "
        f"replay: {json.dumps(applies)}")
    row["applies"] = applies
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


def host_syncs(fn):
    """(fn()'s result, the number of times it made the host wait for the
    card), counted by torch.cuda.set_sync_debug_mode("warn")."""
    import warnings
    import torch
    sync()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in got)


def one_sync_pagerank(rows, cols, w, n, tol, max_iter, damping=0.85):
    """PageRank's loop with one host read a step (the port's form before
    its loop programs): what every program of K steps must give bit for
    bit.  Returns (rank, iterations)."""
    import torch
    from suitesparse_tpu_torch.graphblas.algorithms import _pagerank_step
    lengths = torch.bincount(cols, minlength=n)
    r = torch.full((n,), 1.0 / n, dtype=w.dtype, device=w.device)
    it, above = 0, True
    while above and it < max_iter:
        rnew = _pagerank_step(rows, cols, w, lengths, n, damping, r)
        above = bool((rnew - r).abs().sum() > tol)
        r, it = rnew, it + 1
    return r, it


def one_sync_bfs(rows, cols, n, source):
    """BFS's pull loop with one host read a step; (levels, steps)."""
    import torch
    from suitesparse_tpu_torch.graphblas.core import segment_reduce
    dev = rows.device
    level = torch.full((n,), -1, dtype=torch.int32, device=dev)
    level[source] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[source] = True
    depth = 1
    while bool(frontier.any()) and depth <= n:
        hit = segment_reduce("max", frontier[rows].to(torch.int32), cols, n,
                             indices_are_sorted=True) > 0
        frontier = hit & (level < 0)
        level = torch.where(frontier, torch.tensor(
            depth, dtype=torch.int32, device=dev), level)
        depth += 1
    return level, depth - 1


def apply_pairs(name, body, inputs) -> dict:
    """A single apply (the reference jits _spmv_impl and _spgemm_device)
    as a device program made here: its eager body against its replay (the
    inputs copied in, the result cloned), APPLY_REPS pairs, bit for bit,
    the body sync-free."""
    from suitesparse_tpu_torch.utils.programs import DeviceProgram
    prog = DeviceProgram(name, (name,), body, "cuda")
    prog.prepare(*inputs)
    out = dict(pairs(name, prog, inputs, APPLY_REPS, no_sync=True),
               graph_nodes=prog.nodes)
    out["replay_wins"] = out["replay_ms"] < out["eager_ms"]
    del out["eager_ms_all"], out["replay_ms_all"]
    return out


def spmv_pairs(A, x) -> dict:
    """spmv_program's apply (plus_times) on A's pattern, x (n,) or (n, k):
    eager against replay (apply_pairs)."""
    import torch
    from suitesparse_tpu_torch.ops.spmv import _row_program, _spmv_impl
    rp = _row_program(A)
    arrays = tuple(torch.as_tensor(a, device="cuda")
                   for a in (rp.rows, rp.cols, rp.gat)) + (
        torch.as_tensor(np.bincount(rp.rows, minlength=rp.m),
                        device="cuda"),)
    vals = torch.as_tensor(A.data if A.data is not None else np.ones(A.nnz),
                           dtype=x.dtype, device="cuda")
    return apply_pairs(
        "spmv", lambda v, xx: _spmv_impl(v, xx, arrays, rp.m, "times",
                                         "plus"), (vals, x))


def spgemm_pairs(plan, av, bv, mult) -> dict:
    """spgemm_apply's product (plus_<mult>) on a cached plan: eager
    against replay (apply_pairs)."""
    import torch
    from suitesparse_tpu_torch.ops.spgemm import _spgemm_device
    dev = torch.device("cuda")
    maps = plan.device_maps(dev)
    a = torch.as_tensor(av, device=dev)
    b = torch.as_tensor(bv, device=dev)
    return apply_pairs(
        "spgemm", lambda x, y: _spgemm_device(x, y, maps, mult, "plus",
                                              plan.nnz), (a, b))


def loop_programs(G, tol, max_iter):
    """PageRank and BFS (from 0) on G through loop programs of each
    LOOP_STEPS_TRIED steps a run, against the one-sync loops: the same
    iteration, ranks and levels bit for bit, the host syncs a run (the
    program captured) at most ceil(iterations / K) + 1, each timed over
    REFACTOR_REPS runs; and the one-sync loops' own times."""
    import torch
    from suitesparse_tpu_torch.graphblas import algorithms as alg
    dev = torch.device("cuda")
    n = G.shape[0]
    alg._pagerank(G, 0.85, tol, max_iter, dev)
    rows, cols, w, _ = G._loop_programs[("pagerank_arrays", torch.float32,
                                         dev)]
    out = dict(tol=tol, max_iter=max_iter)
    for kind in ("pagerank", "bfs"):
        if kind == "pagerank":
            ref = lambda: one_sync_pagerank(rows, cols, w, n, tol, max_iter)
            run = lambda K: alg._pagerank(G, 0.85, tol, max_iter, dev, K)
        else:
            ref = lambda: one_sync_bfs(rows, cols, n, 0)
            run = lambda K: alg._bfs_loop(rows, cols, n, 0, K,
                                          G._loop_programs)
        ref()
        t_ref = [host_time(ref)[0] * 1e3 for _ in range(REFACTOR_REPS)]
        (want, iters), syncs_ref = host_syncs(ref)
        row = dict(iterations=iters, one_sync_ms=float(np.median(t_ref)),
                   one_sync_ms_all=t_ref, one_sync_host_syncs=syncs_ref)
        for K in LOOP_STEPS_TRIED:
            run(K)                                  # capture
            t = [host_time(lambda: run(K))[0] * 1e3
                 for _ in range(REFACTOR_REPS)]
            # a run as the entry point makes it: the result copied out
            (got, it), syncs = host_syncs(
                lambda: (lambda o: (o[0].cpu(), o[1]))(run(K)))
            check(it == iters and torch.equal(got, want.cpu()),
                  f"{kind} K={K}: iteration {it} (one-sync {iters}) or "
                  f"values differ")
            check(syncs <= -(-it // K) + 1,
                  f"{kind} K={K}: {syncs} host syncs for {it} iterations")
            row[f"K{K}"] = dict(ms=float(np.median(t)), ms_all=t,
                                host_syncs=syncs)
        row["fastest_K"] = min(LOOP_STEPS_TRIED,
                               key=lambda K: row[f"K{K}"]["ms"])
        out[kind] = row
    return out


def run_graph():
    """PageRank, BFS and triangle counting at n = GRAPH_N on the card;
    the loop programs against the one-sync loops; a single spmv and the
    triangle SpGEMM apply, eager against replay."""
    import scipy.sparse as sp
    import torch
    from suitesparse_tpu_torch.graphblas import (bfs_levels, pagerank,
                                                 triangle_count)
    from suitesparse_tpu_torch.graphblas import algorithms as alg
    n = GRAPH_N
    t_gen, G = host_time(lambda: ring_chords(n, 21))
    row = dict(n=n, ring_chords_nnz=G.nnz, gen_s=t_gen)
    t_pr, pr = host_time(lambda: pagerank(G, max_iter=30, device="cuda"))
    want, iters = pagerank_oracle(G)
    e = rel_err_np(pr.astype(np.float64), want)
    t_pr2, pr2 = host_time(lambda: pagerank(G, max_iter=30, device="cuda"))
    check(np.array_equal(pr2, pr), "a second pagerank is not bit-identical")
    # the iteration the port stopped at: the program's counter
    _, port_iters = alg._pagerank(G, 0.85, 1e-9, 30, torch.device("cuda"))
    check(pr.shape == (n,) and abs(float(pr.sum()) - 1.0) <= 1e-3,
          f"pagerank sum {pr.sum()}")
    check(e <= 1e-5, f"pagerank vs numpy power iteration: {e:.2e}")
    log(f"[graph] ring+chords n={n} nnz={G.nnz}: pagerank {t_pr:.3f} s "
        f"(arrays, capture), {t_pr2 * 1e3:.1f} ms again; {port_iters} "
        f"iterations by the program's counter (the float64 oracle "
        f"stopped at {iters}), sum {pr.sum():.6f}, {e:.3e} relative to "
        f"numpy float64; a second run bit-identical")
    loops = loop_programs(G, 1e-9, 30)
    check(loops["pagerank"]["iterations"] == port_iters,
          "pagerank iterations of the one-sync loop and the program differ")
    log(f"[graph] loop programs, steps a run {LOOP_STEPS_TRIED} (default "
        f"{alg.LOOP_STEPS}): {json.dumps(loops)}")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(n),
                        dtype=torch.float32, device="cuda")
    applies = dict(spmv_ring_chords=spmv_pairs(G, x))
    t_dev, lv = host_time(lambda: bfs_levels(G, 0, "device",
                                                   device="cuda"))
    t_push, lp = host_time(lambda: bfs_levels(G, 0, "push"))
    check(lv.dtype == np.int32 and np.array_equal(lv, lp),
          "bfs device differs from push")
    check(bool((lv >= 0).all()), "bfs: the ring graph is connected")
    log(f"[graph] bfs from 0: device {t_dev:.3f} s, push {t_push:.3f} s, "
        f"identical, depth {int(lv.max())} (one host sync per "
        f"{alg.LOOP_STEPS} levels)")
    H = symmetric_random(n, 23)
    t_tc, tc = host_time(lambda: triangle_count(H, device="cuda"))
    t_tc2, tc2 = host_time(lambda: triangle_count(H, device="cuda"))
    L = sp.tril(H.to_scipy(), -1).tocsc()
    want_tc = int((L @ L.T).multiply(L).sum())
    check(tc == tc2 == want_tc, f"triangle_count {tc} vs scipy {want_tc}")
    log(f"[graph] symmetric random n={n} nnz={H.nnz}: triangle_count "
        f"{tc} = scipy's; {t_tc:.2f} s with the host plan, {t_tc2:.2f} s "
        f"with the plan cached")
    from suitesparse_tpu_torch.graphblas.core import select
    from suitesparse_tpu_torch.ops.spgemm import cached_plan
    Lt = select(H, lambda r, c, v: r > c)
    applies["spgemm_triangles"] = spgemm_pairs(
        cached_plan(Lt, Lt.transpose(), mask=Lt), np.ones(Lt.nnz),
        np.ones(Lt.nnz), "pair")
    log(f"[graph] single applies, eager against replay: "
        f"{json.dumps(applies)}")
    row.update(pagerank_s=t_pr, pagerank_iters=port_iters,
               pagerank_oracle_iters=iters, pagerank_rel_err=e,
               bfs_device_s=t_dev, bfs_push_s=t_push, bfs_depth=int(lv.max()),
               symmetric_nnz=H.nnz, triangles=tc, triangle_s=t_tc,
               triangle_cached_s=t_tc2, pagerank_again_s=t_pr2,
               loop_programs=loops, applies=applies)
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
    from suitesparse_tpu_torch.cholesky.super_numeric import factor_program
    from suitesparse_tpu_torch.cholesky.wave import wave_program
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
    prog = factor_program(solver.plan, solver.common, np.float32, "cuda")
    graph = prog.graph
    t_r1, _ = host_time(lambda: solver.refactorize(A))
    L1 = solver.factor.Lx
    t_r2, _ = host_time(lambda: solver.refactorize(A))
    L2 = solver.factor.Lx
    check(torch.equal(f0.Lx, L1) and torch.equal(L1, L2),
          "CholeskySolver refactorizations are not bit-identical")
    # a refactorization with new values replays the same graph, and the
    # factor held before it does not change
    A2 = type(A)(A.indptr, A.indices, A.data * 2.0, A.shape, A.stype)
    keep = L2.clone()
    solver.refactorize(A2)
    check(not torch.equal(solver.factor.Lx, L2) and torch.equal(L2, keep),
          "a refactorization with new values changed the earlier factor")
    solver.refactorize(A)
    check(graph is not None and prog.graph is graph
          and factor_program(solver.plan, solver.common, np.float32,
                             "cuda") is prog,
          "CholeskySolver refactorizations captured again")
    del keep
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
    wprog = wave_program(wp, np.float32, device="cuda")
    check(wprog.graph is not None, "the wave program was not captured")
    vd = wprog.static[0].clone()
    wpairs = dict(pairs("wave", wprog, (vd,), REFACTOR_REPS,
                        want=wsolver.factor.Lx), **program_stats(wprog))
    t_wave = [t / 1e3 for t in wpairs["replay_ms_all"]]
    d_wave = rel_err(wsolver.factor.Lx[:tot], Lpf)
    # two float32 factors of one matrix by other operation orders
    check(d_wave <= 1e-3, f"wave vs pf factor {d_wave:.3e}")
    res_wave = refined(wsolver.solve)
    check(res_wave[-1] <= RESIDUAL_MAX, f"wave residual {res_wave[-1]:.3e}")
    log(f"[front] wave program: {len(wp.instr_cls)} waves in "
        f"{len(wp.classes)} classes, plan {t_wp:.2f} s, first factor "
        f"{t_w1:.3f} s, refactor median {np.median(t_wave) * 1e3:.1f} ms "
        f"replayed (all {[round(t * 1e3, 1) for t in t_wave]}), eager "
        f"{wpairs['eager_ms']:.1f} ms, bit-identical; "
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
                wave_pairs=wpairs,
                wave_waves=int(len(wp.instr_cls)),
                wave_vs_pf_rel=d_wave, wave_residuals=res_wave,
                bf16_factor_s=t_b, bf16_vs_f32_rel=d_bf16,
                bf16_residuals=res_bf16, flops=float(solver.sym.flops))


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
    from suitesparse_tpu_torch.lu.multifrontal import umf_program
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
    prog = umf_program(S, np.float32, "cuda")
    check(prog.graph is not None, f"{name}: the LU program was not captured")
    cap = program_stats(prog)
    vj = prog.static[0].clone()
    lu_pairs = pairs(f"{name} umf", prog, (vj,), LU_REPS,
                     want=(num.Lb, num.Ub, num.pivs))
    prof_eager = profile_refactor(f"lu_{name}_eager",
                                  lambda: prog.eager(vj),
                                  lu_pairs["eager_ms"], PROFILE_DIR)
    log("[profile] " + json.dumps(prof_eager))
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
    forms = None
    if name == LU_FORMS_MATRIX:
        # the A system's triangular pair: U \ (L \ z), per pattern against
        # per numeric
        from suitesparse_tpu_torch.lu.multifrontal import (
            _umf_solve_body, bind_umf_numeric, umf_solve_program)
        rz = np.random.default_rng(LU_SEED + 1)
        z = {k: torch.as_tensor(rz.standard_normal((n, k)),
                                dtype=torch.float32, device="cuda")
             for k in (1, 32)}
        forms = solve_forms(
            f"{name} lsolve+usolve", SOLVE_ROUNDS,
            lambda r: umf_numeric(type(A)(A.indptr, A.indices,
                                          A.data * (1.0 + 0.25 * r),
                                          A.shape), S, default_common()),
            bind_umf_numeric, num,
            {k: [umf_solve_program(S, nm, k, False, torch.float32, "cuda")
                 for nm in ("lsolve", "usolve")] for k in (1, 32)},
            lambda g, k: [_umf_solve_body(S, nm, False, g.Lb, g.Ub, g.pivs)
                          for nm in ("lsolve", "usolve")], z)
        R = bind_umf_numeric(num)
        forms["resident_gib"] = (R.Lb.numel() + R.Ub.numel()) * 4 / 2**30
        log(f"[lu] {name} solve forms: {json.dumps(forms)}")
    return dict(matrix=name, n=n, nnz=int(A.nnz), strategy=S.strategy,
                plan_total=int(plan.total), buckets=int(plan.nbuckets),
                levels=len(plan.levels), umf_symbolic_s=t_sym,
                first_numeric_s=t_first, refactor_ms=t_med * 1e3,
                refactor_ms_all=[t * 1e3 for t in t_ref],
                host_values_ms=float(np.median(t_val)) * 1e3,
                bit_identical_refactor=True,
                device_busy_ms=prof["device_busy_ms"],
                idle_share=prof["idle_share"], capture=cap,
                program_pairs=lu_pairs,
                eager_device_busy_ms=prof_eager["device_busy_ms"],
                eager_idle_share=prof_eager["idle_share"], solves=solves,
                solve_forms=forms,
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
    from suitesparse_tpu_torch.lu.klu_device import klu_refactor_program
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
    dev = torch.device("cuda")
    rprog = klu_refactor_program(plan, 1, torch.float32, dev)
    check(rprog.graph is not None, f"circuit_{n}: refactor not captured")
    cap = program_stats(rprog)
    av1 = av[None].clone()
    klu_pairs = pairs(f"circuit_{n} klu", rprog, (av1,), LU_REPS)
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
    sprog = klu_refactor_program(plan, KLU_SWEEP, torch.float32, dev)
    check(sprog.graph is not None, f"circuit_{n}: sweep not captured")
    sweep_pairs = dict(pairs(f"circuit_{n} sweep", sprog, (vals,),
                             KLU_SWEEP_REPS, want=(fs, Rss, oks)),
                       **program_stats(sprog))
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
                idle_share=prof["idle_share"], capture=cap,
                program_pairs=klu_pairs,
                # the eager body runs the replay's 40,000 kernels; its
                # trace is not taken, to keep the smoke short
                eager_idle_share_vs_replay_busy=1.0 - prof[
                    "device_busy_ms"] / klu_pairs["eager_ms"],
                sweep_pairs=sweep_pairs,
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
        free_device_memory()
    rows.append(run_lu_singular())
    rows.append(run_klu())
    for row in rows:
        log(f"[lu] {json.dumps(row)}")
    return rows


# ---------------------------------------------------------------------------
# The QR family: multifrontal QR, spqr_rank, and the Factorize front door
# ---------------------------------------------------------------------------

def grad3d(k: int):
    """The forward-difference gradient of the k^3 grid: the Kronecker sum
    of (k-1) x k difference matrices, 3 (k-1) k^2 x k^3, rank k^3 - 1 (the
    constants span its null space)."""
    import scipy.sparse as sp
    D = sp.diags([-np.ones(k - 1), np.ones(k - 1)], [0, 1], shape=(k - 1, k))
    eye = sp.identity(k)
    return sp.vstack([sp.kron(sp.kron(D, eye), eye),
                      sp.kron(sp.kron(eye, D), eye),
                      sp.kron(sp.kron(eye, eye), D)]).tocsc()


def grad3d_tik(k: int, mu: float = QR_TIK_MU):
    """Tikhonov-damped gradient [G; mu I]: full column rank, sigma_min =
    mu, sigma_max = sqrt(12 + mu^2)."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    G = grad3d(k)
    return SparseCSC.from_scipy(sp.vstack(
        [G, mu * sp.identity(G.shape[1])]).tocsc())


def qr_plan_stats(S) -> dict:
    """Levels, buckets, buffer sizes, the largest bucket workspace, the
    root front and the padded flops of a QRSymbolic."""
    buckets = [bq for lv in S.levels for bq in lv]

    def flops(FR, FC):            # Householder QR of an FR x FC front
        return (2.0 * FC * FC * (FR - FC / 3.0) if FR >= FC
                else 2.0 * FR * FR * (FC - FR / 3.0))
    root = max(buckets, key=lambda bq: bq.FR * bq.FC)
    return dict(levels=len(S.levels), buckets=len(buckets),
                total_R=int(S.total_R), total_C=int(S.total_C),
                max_workspace=max(len(bq.sids) * bq.FR * bq.FC
                                  for bq in buckets),
                largest_front=[int(root.FR), int(root.FC)],
                padded_flops=sum(len(bq.sids) * flops(bq.FR, bq.FC)
                                 for bq in buckets))


def ls_backward(A, x, b) -> float:
    """||A^T r||_inf / (||A||_1 ||r||_inf), r = b - A x: the least-squares
    optimality of x."""
    S = A.to_scipy()
    r = b - S @ x
    return float(np.abs(S.T @ r).max()
                 / max(A.norm(1) * np.abs(r).max(), 1e-300))


def run_qr_cell(name, A, oracle, limit) -> dict:
    """qr_symbolic, a first qr_factorize on the card, QR_REPS refactors
    (bit-identical R), one profiled, then the least-squares solve split
    into the factorization with Q'b (twice: bit-identical R and Q'b) and
    the host R solve; rank and tol beside the float64 host factor's; the
    solution within ``limit`` of the float64 ``oracle``."""
    import torch
    from suitesparse_tpu_torch.cholesky import residual_norm
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.qr import (qr_factorize, qr_rsolve,
                                          qr_symbolic, r_diagonal)
    m, n = A.shape
    cm = default_common()
    t0 = time.perf_counter()
    S = qr_symbolic(A, cm)
    t_sym = time.perf_counter() - t0
    stats = qr_plan_stats(S)
    log(f"[qr] {name} m={m} n={n} nnz={A.nnz} qr_symbolic {t_sym:.2f} s "
        f"{json.dumps(stats)}")
    torch.cuda.reset_peak_memory_stats()
    t_first, num = host_time(lambda: qr_factorize(A, S, common=cm))
    check(num.Rbuf.device.type == "cuda", f"{name}: R on {num.Rbuf.device}")
    t_ref = []
    for _ in range(QR_REPS):
        t, again = host_time(lambda: qr_factorize(A, S, common=cm))
        t_ref.append(t)
        check(torch.equal(num.Rbuf, again.Rbuf),
              f"{name}: refactorizations are not bit-identical")
        del again
    t_med = float(np.median(t_ref))
    prof = profile_refactor(f"qr_{name}",
                            lambda: qr_factorize(A, S, common=cm),
                            t_med * 1e3, PROFILE_DIR, groups=QR_GROUPS)
    log("[profile] " + json.dumps(prof))
    b = np.random.default_rng(QR_SEED).standard_normal(m)
    t_fb, nb = host_time(lambda: qr_factorize(A, S, b=b))
    t_fb2, nb2 = host_time(lambda: qr_factorize(A, S, b=b))
    check(torch.equal(nb.Rbuf, nb2.Rbuf) and np.array_equal(nb.qtb, nb2.qtb),
          f"{name}: factorizations with Q'b are not bit-identical")
    check(torch.equal(nb.Rbuf, num.Rbuf),
          f"{name}: R with Q'b differs from R without (mode 'r')")
    del nb2
    prof_b = profile_refactor(f"qr_{name}_qtb",
                              lambda: qr_factorize(A, S, b=b),
                              t_fb2 * 1e3, PROFILE_DIR, groups=QR_GROUPS)
    log("[profile] " + json.dumps(prof_b))
    t_rs, xq = host_time(lambda: qr_rsolve(nb, nb.qtb[:, 0]))
    x = np.empty_like(xq)
    x[S.sym.perm] = xq
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(tuple(x.shape) == (n,) and bool(np.isfinite(x).all()),
          f"{name}: solution shape/finiteness")
    # the float64 host factor: its rank under the same formula, and R's
    # diagonal against the card's up to sign
    t_h, nh = host_time(lambda: qr_factorize(A, S, device="cpu"))
    dg, dh = np.abs(r_diagonal(S, num.Rbuf)), np.abs(r_diagonal(S, nh.Rbuf))
    diag_rel = float(np.abs(dg - dh).max() / dh.max())
    host_rank, host_tol = nh.rank, nh.tol
    del nh
    t_o, xo = host_time(oracle)
    err = float(np.abs(x - xo).max() / np.abs(xo).max())
    # least-squares optimality for m > n; the residual for a square A
    quality = (dict(ls_backward=ls_backward(A, x, b)) if m > n
               else dict(residual=residual_norm(A, x, b)))
    check(num.rank == nb.rank == host_rank == min(m, n),
          f"{name}: rank {num.rank} (tol {num.tol:.3e}), float64 host "
          f"{host_rank} (tol {host_tol:.3e}), want {min(m, n)}")
    check(err <= limit, f"{name}: {err:.3e} from the float64 oracle > "
          f"{limit}")
    return dict(matrix=name, m=m, n=n, nnz=int(A.nnz), **stats,
                qr_symbolic_s=t_sym, first_factorize_s=t_first,
                refactor_ms=t_med * 1e3,
                refactor_ms_all=[t * 1e3 for t in t_ref],
                bit_identical_refactor=True,
                device_busy_ms=prof["device_busy_ms"],
                idle_share=prof["idle_share"], kernels=prof["kernels"],
                group_ms=prof["group_ms"],
                factor_with_qtb_s=[t_fb, t_fb2], host_rsolve_s=t_rs,
                qtb_device_busy_ms=prof_b["device_busy_ms"],
                qtb_kernels=prof_b["kernels"], qtb_group_ms=prof_b["group_ms"],
                peak_mem_gib=peak, rank=num.rank, tol=num.tol,
                host_f64_rank=host_rank, host_f64_tol=host_tol,
                host_f64_factor_s=t_h, min_abs_diag=float(dg.min()),
                diag_vs_f64_rel=diag_rel, **quality,
                oracle_s=t_o, vs_oracle_rel=err, limit=limit)


def qr_cells():
    """The [qr] phase's least-squares cells: (name, A, float64 oracle of
    the solution for QR_SEED's b, limit)."""
    import scipy.sparse.linalg as sla
    from suitesparse_tpu_torch.io.generators import random_unsym

    def lsq_oracle(A):
        S = A.to_scipy().tocsc()
        b = np.random.default_rng(QR_SEED).standard_normal(S.shape[0])
        return lambda: sla.spsolve((S.T @ S).tocsc(), S.T @ b)

    def square_oracle(A):
        S = A.to_scipy().tocsc()
        b = np.random.default_rng(QR_SEED).standard_normal(S.shape[0])
        return lambda: sla.spsolve(S, b)

    tik = grad3d_tik(QR_TIK_K)
    ru = random_unsym(QR_RU_N, density=0.008)
    return ((f"grad3d_{QR_TIK_K}_tik", tik, lsq_oracle(tik), QR_TIK_MAX),
            (f"randunsym_{QR_RU_N}", ru, square_oracle(ru), QR_RANDUNSYM_MAX))


def run_qr_keep_q() -> dict:
    """The keep_q paths on grad3d_QR_Q_K's gradient G (rank n - 1):
    spqr_null(G) is the constants' direction, spqr_pinv(G) b and
    qr_min2norm(G^T) c match numpy.linalg.pinv in float64, qr_qmult's four
    methods are an isometry that reproduces R's columns; and qr_q's
    explicit Q at grad3d_QR_QQ_K."""
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.models import spqr_null, spqr_pinv, spqr_rank
    from suitesparse_tpu_torch.qr.spqr import _r_matrix
    from suitesparse_tpu_torch.qr import (qr_factorize, qr_min2norm, qr_q,
                                          qr_qmult, qr_symbolic)
    import scipy.sparse as sp
    rng = np.random.default_rng(QR_SEED)
    Gs = grad3d(QR_Q_K)
    m, n = Gs.shape
    G = SparseCSC.from_scipy(Gs)
    Gt = SparseCSC.from_scipy(sp.csc_matrix(Gs.T))
    out = dict(matrix=f"grad3d_{QR_Q_K}", m=m, n=n)

    t, N = host_time(lambda: spqr_null(G))
    dev = float(np.abs(np.abs(N) - 1 / np.sqrt(n)).max()) if N.size else 1.0
    check(N.shape == (n, 1) and dev <= QR_KEEPQ_MAX,
          f"spqr_null(G): shape {N.shape}, ||N| - 1/sqrt(n)| {dev:.3e}")
    out.update(spqr_null_s=t, null_cols=int(N.shape[1]),
               null_vs_constants=dev,
               null_GN=float(np.abs(Gs @ N).max()))
    t, r = host_time(lambda: spqr_rank(G))
    check(r == n - 1, f"spqr_rank(G) = {r}, want {n - 1}")
    out.update(spqr_rank_s=t, rank=r)

    t_p, P = host_time(lambda: np.linalg.pinv(Gs.toarray()))
    b = rng.standard_normal(m)
    t, x = host_time(lambda: spqr_pinv(G, b))
    xr = P @ b
    e_pinv = float(np.abs(x - xr).max() / np.abs(xr).max())
    check(e_pinv <= QR_KEEPQ_MAX, f"spqr_pinv(G) vs pinv {e_pinv:.3e}")
    c = rng.standard_normal(n)
    c -= c.mean()                      # in the range of G^T
    t2, y = host_time(lambda: qr_min2norm(Gt, c))
    yr = P.T @ c
    e_mn = float(np.abs(y - yr).max() / np.abs(yr).max())
    check(e_mn <= QR_KEEPQ_MAX, f"qr_min2norm(G^T) vs pinv {e_mn:.3e}")
    del P
    out.update(numpy_pinv_s=t_p, spqr_pinv_s=t, pinv_vs_numpy_rel=e_pinv,
               min2norm_s=t2, min2norm_vs_numpy_rel=e_mn)

    cm = default_common()
    S = qr_symbolic(G, cm)
    t, num = host_time(lambda: qr_factorize(G, S, common=cm, keep_q=True))
    q_entries = sum(q.size for lv in num.Qs for q in lv)
    X = rng.standard_normal((m, 4))
    t_q, Y = host_time(lambda: qr_qmult(num, X, "QTX"))
    iso = float(np.abs(np.linalg.norm(Y, axis=0)
                       / np.linalg.norm(X, axis=0) - 1).max())
    back = float(np.abs(qr_qmult(num, Y, "QX") - X).max() / np.abs(X).max())
    X2 = rng.standard_normal((4, m))
    back2 = float(np.abs(qr_qmult(num, qr_qmult(num, X2, "XQ"), "XQT") - X2)
                  .max() / np.abs(X2).max())
    cols = np.sort(rng.choice(n, 16, replace=False))
    Ap = Gs[:, S.sym.perm][:, cols].toarray()
    QtA = qr_qmult(num, Ap, "QTX")
    R = _r_matrix(num)[:, cols].toarray()
    rep = float(max(np.abs(QtA[:n] - R).max(), np.abs(QtA[n:]).max())
                / np.abs(R).max())
    for what, v in (("isometry", iso), ("QX(QTX)", back),
                    ("XQT(XQ)", back2), ("Q'A = R", rep)):
        check(v <= QR_KEEPQ_MAX, f"qr_qmult {what}: {v:.3e}")
    out.update(keep_q_factorize_s=t, keep_q_entries=int(q_entries),
               qmult_qtx_s=t_q, qmult_isometry=iso, qmult_inverse=back,
               qmult_xq_inverse=back2, qmult_reproduces_r=rep)
    del num

    Gq = SparseCSC.from_scipy(grad3d(QR_QQ_K))
    Sq = qr_symbolic(Gq)
    nq = qr_factorize(Gq, Sq, keep_q=True)
    Q = qr_q(nq, econ=True)
    Aq = grad3d(QR_QQ_K)[:, Sq.sym.perm].toarray()
    Rq = _r_matrix(nq).toarray()
    e_q = float(np.abs(Q @ Rq - Aq).max() / np.abs(Aq).max())
    e_o = float(np.abs(Q.T @ Q - np.eye(Q.shape[1])).max())
    check(e_q <= QR_KEEPQ_MAX and e_o <= QR_KEEPQ_MAX,
          f"qr_q at grad3d_{QR_QQ_K}: QR - A {e_q:.3e}, Q'Q - I {e_o:.3e}")
    out.update(qr_q_matrix=f"grad3d_{QR_QQ_K}", qr_q_shape=list(Q.shape),
               qr_q_vs_A=e_q, qr_q_orthonormal=e_o, limit=QR_KEEPQ_MAX)
    return out


def run_front_door(block_chol) -> dict:
    """Factorize / backslash on an SPD, an unsymmetric, a rectangular and
    a symmetric indefinite matrix: the kind each picks, block_chol's
    launches for each (the SPD one through the pf program, the others
    none), and each solution's residual (least-squares optimality for the
    rectangular one)."""
    from suitesparse_tpu_torch.cholesky import residual_norm
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.core.sparse import symmetry
    from suitesparse_tpu_torch.io.generators import laplacian_3d
    from suitesparse_tpu_torch.models import Factorize, backslash
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    import scipy.sparse as sp
    L = laplacian_3d(FD_INDEF_K).to_scipy()
    indef = SparseCSC.from_scipy((L - 3.0 * sp.identity(L.shape[0])).tocsc())
    cases = ((f"lap3d_{FD_SPD_K}", laplacian_3d(FD_SPD_K), "cholesky"),
             (f"cd3d_{FD_LU_K}", cd3d(FD_LU_K), "lu"),
             (f"grad3d_{FD_QR_K}_tik", grad3d_tik(FD_QR_K), "qr"),
             (f"lap3d_{FD_INDEF_K}_minus_3I", indef, "lu"))
    rows = []
    for name, A, want in cases:
        b = np.random.default_rng(QR_SEED).standard_normal(A.nrow)
        cm = default_common()
        block_chol.launches = 0        # this matrix's count starts here
        t_f, F = host_time(lambda: Factorize(A, cm))
        t_s, x = host_time(lambda: F.solve(b))
        launches = block_chol.launches
        check(F.kind == want, f"Factorize({name}) picked {F.kind}, want "
              f"{want}")
        if want == "cholesky":
            check(launches > 0, f"Factorize({name}) never launched "
                  f"block_chol")
        else:
            check(launches == 0, f"Factorize({name}) launched block_chol "
                  f"{launches} times")
        if name.endswith("minus_3I"):
            # symmetric with a positive diagonal: the front door tried
            # Cholesky first, and only its not-positive-definite outcome
            # falls through to LU (any other error would have propagated)
            check(symmetry(A) == (1.0, A.ncol) and Factorize._hermitian(A)
                  and Factorize._diag_positive(A),
                  f"{name}: not a Cholesky guess")
        res = (ls_backward(A, x, b) if want == "qr"
               else residual_norm(A, x, b))
        check(bool(np.isfinite(x).all()) and res <= FD_RES_MAX,
              f"Factorize({name}) residual {res:.3e} > {FD_RES_MAX}")
        t_b, xb = host_time(lambda: backslash(A, b))
        same = float(np.abs(xb - x).max() / np.abs(x).max())
        check(same <= FD_RES_MAX, f"backslash({name}) vs Factorize {same}")
        rows.append(dict(matrix=name, n=A.ncol, m=A.nrow, kind=F.kind,
                         factorize_s=t_f, solve_s=t_s, backslash_s=t_b,
                         block_chol_launches=launches, residual=res))
    return rows


def run_qr(probes) -> dict:
    """The [qr] phase: the least-squares cells and the keep_q paths, with
    the counts of the port's four kernels read (none lies on the QR path),
    then the Factorize front door with block_chol counted per matrix."""
    out = dict(cells=[])
    for k in probes:
        k.launches = 0                 # the QR path's count starts here
    for name, A, oracle, limit in qr_cells():
        row = run_qr_cell(name, A, oracle, limit)
        log(f"[qr] {json.dumps(row)}")
        out["cells"].append(row)
        del A
    out["keep_q"] = run_qr_keep_q()
    log(f"[qr] {json.dumps(out['keep_q'])}")
    qr_launches = {k.__name__: k.launches for k in probes}
    log(f"[main] kernel launches on the QR path: {json.dumps(qr_launches)}")
    check(not any(qr_launches.values()),
          f"a kernel of the port ran on the QR path: {qr_launches}")
    out["front_door"] = run_front_door(probes[0])
    for row in out["front_door"]:
        log(f"[qr] front door {json.dumps(row)}")
    return out


def dist_check(name, res) -> dict:
    """Checks of one ``dist`` case over every rank's result, and the row
    the [dist] line prints: per rank lbuf, peak memory and the median
    phase times of the refactorizations; bytes a rank per phase; the
    collectives of one factor and of one solve."""
    rows = [r[name] for r in res]
    r0 = rows[0]
    n = r0["n"]
    for r in rows:
        check(r["status"] == 0 and r["minor"] == n,
              f"[dist] {name} rank {r['rank']}: status {r['status']} "
              f"minor {r['minor']}")
        check(r["residuals"][-1] <= RESIDUAL_MAX,
              f"[dist] {name} rank {r['rank']} residuals {r['residuals']}")
        check(r["factor_bytes"].get("boundary", 0)
              == r["info_bytes"]["dist_psum_bytes"],
              f"[dist] {name}: boundary bytes {r['factor_bytes']} vs "
              f"dist_psum_bytes {r['info_bytes']['dist_psum_bytes']}")
    check(r0["gather_vs_wave_rel"] <= DIST_GATHER_MAX,
          f"[dist] {name}: gather() vs wave_numeric "
          f"{r0['gather_vs_wave_rel']:.3e} > {DIST_GATHER_MAX}")
    med = {k.replace("dist_", "").replace("_time", "_ms"):
           [float(np.median(r["refactor_times_s"][k])) * 1e3 for r in rows]
           for k in r0["refactor_times_s"]}
    # each rank program against its eager body (every top-wave run summed)
    programs = None
    if "program_pairs" in r0:
        programs = {}
        for r in rows:
            check(all(p["replayed"] for p in r["program_pairs"]),
                  f"[dist] {name} rank {r['rank']}: a program not replayed")
        for p in r0["program_pairs"]:
            programs.setdefault(p["program"], dict(
                count=0, **{k: [0.0] * len(rows) for k in (
                    "eager_ms", "replay_ms", "warmup_s", "capture_s",
                    "graph_nodes")}))["count"] += 1
        for i, r in enumerate(rows):
            for p in r["program_pairs"]:
                d = programs[p["program"]]
                for k in ("eager_ms", "replay_ms", "warmup_s", "capture_s",
                          "graph_nodes"):
                    d[k][i] += p[k]
    return dict(
        programs=programs,
        matrix=name, n=n, ranks=len(rows), backend=res[0]["backend"],
        plan_s=[r["plan_s"] for r in rows],
        first_factor_s=r0["first_factor_s"], refactors=len(
            r0["refactor_times_s"]["dist_factor_time"]),
        refactor_median_ms=med, lbuf=r0["lbuf"],
        max_memory_allocated=[r.get("max_memory_allocated") for r in rows],
        factor_collectives=r0["expected_factor_counts"],
        solve_collectives=r0["solve_counts"],
        bytes_per_rank=r0["factor_bytes"], solve_bytes=r0["solve_bytes"],
        info_bytes=r0["info_bytes"],
        solve_ms=[round(t * 1e3, 3) for t in r0["solve_s"]],
        residuals=r0["residuals"], gather_vs_wave_rel=r0["gather_vs_wave_rel"],
        top_fan=len(r0["top_fan"]), root=r0["root"],
        seq_slots=r0["seq_slots"],
        model_speedup=r0["comm"]["dist_model_speedup"],
        model_speedup_disp=r0["comm"].get("dist_model_speedup_disp"),
        pad_ratio=r0["comm"]["dist_pad_ratio"])


def run_dist(probes, front) -> dict:
    """The [dist] phase: the distributed layer's ranks on this one card
    (P processes over gloo, one over NCCL), each checked by its ranks and
    here; the counts of the port's four kernels over every rank (none lies
    on the distributed path).  The timeline model's constants are this
    card's: lap3d_44's flops over its wave-program refactor median, and
    that median over its wave count (the [front] phase)."""
    from suitesparse_tpu_torch.tools.multihost_dryrun import launch
    for k in probes:
        k.launches = 0                 # the distributed path's count
    wave_s = front["wave_refactor_ms"] * 1e-3
    model = [front["flops"] / wave_s, wave_s / front["wave_waves"]]
    work = os.path.join(ROOT, "build", "dist")
    out = {}
    lap = f"lap3d_{DIST_K}"
    job = dict(backend="gloo", device="cuda", cases=[
        dict(kind="dist", name=lap, gen="laplacian_3d", arg=DIST_K,
             dtype="float32", reps=REFACTOR_REPS, refine=REFINE_STEPS,
             check_wave=True, seed=DIST_SEED, model=model,
             pairs=DIST_PAIRS),
        dict(kind="block_cyclic", N=DIST_BC_N, nb=DIST_BC_NB, seed=DIST_SEED,
             dtype="float32", on_device=True)])
    t0 = time.perf_counter()
    res4 = launch(DIST_P, job, os.path.join(work, f"p{DIST_P}"),
                  DIST_TIMEOUT)
    out[lap] = dist_check(lap, res4)
    out[lap]["launch_s"] = time.perf_counter() - t0
    log(f"[dist] {json.dumps(out[lap])}")
    bc = res4[0]["block_cyclic"]
    check(bc["vs_float64_rel"] <= DIST_BC_MAX,
          f"[dist] block_cyclic {bc['vs_float64_rel']:.3e} > {DIST_BC_MAX}")
    bc["seconds_all_ranks"] = [r["block_cyclic"]["seconds"] for r in res4]
    out["block_cyclic"] = bc
    log(f"[dist] block_cyclic_cholesky {json.dumps(bc)}")

    lap2 = f"lap3d_{DIST_P2_K}"
    job = dict(backend="gloo", device="cuda", cases=[
        dict(kind="dist", name=lap2, gen="laplacian_3d", arg=DIST_P2_K,
             dtype="float32", reps=REFACTOR_REPS, refine=REFINE_STEPS,
             check_wave=True, seed=DIST_SEED),
        # a top-front threshold of 512: the replicated top waves (Np 256)
        # run as one program between the fanned fronts
        dict(kind="dist", name=lap2 + "_top", gen="laplacian_3d",
             arg=DIST_P2_K, dtype="float32", reps=REFACTOR_REPS,
             refine=REFINE_STEPS, check_wave=True, seed=DIST_SEED,
             root_2d_min=DIST_TOP_MIN, pairs=DIST_PAIRS),
        dict(kind="notposdef", gen="laplacian_3d", arg=DIST_INDEF_K,
             shift=-3.0, dtype="float32", single=True),
        dict(kind="level_step", gen="laplacian_3d", arg=DIST_LEVEL_K,
             dtype="float32")])
    t0 = time.perf_counter()
    res2 = launch(2, job, os.path.join(work, "p2"), DIST_TIMEOUT)
    out[lap2] = dist_check(lap2, res2)
    out[lap2]["launch_s"] = time.perf_counter() - t0
    log(f"[dist] {json.dumps(out[lap2])}")
    out[lap2 + "_top"] = dist_check(lap2 + "_top", res2)
    check(out[lap2 + "_top"]["programs"].get("dist_top", {}).get("count", 0)
          >= 1,
          f"[dist] {lap2}_top: no run of replicated top waves")
    log(f"[dist] {json.dumps(out[lap2 + '_top'])}")
    npd = res2[0]["notposdef"]
    check(all(r["notposdef"]["status"] == 1 for r in res2)
          and npd["single_status"] == 1
          and all(r["notposdef"]["minor"] == npd["single_minor"]
                  for r in res2),
          f"[dist] lap3d_{DIST_INDEF_K} - 3I: {[r['notposdef'] for r in res2]}")
    out["notposdef"] = npd
    log(f"[dist] lap3d_{DIST_INDEF_K} - 3I over 2 ranks: NOT_POSDEF, minor "
        f"{npd['minor']} (single-process {npd['single_minor']})")
    lv = res2[0]["level_step"]
    check(all(r["level_step"]["vs_single_max_abs"] == 0.0 for r in res2),
          f"[dist] distributed_level_step differs from the single-process "
          f"step: {[r['level_step'] for r in res2]}")
    out["level_step"] = lv
    log(f"[dist] distributed_level_step lap3d_{DIST_LEVEL_K} {json.dumps(lv)}")

    lap1 = f"lap3d_{DIST_NCCL_K}"
    job = dict(backend="nccl", device="cuda", cases=[
        dict(kind="dist", name=lap1, gen="laplacian_3d", arg=DIST_NCCL_K,
             dtype="float32", reps=REFACTOR_REPS, refine=REFINE_STEPS,
             check_wave=True, seed=DIST_SEED)])
    t0 = time.perf_counter()
    res1 = launch(1, job, os.path.join(work, "p1"), DIST_TIMEOUT)
    out[lap1] = dist_check(lap1, res1)
    out[lap1]["launch_s"] = time.perf_counter() - t0
    log(f"[dist] {json.dumps(out[lap1])}")

    launches = {k.__name__: k.launches for k in probes}
    for r in res4 + res2 + res1:
        for name, v in r["kernel_launches"].items():
            launches[name] += v
    log(f"[main] kernel launches on the distributed path (every rank): "
        f"{json.dumps(launches)}")
    check(not any(launches.values()),
          f"a kernel of the port ran on the distributed path: {launches}")
    return out


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
    run_unrolled()
    os.makedirs(PROFILE_DIR, exist_ok=True)

    from suitesparse_tpu_torch.cholesky.kernels import block_chol
    block_chol.launches = 0            # the main path's count starts here
    rows = {}
    shapes = {}                        # {matrix: {(W, Np): launches}}
    for name in MATRICES:
        rows[name], shapes[name] = run_matrix(name, REFACTOR_REPS)
        free_device_memory()           # this plan's programs and pools
    log(f"[time] cholesky phases done at {time.perf_counter() - t_start:.1f} s")
    bench = run_bench()                # its factors count on the main path
    launches = block_chol.launches + bench["block_chol_launches"]
    check(launches > 0, "main path never launched block_chol")
    log(f"[main] block_chol launches on the main path: {launches} "
        f"({bench['block_chol_launches']} in the {BENCH_MATRIX} bench)")
    log(f"[time] bench phase done at {time.perf_counter() - t_start:.1f} s "
        f"(bench_extra {bench['extra_s']:.1f} s)")
    shapes[BENCH_MATRIX] = bench["block_chol_shapes"]
    kline = kernel_line(shapes, launches, kind)
    run_ablate()
    free_device_memory()
    run_probes()
    free_device_memory()
    log(f"[time] ablation and probe phases done at "
        f"{time.perf_counter() - t_start:.1f} s")

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
    free_device_memory()

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
    free_device_memory()

    # the QR family: no kernel of the port lies on the QR path (the
    # reference's QR is jnp.linalg.qr per bucket); the Factorize front
    # door's SPD branch runs block_chol
    run_qr(probes)
    log(f"[time] qr phase done at {time.perf_counter() - t_start:.1f} s")

    # the distributed layer: ranks in processes of their own on this card;
    # no kernel of the port lies on its path
    run_dist(probes, front)
    log(f"[time] dist phase done at {time.perf_counter() - t_start:.1f} s")

    log(f"[done] {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": [kline, bline] + dlines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
