#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (suitesparse_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``suitesparse_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path -- supernodal Cholesky analysis, pass-forward factor,
refactorization, inverted diagonal blocks, device-resident solves and
float64 iterative refinement -- on two full-size stand-in matrices
(lap3d_44, n = 85,184; fem3d_80000, an irregular tetrahedral mesh), and
checks what comes out.  Any failed check raises and the script exits
nonzero; nothing is caught and carried on.  Without a CUDA device, or
without the package beside it, it exits nonzero and prints no result.

It also profiles one refactorization of each matrix with torch.profiler:
the Chrome trace goes to ``build/profiles/profile_<matrix>.json`` (~30 MB
each, gitignored), and a ``[profile]`` line gives
the device busy time (union of the kernel intervals), the idle share
against the median of the unprofiled refactorizations, and the device
time per kernel group and for the top kernels.

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
# f32 peak outside the tensor cores and HBM rate of one H100 SXM (NVIDIA
# data sheet, 700 W); the batched Cholesky runs on the CUDA cores
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNELS = ("block_chol",)     # the port's CUDA sources, csrc/<name>.cu
REFACTOR_REPS = 5
# kernel-name fragments of each device-time group in a profile
GROUPS = (("block_chol", ("block_chol",)),
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
    for name in KERNELS:
        cuda_build.build(name)
    log(f"[setup] built {list(KERNELS)} with {cuda_build.nvcc()} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        for line in (cuda_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[setup] ptxas {name}: {line.strip()}")


def phase_kernel_vs_plain():
    """block_chol kernel vs its plain version, every Np of the ladders."""
    import torch
    from suitesparse_tpu_torch.cholesky.kernels import (block_chol,
                                                        block_chol_plain)
    rng = np.random.default_rng(0)
    # tolerances: kernel and plain run the same rank-1 updates but the
    # kernel fuses each multiply-subtract (FMA) and computes rsqrt with
    # the device intrinsic, so results differ by rounding accumulated over
    # Np steps: ~Np ulp of the working type at worst
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    worst = {}
    for dt in (torch.float64, torch.float32):
        for Np in (8, 16, 32, 64, 128):
            for W in (1, 37, 512):
                S, pe = spd_batch(rng, W, Np, dt, npad=Np // 8)
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
    log(f"[kernel] block_chol vs plain, Np in 8..128, W in 1/37/512: max "
        f"relative error f64 {worst[torch.float64]:.3e} (tol 1e-12), "
        f"f32 {worst[torch.float32]:.3e} (tol 1e-5)")
    # NaN contract: a negative pivot must come out as NaN, as in the plain
    for dt in (torch.float64, torch.float32):
        S, pe = spd_batch(rng, 4, 32, dt)
        S[1, 5, 5] = -5.0
        K = block_chol(S, pe)
        P = block_chol_plain(S, pe)
        sync()
        check(bool(torch.isnan(K[1]).any()), "no NaN on indefinite block")
        check(bool(torch.isfinite(K[[0, 2, 3]]).all()),
              "NaN leaked into definite blocks")
        check(torch.equal(torch.isnan(K), torch.isnan(P)),
              "kernel and plain disagree on the NaN pattern")
    log("[kernel] NaN on a non-positive pivot: held (f64, f32)")


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
    peak = torch.cuda.max_memory_allocated()
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
               peak_mem_gib=peak / 2**30,
               block_chol_launches_per_factor=per_factor)
    log(f"[{name}] " + json.dumps(row))
    return row, factor_shapes(pfp)


def kernel_line(shapes, launches, dev_kind):
    """Time block_chol at the (W, Np) shapes of one lap3d_44 factor, beside
    its plain version, its bound and torch.linalg.cholesky (yardstick)."""
    import torch
    from suitesparse_tpu_torch.cholesky.kernels import (block_chol,
                                                        block_chol_plain)
    rng = np.random.default_rng(2)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    max_abs = 0.0
    for (W, Np), cnt in sorted(shapes.items()):
        S, pe = spd_batch(rng, W, Np, torch.float32, npad=Np // 8)
        K = block_chol(S, pe)
        P = block_chol_plain(S, pe)
        check(rel_err(K, P) <= 1e-5,
              f"block_chol vs plain at the main path's W={W} Np={Np}")
        max_abs = max(max_abs, float((K - P).abs().max()))
        ms = event_ms(lambda: block_chol(S, pe), 50)
        plain = event_ms(lambda: block_chol_plain(S, pe), 3)
        lib = event_ms(lambda: torch.linalg.cholesky(
            S + torch.diag_embed(pe)), 20)
        t_bytes = (2 * W * Np * Np + W * Np) * 4 / PEAK_BYTES * 1e3
        t_ops = W * Np ** 3 / 3 / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"[kernel] block_chol W={W} Np={Np} x{cnt}/factor: "
            f"{ms * 1e3:.2f} us (plain {plain * 1e3:.1f} us, bound "
            f"{bound * 1e3:.3f} us by "
            f"{'bytes' if t_bytes >= t_ops else 'operations'}, "
            f"torch.linalg.cholesky {lib * 1e3:.1f} us) on {dev_kind}")
        for k, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                     ("library_ms", lib), ("bytes_ms", t_bytes),
                     ("ops_ms", t_ops)):
            tot[k] += cnt * v
    return dict(name="block_chol", route="cuda",
                source="suitesparse_tpu_torch/csrc/block_chol.cu",
                replaces="suitesparse_tpu/cholesky/pallas_kernels.py:68",
                launches=launches, max_abs_err=max_abs,
                ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"],
                bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                          else "operations"),
                library_ms=tot["library_ms"],
                timed_as="one lap3d_44 factor's launches, shape by shape")


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
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": [kline]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
