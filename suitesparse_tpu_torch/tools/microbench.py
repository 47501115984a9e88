"""Primitive micro-benchmarks of the factor program's operations: the
counterpart of tools/microbench.py.

    python -m suitesparse_tpu_torch.tools.microbench [section ...]

Sections (default: all), each on the port's own form of the operation:

  roofline  float32 (4096^3, 8192^3) and bfloat16 (8192^3) products
  slice     a 64 MB panel slice of a 256 MB flat buffer read, scaled and
            written to another slice (``_panels`` views, one kernel)
  gather    element, block and row gathers (index tensors)
  scatter   the sorted, unique, non-atomic ``Fx[dst] += v`` of the factor
            step, 1M and 8M entries into 32M
  segsum    the port's ``segment_sum`` (sorted runs), 32M into 8M
  project   the one-hot placement of a pair projection: a one-hot
            product (a row gather above 256 columns) and the patch
            contraction, as the reference runs it (the port's pair step
            runs the extend-add kernel, tools/bench_extend_add.py)
  chol      batched POTRF (``cholesky_ex``), TRSM (``solve_triangular``)
            and SYRK (``super_numeric.syrk``)

Every time is the mean of a chain of back-to-back calls timed with CUDA
events (one warm call first): the card has no host tunnel to cancel, so
the reference's host readback is not needed.  Every float32 product runs
in full float32 (TF32 off) unless a probe says otherwise.  A reading above
105% of the H100's datasheet peak it names (67 TFLOP/s float32 on the CUDA
cores, 495 TFLOP/s TF32, 989 TFLOP/s dense bfloat16, 3.35 TB/s HBM)
raises: the timing would be wrong.  A byte rate counts every input read
once (index tensors included) and every output written once.  It is held
against the HBM peak only when the data it touches exceeds twice the 50 MB
L2 cache; a working set that stays in L2 may beat HBM, and the card has no
datasheet L2 rate, so such a reading is labelled unchecked.  Runs on the
card unless ``device="cpu"`` is asked for, where the times are the host's
and no device rate is claimed.
"""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["PEAKS", "SECTIONS", "check_peak", "main", "matmul_precision",
           "per_call_s"]

# H100 SXM datasheet peaks at 700 W (dense; FLOP/s or bytes/s)
PEAKS = dict(float32=67e12, tf32=495e12, bfloat16=989e12, hbm=3.35e12)
PEAK_MARGIN = 1.05
L2_BYTES = 50e6
REPS = 10
IDX = torch.int64


def check_peak(rate: float, peak: str, what: str) -> float:
    """``rate`` unless it lies above PEAK_MARGIN x PEAKS[peak]: then the
    timing cannot be right and this raises."""
    if rate > PEAK_MARGIN * PEAKS[peak]:
        raise RuntimeError(f"{what}: {rate:.4g}/s is above {PEAK_MARGIN:.0%}"
                           f" of the H100's {peak} peak {PEAKS[peak]:.4g}/s;"
                           f" the timing is wrong")
    return rate


def check_bytes(nbytes: float, working_set: float, t: float,
                what: str) -> str:
    """GB/s of ``nbytes`` in ``t`` s, held against the HBM peak when the
    ``working_set`` exceeds twice the L2 cache; the label says which."""
    if working_set > 2 * L2_BYTES:
        check_peak(nbytes / t, "hbm", what)
        return f"{nbytes / t / 1e9:.1f} GB/s"
    return f"{nbytes / t / 1e9:.1f} GB/s (within L2: unchecked)"


def per_call_s(fn, dev: torch.device, reps: int = REPS) -> float:
    """s per call of ``reps`` back-to-back calls of ``fn`` after one warm
    call: CUDA events on the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(dev)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / 1e3 / reps


@contextlib.contextmanager
def matmul_precision(setting: str):
    """torch's float32 matmul precision ("highest", "high": TF32,
    "medium": bfloat16 internally) set for the block and restored after,
    with the TF32 flag."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision(setting)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        # the flag only where it disagreed with the precision (setting it
        # after the precision otherwise mixes torch's two APIs)
        if torch.backends.cuda.matmul.allow_tf32 != saved[1]:
            torch.backends.cuda.matmul.allow_tf32 = saved[1]


def _randn(shape, dev, dtype=torch.float32, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype=dtype, device=dev)


def sec_roofline(dev, cases=((torch.float32, 4096), (torch.float32, 8192),
                             (torch.bfloat16, 8192)), reps=REPS) -> dict:
    print("== GEMM roofline (chained, CUDA events) ==", flush=True)
    out = {}
    for dtype, n in cases:
        a, b = _randn((n, n), dev, dtype, 1), _randn((n, n), dev, dtype, 2)
        with matmul_precision("highest"):
            t = per_call_s(lambda: a @ b, dev, reps)
        name = "float32" if dtype == torch.float32 else "bfloat16"
        rate = check_peak(2 * n ** 3 / t, name, f"{name} {n}^3 product")
        out[f"{name}_{n}"] = dict(ms=t * 1e3, gflops=rate / 1e9)
        print(f"  {name} {n}^3: {t * 1e3:.3f} ms -> {rate / 1e9:,.0f} "
              f"GFLOP/s", flush=True)
    return out


def sec_slice(dev, N=64 << 20, M=16 << 20, reps=REPS) -> dict:
    from ..cholesky.super_numeric import _panels
    print("== panel slice read/write (HBM bandwidth proxy) ==", flush=True)
    Mp, Np = 64, 64                    # M floats as M // 4096 panels
    x = torch.arange(N, dtype=torch.float32, device=dev)
    src = _panels(x, 1024, M // (Mp * Np), Mp, Np)
    dst = _panels(x, 2048 + M, M // (Mp * Np), Mp, Np)
    t = per_call_s(lambda: torch.mul(src, 1.5, out=dst), dev, reps)
    nb = 2 * M * 4
    rate = check_bytes(nb, nb, t, "panel slice")
    print(f"  slice+write {M * 4 >> 20} MB: {t * 1e3:.3f} ms -> {rate}",
          flush=True)
    return dict(ms=t * 1e3, gbs=nb / t / 1e9)


def sec_gather(dev, N=16 << 20, blocks=((32, 8192, 8192), (128, 1024, 1024)),
               rows=((128, 1 << 20), (1024, 1 << 17)), reps=REPS) -> dict:
    print("== gathers at varying granularity ==", flush=True)
    rng = np.random.default_rng(0)
    out = {}
    x = _randn(N, dev)
    idx = torch.as_tensor(rng.integers(0, N, N), dtype=IDX, device=dev)
    t = per_call_s(lambda: x[idx], dev, reps)
    nb = N * (8 + 4 + 4)               # index, element read, element written
    rate = check_bytes(nb, nb, t, "element gather")
    out["element"] = dict(ms=t * 1e3, gbs=nb / t / 1e9)
    print(f"  element gather {N >> 20}M: {t * 1e3:.3f} ms -> {rate}",
          flush=True)
    for mb, B, K in blocks:
        u = _randn((B, mb, mb), dev)
        ids = torch.as_tensor(rng.integers(0, B, K), dtype=IDX, device=dev)
        t = per_call_s(lambda: u[ids], dev, reps)
        nb = K * (8 + 2 * mb * mb * 4)
        rate = check_bytes(nb, nb + B * mb * mb * 4, t,
                           f"block gather {K}x{mb}x{mb}")
        out[f"block_{mb}"] = dict(ms=t * 1e3, gbs=nb / t / 1e9)
        print(f"  block gather ({K}x{mb}x{mb}): {t * 1e3:.3f} ms -> {rate}",
              flush=True)
    for mb, B in rows:
        u = _randn((B, mb), dev)
        ids = torch.as_tensor(rng.integers(0, B, B), dtype=IDX, device=dev)
        t = per_call_s(lambda: u[ids], dev, reps)
        nb = B * (8 + 2 * mb * 4)
        rate = check_bytes(nb, nb + B * mb * 4, t, f"row gather {B}x{mb}")
        out[f"row_{mb}"] = dict(ms=t * 1e3, gbs=nb / t / 1e9)
        print(f"  row gather ({B}x{mb}): {t * 1e3:.3f} ms -> {rate}",
              flush=True)
    return out


def sec_scatter(dev, N=32 << 20, Ks=(1 << 20, 8 << 20), reps=REPS) -> dict:
    print("== sorted, unique, non-atomic Fx[dst] += v ==", flush=True)
    rng = np.random.default_rng(0)
    out = {}
    for K in Ks:
        x = torch.zeros(N, dtype=torch.float32, device=dev)
        d = torch.as_tensor(np.sort(rng.choice(N, K, replace=False)),
                            dtype=IDX, device=dev)
        v = _randn(K, dev)

        def step():
            x[d] += v
        t = per_call_s(step, dev, reps)
        nb = K * (8 + 4 * 3)           # index, x[d] and v read, x[d] written
        rate = check_bytes(nb, nb, t, f"scatter-add {K}")
        out[K] = dict(ms=t * 1e3, gbs=nb / t / 1e9)
        print(f"  scatter-add {K / 2**20:g}M into {N / 2**20:g}M: "
              f"{t * 1e3:.3f} ms -> {rate}", flush=True)
    return out


def sec_segsum(dev, L=32 << 20, K=8 << 20, reps=REPS) -> dict:
    from ..cholesky.super_numeric import segment_sum
    print("== sorted segment_sum ==", flush=True)
    rng = np.random.default_rng(0)
    lens = torch.as_tensor(np.bincount(rng.integers(0, K, L), minlength=K),
                           dtype=IDX, device=dev)
    v = _randn(L, dev)
    t = per_call_s(lambda: segment_sum(v, lens), dev, reps)
    nb = L * 4 + K * (8 + 4)           # values and lengths read, sums written
    rate = check_bytes(nb, nb, t, "segment_sum")
    print(f"  segment_sum {L / 2**20:g}M->{K / 2**20:g}M: {t * 1e3:.3f} ms "
          f"-> {rate}", flush=True)
    return dict(ms=t * 1e3, gbs=nb / t / 1e9)


def sec_project(dev, cases=((64, 4, 256, 128), (8, 4, 1024, 512),
                            (2, 4, 2048, 1024), (256, 8, 64, 32)),
                reps=REPS) -> dict:
    print("== one-hot frame projection (pair placement) ==", flush=True)
    rng = np.random.default_rng(0)
    out = {}
    for Btp, G, Mft, mb in cases:
        U = _randn((Btp * G, mb, mb), dev)
        csel = torch.as_tensor(rng.integers(0, Btp * G, (Btp, G)), dtype=IDX,
                               device=dev)
        idxf = np.full((Btp, G, Mft), mb, dtype=np.int64)
        for k in range(Btp):
            for g in range(G):
                pos = np.sort(rng.choice(Mft, mb, replace=False))
                idxf[k, g, pos] = np.arange(mb)
        idxf = torch.as_tensor(idxf, device=dev)
        mcols = torch.arange(mb, device=dev)

        def project():
            Uc = U[csel]                               # (Btp, G, mb, mb)
            Wh = (idxf[..., None] == mcols).to(U.dtype)
            if mb <= 256:
                R = Wh @ Uc
            else:
                Ucz = torch.cat([Uc, Uc.new_zeros((Btp, G, 1, mb))], dim=2)
                R = torch.gather(Ucz, 2,
                                 idxf[..., None].expand(Btp, G, Mft, mb))
            return torch.einsum("pgfm,pghm->pfh", R, Wh)
        with matmul_precision("highest"):
            t = per_call_s(project, dev, reps)
        fl = 2 * Btp * G * Mft * mb * (Mft + (mb if mb <= 256 else 0))
        rate = check_peak(fl / t, "float32", f"project {Btp}x{G}x{Mft}x{mb}")
        out[f"{Btp}x{G}x{Mft}x{mb}"] = dict(ms=t * 1e3, gflops=rate / 1e9)
        print(f"  project Btp={Btp} G={G} Mft={Mft} mb={mb}: {t * 1e3:.3f} "
              f"ms -> {rate / 1e9:,.0f} GFLOP/s", flush=True)
    return out


def spd_batch(W: int, Np: int, dev, seed: int = 0) -> torch.Tensor:
    """A seeded (W, Np, Np) float32 SPD batch: M M^T / Np + I."""
    M = _randn((W, Np, Np), dev, seed=seed)
    return M @ M.transpose(1, 2) / Np + torch.eye(Np, device=dev)


def sec_chol(dev, cases=((512, 128, 128), (8, 1024, 1024), (1, 2048, 2048)),
             reps=REPS) -> dict:
    from ..cholesky.super_numeric import syrk
    print("== batched POTRF / TRSM / SYRK ==", flush=True)
    out = {}
    with matmul_precision("highest"):
        for W, Np, Mb in cases:
            A = spd_batch(W, Np, dev)
            B = _randn((W, Mb, Np), dev, seed=1)
            C = torch.linalg.cholesky_ex(A)[0]
            Ct = C.transpose(1, 2)
            row = {}
            for nm, fn, fl in (
                    ("potrf", lambda: torch.linalg.cholesky_ex(A), W * Np ** 3
                     / 3),
                    ("trsm", lambda: torch.linalg.solve_triangular(
                        Ct, B, upper=True, left=False), W * Mb * Np * Np),
                    ("syrk", lambda: syrk(B), 2 * W * Mb * Mb * Np)):
                t = per_call_s(fn, dev, reps)
                rate = check_peak(fl / t, "float32", f"{nm} ({W},{Np},{Mb})")
                row[nm] = dict(ms=t * 1e3, gflops=rate / 1e9)
                print(f"  {nm:5s} ({W},{Mb}x{Np}): {t * 1e3:.3f} ms -> "
                      f"{rate / 1e9:,.0f} GFLOP/s", flush=True)
            out[f"{W}x{Np}x{Mb}"] = row
    return out


SECTIONS = dict(roofline=sec_roofline, slice=sec_slice, gather=sec_gather,
                scatter=sec_scatter, segsum=sec_segsum, project=sec_project,
                chol=sec_chol)


def main(sections=("all",), device=None) -> dict:
    """Run the named sections (default all) on ``device`` (the card unless
    "cpu" is asked for) at the reference's sizes; returns their numbers."""
    dev = resolve_device(device)
    names = list(SECTIONS) if list(sections) == ["all"] else list(sections)
    print(f"device={dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else " (host times; no device rate)"), flush=True)
    return {nm: SECTIONS[nm](dev) for nm in names}


if __name__ == "__main__":
    main(sys.argv[1:] or ("all",))
