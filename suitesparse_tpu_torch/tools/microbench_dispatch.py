"""Dispatch-floor probes on the card: the counterpart of
tools/microbench_dispatch.py.

    python3 -m suitesparse_tpu_torch.tools.microbench_dispatch

prints, in the reference tool's order:

  chainK      K dependent ``x * 1.0000001`` on one (8, 128) float32 tile,
              K in {1, 64, 256}.  XLA fuses the chain into one kernel;
              eager PyTorch launches K kernels, so the line is the per-op
              cost that the port's Python factor loop pays.
  cholesky W  one batched ``torch.linalg.cholesky`` of (W, 128, 128) 2·I,
  trsm W      one batched ``torch.linalg.solve_triangular`` (X A = ones),
              W in {1, 64}: library calls, as in the reference.
  kernel G    ``scale_blocks``: the hand-written kernel of
              ``csrc/dispatch_probe.cu`` over G blocks of 512 x 128 floats
              (the counterpart of the Pallas ``kernel``), G in {64, 256};
  gathered G  ``scale_gather``: the same through a device offset table (the
              counterpart of the Pallas ``vmk``, the cost per instruction
              of a "VM" that reads its operands by offset).

Each line's first time is the reference's ``run()``: one warm call, then
20 calls on the host clock, ended by a readback of one element.  The two
kernels' lines add their device time over 20 launches queued back to
back behind a spin kernel (CUDA events), cycling through copies of the
buffer that together exceed the L2 cache, with
SPLIT thread blocks a grid step and with one (the TPU's grid), the time
per block, and the time of ``torch.mul(buf, 1.0000001)``, the library call
that computes the same function (for the gathered form because the
offsets cover every row).  The G thread blocks of a launch run
concurrently over the SMs, so a time per block is a share of one launch,
not a serial cost per grid step as on the TPU.  A last line, beyond the
reference's, gives the launch floors: a one-block launch of the kernel
and of torch.mul on the host clock, beside the eager op of ``chain1``.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import resolve_device

__all__ = ["SCALE", "GatherTable", "chain", "main", "scale_blocks",
           "scale_blocks_plain", "scale_gather", "scale_gather_plain"]

SCALE = 1.0000001          # rounds to the float32 1 + 2**-23
ROWS, COLS = 512, 128      # one block: one grid step of the TPU kernels
CHAIN_K = (1, 64, 256)
BATCH_W = (1, 64)
GRID_G = (64, 256)
REPS = 20
# thread blocks a grid step: a launch choice, not semantics.  One block a
# step (the TPU's grid) leaves 68 of the 132 SMs idle at G = 64; four
# fill the card at both grid sizes
SPLIT = 4
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
HOLD_CYCLES = 10_000_000   # ~5 ms of spinning at the H100's ~2 GHz clock
COLD_BYTES = 200_000_000   # 4x the H100's 50 MB L2 cache

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = cuda_build.load("dispatch_probe")
        lib.sstpu_scale_blocks_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.sstpu_scale_gather_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.sstpu_scale_blocks_f32, lib.sstpu_scale_gather_f32):
            fn.restype = ctypes.c_int
        lib.sstpu_probe_error_string.argtypes = [ctypes.c_int]
        lib.sstpu_probe_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_buf(buf: torch.Tensor, what: str) -> None:
    if buf.dim() != 2 or buf.shape[1] != COLS or buf.shape[0] % ROWS:
        raise ValueError(f"{what}: buf must be (G * {ROWS}, {COLS}), got "
                         f"{tuple(buf.shape)}")
    if buf.dtype != torch.float32:
        raise TypeError(f"{what}: buf must be float32, got {buf.dtype}")
    if not buf.is_contiguous():
        raise ValueError(f"{what}: buf must be contiguous")
    if buf.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: buf has too many rows for int offsets")


def _launch(fn, name: str, *args) -> None:
    lib = _kernel_lib()
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           + lib.sstpu_probe_error_string(err).decode())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- the two kernels ---------------------------------------------------------

def scale_blocks_plain(buf: torch.Tensor, G: int) -> torch.Tensor:
    """Plain PyTorch ``scale_blocks``."""
    _check_buf(buf, "scale_blocks")
    if buf.shape[0] != G * ROWS:
        raise ValueError(f"scale_blocks: buf has {buf.shape[0]} rows, not "
                         f"G * {ROWS} = {G * ROWS}")
    return buf * SCALE


def scale_blocks(buf: torch.Tensor, G: int,
                 split: int = SPLIT) -> torch.Tensor:
    """out = buf * 1.0000001 over the (G * 512, 128) float32 buffer, one
    grid step per 512-row block.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (``split`` thread blocks a step: 1, 2,
    4, 8 or 16) or raises."""
    if buf.device.type == "cpu":
        return scale_blocks_plain(buf, G)
    if buf.device.type != "cuda":
        raise ValueError(f"scale_blocks: unsupported device {buf.device}")
    _check_buf(buf, "scale_blocks")
    if buf.shape[0] != G * ROWS:
        raise ValueError(f"scale_blocks: buf has {buf.shape[0]} rows, not "
                         f"G * {ROWS} = {G * ROWS}")
    out = torch.empty_like(buf)
    if G == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(buf.device):
        _launch(lib.sstpu_scale_blocks_f32, "scale_blocks", buf.data_ptr(),
                out.data_ptr(), G, split, _stream(buf))
    scale_blocks.launches += 1
    return out


scale_blocks.launches = 0


class GatherTable:
    """The offset table of the gathered probe, checked once on the host:
    one-dimensional integers, every window [o, o + 512) inside the
    buffer's ``rows`` and no two windows overlapping (on the card the grid
    steps run concurrently, so overlapping windows would race where the
    TPU's last step won).  Anything else raises ValueError.  The offsets
    are uploaded once per device."""

    def __init__(self, offs, rows: int):
        o = np.asarray(offs)
        if o.ndim != 1 or not (o.size == 0
                               or np.issubdtype(o.dtype, np.integer)):
            raise ValueError("scale_gather: offsets must be a 1-D integer "
                             "array")
        if rows < ROWS or rows >= 2 ** 31:
            raise ValueError(f"scale_gather: {rows} rows is out of range")
        if o.size and (o.min() < 0 or o.max() > rows - ROWS):
            raise ValueError(f"scale_gather: an offset window [o, o + {ROWS})"
                             f" leaves the buffer's {rows} rows")
        if np.any(np.diff(np.sort(o)) < ROWS):
            raise ValueError(f"scale_gather: offset windows of {ROWS} rows "
                             "overlap")
        self.offs = o.astype(np.int32)
        self.rows = int(rows)
        self._dev: dict = {}

    def __len__(self) -> int:
        return len(self.offs)

    def device_offsets(self, device: torch.device) -> torch.Tensor:
        key = ("offs", device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.offs, device=device)
        return self._dev[key]

    def row_index(self, device: torch.device) -> torch.Tensor:
        """The rows the offsets name, as int64 indices (plain version)."""
        key = ("rows", device)
        if key not in self._dev:
            idx = (self.offs.astype(np.int64)[:, None]
                   + np.arange(ROWS)).reshape(-1)
            self._dev[key] = torch.as_tensor(idx, device=device)
        return self._dev[key]


def _table(offs, buf: torch.Tensor) -> GatherTable:
    _check_buf(buf, "scale_gather")
    if isinstance(offs, torch.Tensor) and offs.device.type != "cpu":
        raise ValueError("scale_gather: offsets must be a host array (they "
                         "are checked on the host)")
    table = offs if isinstance(offs, GatherTable) else GatherTable(
        np.asarray(offs), buf.shape[0])
    if table.rows != buf.shape[0]:
        raise ValueError(f"scale_gather: the table was checked for "
                         f"{table.rows} rows, buf has {buf.shape[0]}")
    return table


def scale_gather_plain(offs, buf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``scale_gather``."""
    table = _table(offs, buf)
    out = torch.empty_like(buf)
    idx = table.row_index(buf.device)
    out[idx] = buf[idx] * SCALE
    return out


def scale_gather(offs, buf: torch.Tensor,
                 split: int = SPLIT) -> torch.Tensor:
    """For each offset o of ``offs`` (a host array, or a GatherTable
    checked once): rows [o, o + 512) of out = the same rows of buf times
    1.0000001.  Rows that no offset names are left as ``torch.empty``
    gives them.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if buf.device.type == "cpu":
        return scale_gather_plain(offs, buf)
    if buf.device.type != "cuda":
        raise ValueError(f"scale_gather: unsupported device {buf.device}")
    table = _table(offs, buf)
    out = torch.empty_like(buf)
    G = len(table)
    if G == 0:
        return out
    lib = _kernel_lib()
    d_offs = table.device_offsets(buf.device)
    with torch.cuda.device(buf.device):
        _launch(lib.sstpu_scale_gather_f32, "scale_gather", d_offs.data_ptr(),
                buf.data_ptr(), out.data_ptr(), G, table.rows, split,
                _stream(buf))
    scale_gather.launches += 1
    return out


scale_gather.launches = 0


# -- the probe ----------------------------------------------------------------

def chain(x: torch.Tensor, K: int) -> torch.Tensor:
    """K dependent ``x * 1.0000001``: K launches in eager PyTorch."""
    for _ in range(K):
        x = x * SCALE
    return x


def readback(x: torch.Tensor) -> float:
    return float(x.reshape(-1)[0])


def run(fn, *args, reps: int = REPS, **kw) -> float:
    """The reference's timing: one warm call and its readback, then
    ``reps`` calls on the host clock ended by one readback; s per call."""
    out = fn(*args, **kw)
    readback(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
    readback(out)
    return (time.perf_counter() - t0) / reps


def device_time(fn, arg_sets, reps: int = REPS, *,
                hold_cycles: int = HOLD_CYCLES, **kw) -> float:
    """s per call of ``reps`` back-to-back calls on the device's clock
    (CUDA events), cycling through ``arg_sets`` (tuples of arguments).  A
    spin kernel of ``hold_cycles`` holds the stream while the host
    enqueues the calls, so the events time the device's work back to
    back, not the host's enqueue rate (a launch through ctypes costs the
    host ~20 us, longer than a small kernel runs).  Raises RuntimeError if
    the host took longer to enqueue the calls than the spin ran: the
    events would then time the host again."""
    for args in arg_sets:
        fn(*args, **kw)
    torch.cuda.synchronize()
    es, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t0 = time.perf_counter()
    es.record()
    torch.cuda._sleep(hold_cycles)
    e0.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)], **kw)
    e1.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = es.elapsed_time(e0)
    if host_ms >= spin_ms:
        raise RuntimeError(f"device_time: enqueueing {reps} calls took "
                           f"{host_ms:.2f} ms, longer than the "
                           f"{spin_ms:.2f} ms spin")
    return e0.elapsed_time(e1) / 1e3 / reps


def cold_buffers(G: int, device) -> list:
    """Distinct (G * 512, 128) float32 buffers that, each read and written
    once in turn, move more than COLD_BYTES: a timed call then finds its
    data in device memory, not left in the 50 MB L2 cache by the call
    before (G = 64 moves 33.5 MB, which would stay in L2)."""
    n = -(-COLD_BYTES // (2 * G * ROWS * COLS * 4))
    return [torch.ones((G * ROWS, COLS), dtype=torch.float32, device=device)
            for _ in range(n)]


def bound_s(G: int, gathered: bool = False) -> float:
    """Least time on an H100 SXM: each block read once and written once
    (and the offset table read once), over the HBM rate."""
    nbytes = 2 * G * ROWS * COLS * 4 + (4 * G if gathered else 0)
    return nbytes / PEAK_BYTES


def main(device=None, grids=GRID_G, reps: int = REPS) -> dict:
    """Run the probe on ``device`` (the card unless "cpu" is asked for;
    on the CPU the kernels' plain versions run and no device time is
    taken), print its lines and return its numbers in seconds."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    res: dict = dict(chain={}, cholesky={}, trsm={}, kernel={}, gathered={})

    x = torch.ones((8, COLS), dtype=torch.float32, device=dev)
    for K in CHAIN_K:
        t = run(chain, x, K, reps=reps)
        res["chain"][K] = t
        print(f"chain{K:4d}: {t * 1e6:9.1f} us ({t / K * 1e6:.2f} us/op)",
              flush=True)

    for W in BATCH_W:
        A = (2.0 * torch.eye(128, dtype=torch.float32, device=dev)).expand(
            W, 128, 128).contiguous()
        t = run(torch.linalg.cholesky, A, reps=reps)
        res["cholesky"][W] = t
        print(f"cholesky W={W:3d}: {t * 1e6:9.1f} us", flush=True)
        B = torch.ones((W, 128, 128), dtype=torch.float32, device=dev)
        t = run(lambda C, B: torch.linalg.solve_triangular(
            C, B, upper=False, left=False), A, B, reps=reps)
        res["trsm"][W] = t
        print(f"trsm     W={W:3d}: {t * 1e6:9.1f} us", flush=True)

    for key in ("kernel", "gathered"):
        for G in grids:
            bufs = cold_buffers(G, dev) if on_card else [torch.ones(
                (G * ROWS, COLS), dtype=torch.float32, device=dev)]
            if key == "kernel":
                fn, arg_sets = scale_blocks, [(b, G) for b in bufs]
            else:
                fn = scale_gather
                table = GatherTable(np.arange(G)[::-1] * ROWS, G * ROWS)
                arg_sets = [(table, b) for b in bufs]
            t = run(fn, *arg_sets[0], reps=reps)
            row = dict(host_s=t, bound_s=bound_s(G, key == "gathered"))
            if on_card:
                row["device_s"] = device_time(fn, arg_sets, reps=reps)
                row["device_s_split1"] = device_time(fn, arg_sets, split=1,
                                                     reps=reps)
                row["mul_s"] = device_time(torch.mul,
                                           [(b, SCALE) for b in bufs],
                                           reps=reps)
            res[key][G] = row
            mb = f" ({G * ROWS * COLS * 4 >> 20} MB)" if key == "kernel" else ""
            print(f"{key} G={G:4d}{mb}: {t * 1e6:9.1f} us "
                  f"({t / G * 1e6:6.2f} us/block); device "
                  f"{_fmt(row.get('device_s'), G)}, one block a step "
                  f"{_fmt(row.get('device_s_split1'), G)}; torch.mul "
                  f"{_fmt(row.get('mul_s'), G)}; bound "
                  f"{row['bound_s'] * 1e6:.1f} us", flush=True)

    # the launch floors: the host clock of run() over one-block calls is
    # the host's cost of a call (the device finishes each sooner), beside
    # an eager op's (chain1); the device times are warm, one block
    buf = torch.ones((ROWS, COLS), dtype=torch.float32, device=dev)
    floor = dict(kernel_host_s=run(scale_blocks, buf, 1, split=1, reps=reps),
                 mul_host_s=run(torch.mul, buf, SCALE, reps=reps))
    if on_card:
        floor["kernel_device_s"] = device_time(scale_blocks, [(buf, 1)],
                                               split=1, reps=reps)
        floor["mul_device_s"] = device_time(torch.mul, [(buf, SCALE)],
                                            reps=reps)
    res["floor"] = floor
    print(f"launch floor G=   1: scale_blocks {floor['kernel_host_s'] * 1e6:.1f}"
          f" us a call (device {_fmt(floor.get('kernel_device_s'), 1)}); "
          f"torch.mul {floor['mul_host_s'] * 1e6:.1f} us a call (device "
          f"{_fmt(floor.get('mul_device_s'), 1)}); eager op "
          f"{res['chain'][CHAIN_K[0]] / CHAIN_K[0] * 1e6:.1f} us", flush=True)
    return res


def _fmt(s, G) -> str:
    if s is None:
        return "not measured (cpu)"
    return f"{s * 1e6:.2f} us ({s / G * 1e6:.3f} us/block)"


if __name__ == "__main__":
    main()
