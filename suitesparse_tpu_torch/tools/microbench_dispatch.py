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
20 calls on the host clock, ended by a readback of one element; the two
kernels' lines give ``torch.mul(buf, 1.0000001)``'s the same way, the
library call that computes the same function (for the gathered form
because the offsets cover every row).  They add their device time over
20 launches queued back to back behind a spin kernel (CUDA events),
cycling through copies of the buffer that together exceed the L2 cache,
the time per block, and torch.mul's device time taken the same way.  The
G blocks of a launch run concurrently over the SMs, so a time per block
is a share of one launch, not a serial cost per grid step as on the TPU.
Two lines go beyond the reference:

  launch floor  one-block launches of both kernels and of torch.mul on
                the host clock (run()) and on the device's, beside the
                eager op of ``chain1``;
  launch route  where the host time of a one-block ``scale_blocks`` goes,
                in us a call over 1000 calls: its checks, torch.empty_like,
                the current stream's raw handle, the ctypes call (at G = 0,
                which returns before any CUDA call, and at G = 1, with the
                C side's launch), the whole wrapper, and torch.mul; beside
                them what the route no longer does, a
                ``torch.cuda.device`` guard and a ``torch.cuda.Stream``
                lookup.  Every kernel of the port launches through this
                route (``utils.cuda_build.launch``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import resolve_device

__all__ = ["SCALE", "GatherTable", "chain", "main", "scale_blocks",
           "scale_blocks_plain", "scale_gather", "scale_gather_plain",
           "sparse_offsets"]

SCALE = 1.0000001          # rounds to the float32 1 + 2**-23
ROWS, COLS = 512, 128      # one block: one grid step of the TPU kernels
CHAIN_K = (1, 64, 256)
BATCH_W = (1, 64)
GRID_G = (64, 256)
REPS = 20
ROUTE_CALLS = 1000         # calls a piece of the launch route is timed over
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
HOLD_CYCLES = 10_000_000   # ~5 ms of spinning at the H100's ~2 GHz clock
COLD_BYTES = 200_000_000   # 4x the H100's 50 MB L2 cache


def _check_buf(buf: torch.Tensor, what: str) -> None:
    shape = buf.shape
    if len(shape) != 2 or shape[1] != COLS or shape[0] % ROWS:
        raise ValueError(f"{what}: buf must be (G * {ROWS}, {COLS}), got "
                         f"{tuple(shape)}")
    if buf.dtype != torch.float32:
        raise TypeError(f"{what}: buf must be float32, got {buf.dtype}")
    if not buf.is_contiguous():
        raise ValueError(f"{what}: buf must be contiguous")
    if shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: buf has too many rows for int offsets")


def _check_blocks(buf: torch.Tensor, G: int) -> None:
    # one test on the launch path; the reason is found only on failure
    if (buf.shape != (G * ROWS, COLS) or buf.dtype != torch.float32
            or not buf.is_contiguous() or G * ROWS >= 2 ** 31):
        _check_buf(buf, "scale_blocks")
        raise ValueError(f"scale_blocks: buf has {buf.shape[0]} rows, not "
                         f"G * {ROWS} = {G * ROWS}")


# -- the two kernels ---------------------------------------------------------

def scale_blocks_plain(buf: torch.Tensor, G: int) -> torch.Tensor:
    """Plain PyTorch ``scale_blocks``."""
    _check_blocks(buf, G)
    return buf * SCALE


def scale_blocks(buf: torch.Tensor, G: int) -> torch.Tensor:
    """out = buf * 1.0000001 over the (G * 512, 128) float32 buffer, one
    grid step per 512-row block.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if not buf.is_cuda:
        if buf.device.type != "cpu":
            raise ValueError(f"scale_blocks: unsupported device {buf.device}")
        return scale_blocks_plain(buf, G)
    _check_blocks(buf, G)
    out = torch.empty_like(buf)
    if G:
        cuda_build.launch("sstpu_scale_blocks_f32", buf, buf.data_ptr(),
                          out.data_ptr(), G)
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


def sparse_offsets(rng: np.random.Generator, G: int) -> np.ndarray:
    """A table that leaves rows uncovered, for checks: max(1, G // 2)
    windows at unaligned, non-overlapping offsets in a buffer of G
    blocks, in random order (at G = 1 the one window covers it)."""
    k = max(1, G // 2)
    cuts = np.sort(rng.integers(0, (G - k) * ROWS + 1, size=k))
    return rng.permutation(cuts + np.arange(k) * ROWS).astype(np.int32)


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


def scale_gather(offs, buf: torch.Tensor) -> torch.Tensor:
    """For each offset o of ``offs`` (a host array, or a GatherTable
    checked once): rows [o, o + 512) of out = the same rows of buf times
    1.0000001.  Rows that no offset names are left as ``torch.empty``
    gives them.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if not buf.is_cuda:
        if buf.device.type != "cpu":
            raise ValueError(f"scale_gather: unsupported device {buf.device}")
        return scale_gather_plain(offs, buf)
    table = _table(offs, buf)
    out = torch.empty_like(buf)
    G = len(table)
    if G:
        cuda_build.launch("sstpu_scale_gather_f32", buf,
                          table.device_offsets(buf.device).data_ptr(),
                          buf.data_ptr(), out.data_ptr(), G, table.rows)
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
    back, not the host's enqueue rate (a launch costs the host longer
    than a small kernel runs).  Raises RuntimeError if
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


def host_per_call(fn, *args, calls: int = ROUTE_CALLS) -> float:
    """s per call of ``fn(*args)`` on the host clock over ``calls`` calls,
    after one warm call, between two device syncs."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls


def _device_guard(buf: torch.Tensor) -> None:
    with torch.cuda.device(buf.device):
        pass


def launch_route(buf: torch.Tensor) -> dict:
    """Where the host time of a one-block ``scale_blocks`` goes: each piece
    of its launch, timed alone, in s a call (see the module's doc)."""
    dev = buf.get_device()
    fn = cuda_build.bind("sstpu_scale_blocks_f32")[0]
    out = torch.empty_like(buf)    # held: the direct launches write it
    in_p, out_p = buf.data_ptr(), out.data_ptr()
    stream = cuda_build.raw_stream(dev)
    return dict(
        checks_s=host_per_call(_check_blocks, buf, 1),
        empty_like_s=host_per_call(torch.empty_like, buf),
        raw_stream_s=host_per_call(cuda_build.raw_stream, dev),
        ctypes_call_s=host_per_call(fn, in_p, out_p, 0, dev, stream),
        c_launch_s=host_per_call(fn, in_p, out_p, 1, dev, stream),
        scale_blocks_s=host_per_call(scale_blocks, buf, 1),
        mul_s=host_per_call(torch.mul, buf, SCALE),
        stream_object_s=host_per_call(
            lambda: torch.cuda.current_stream(buf.device).cuda_stream),
        device_guard_s=host_per_call(_device_guard, buf))


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
            row = dict(host_s=t, bound_s=bound_s(G, key == "gathered"),
                       mul_host_s=run(torch.mul, bufs[0], SCALE, reps=reps))
            if on_card:
                row["device_s"] = device_time(fn, arg_sets, reps=reps)
                row["mul_s"] = device_time(torch.mul,
                                           [(b, SCALE) for b in bufs],
                                           reps=reps)
            res[key][G] = row
            mb = f" ({G * ROWS * COLS * 4 >> 20} MB)" if key == "kernel" else ""
            print(f"{key} G={G:4d}{mb}: {t * 1e6:9.1f} us "
                  f"({t / G * 1e6:6.2f} us/block), torch.mul "
                  f"{row['mul_host_s'] * 1e6:.1f} us; device "
                  f"{_fmt(row.get('device_s'), G)}; torch.mul "
                  f"{_fmt(row.get('mul_s'), G)}; bound "
                  f"{row['bound_s'] * 1e6:.1f} us", flush=True)

    # the launch floors: the host clock of run() over one-block calls is
    # the host's cost of a call (the device finishes each sooner), beside
    # an eager op's (chain1); the device times are warm, one block
    buf = torch.ones((ROWS, COLS), dtype=torch.float32, device=dev)
    table = GatherTable([0], ROWS)
    floor = dict(kernel_host_s=run(scale_blocks, buf, 1, reps=reps),
                 gather_host_s=run(scale_gather, table, buf, reps=reps),
                 mul_host_s=run(torch.mul, buf, SCALE, reps=reps))
    if on_card:
        floor["kernel_device_s"] = device_time(scale_blocks, [(buf, 1)],
                                               reps=reps)
        floor["gather_device_s"] = device_time(scale_gather, [(table, buf)],
                                               reps=reps)
        floor["mul_device_s"] = device_time(torch.mul, [(buf, SCALE)],
                                            reps=reps)
    res["floor"] = floor
    print(f"launch floor G=   1: scale_blocks {floor['kernel_host_s'] * 1e6:.1f}"
          f" us a call (device {_fmt(floor.get('kernel_device_s'), 1)}); "
          f"scale_gather {floor['gather_host_s'] * 1e6:.1f} us a call (device "
          f"{_fmt(floor.get('gather_device_s'), 1)}); "
          f"torch.mul {floor['mul_host_s'] * 1e6:.1f} us a call (device "
          f"{_fmt(floor.get('mul_device_s'), 1)}); eager op "
          f"{res['chain'][CHAIN_K[0]] / CHAIN_K[0] * 1e6:.1f} us", flush=True)

    if not on_card:
        res["route"] = None
        print("launch route (host us a call): not measured (cpu)", flush=True)
        return res
    route = res["route"] = launch_route(buf)
    us = {k: f"{v * 1e6:.2f}" for k, v in route.items()}
    print(f"launch route (host us a call, {ROUTE_CALLS} calls): checks "
          f"{us['checks_s']}, torch.empty_like {us['empty_like_s']}, raw "
          f"stream {us['raw_stream_s']}, ctypes call {us['ctypes_call_s']}"
          f" (with the launch in C {us['c_launch_s']}); "
          f"scale_blocks G=1 {us['scale_blocks_s']}; torch.mul "
          f"{us['mul_s']}; not on the route: torch.cuda.Stream lookup "
          f"{us['stream_object_s']}, torch.cuda.device guard "
          f"{us['device_guard_s']}", flush=True)
    return res


def _fmt(s, G) -> str:
    if s is None:
        return "not measured (cpu)"
    return f"{s * 1e6:.2f} us ({s / G * 1e6:.3f} us/block)"


if __name__ == "__main__":
    main()
