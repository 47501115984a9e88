"""Device programs: the port's counterpart of the reference's ``jax.jit``
functions, each compiled once per pattern and cached with its plan.

A ``DeviceProgram`` holds a body (a function of tensors that returns a
tensor, or nested tuples and lists of them), the static input buffers the
body runs on, and the key it is cached under.  On a CUDA device the first
call

1. runs the body once eagerly on a side stream (the warm-up: the kernel
   libraries are built and loaded, each kernel's shared-memory attribute
   is set, the cuBLAS/cuSOLVER handles and workspaces are created, and the
   plan's index tensors are on the card);
2. captures the body into a ``torch.cuda.CUDAGraph`` with a memory pool of
   its own;
3. replays the graph.

Every later call copies its inputs into the static buffers and replays.
On the CPU the same object runs the body eagerly on the static buffers, so
the buffers, the keys and the cloning run the same code there.

A result handed to the caller is a clone: it never shares storage with the
graph's static output, which the next replay overwrites (the reference's
arrays are immutable, so a factor the caller holds never changes under a
later refactorization).  A failure to capture or to replay raises a
RuntimeError that names the program and its key; nothing falls back to an
eager run.

The kernel wrappers count their launches (``fn.launches``).  A replay makes
no Python call, so a program records how many launches of each counted
wrapper its capture recorded, adds that many on every replay, and leaves
the counts as they were across the warm-up and the capture.

A body may also update tensors it closes over in place (a distributed
rank's local buffer, between two collectives).  The warm-up runs such a
body once more than the caller asked, so the program is told which tensors
it updates (``mutates``): their contents are saved before the warm-up and
put back after it.  A body may return ``()`` when its effect is such an
update.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
import weakref

import torch

__all__ = ["Binding", "DeviceProgram", "cached_program", "program_device"]


def _tree_map(fn, obj):
    """``fn`` applied to every tensor of a tensor, or of nested tuples and
    lists of them."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return type(obj)(_tree_map(fn, o) for o in obj)


@contextlib.contextmanager
def _linalg_library(name, device: torch.device):
    """torch.linalg's preferred CUDA library set to ``name`` while a body
    runs on the card (a process-wide setting, restored on leaving)."""
    if name is None or device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(name)
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Node count of a captured graph (kept with ``keep_graph=True``),
    through libcuda's cuGraphGetNodes."""
    lib = ctypes.CDLL("libcuda.so.1")
    fn = lib.cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    err = fn(ctypes.c_void_p(graph.raw_cuda_graph()), None,
             ctypes.byref(count))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return int(count.value)


def _check_precision():
    """A graph records the math mode of its cuBLAS calls: float32
    products must run in full float32 before anything is captured."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "device programs capture float32 products in full float32: "
            "set torch.backends.cuda.matmul.allow_tf32 = False and the "
            "float32 matmul precision to 'highest'")


def program_device(device) -> torch.device:
    """``device`` with its index (the current card for a bare "cuda"), so
    that the keys of one card's programs are equal however it was named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceProgram:
    """One compiled device program: ``body`` over static input buffers,
    captured into a CUDA graph on the card and run eagerly on the CPU.

    name:     the program's name (error messages, statistics).
    key:      the key it is cached under.
    body:     a function of the input tensors; it may read other tensors it
              closes over (a plan's maps, a factor's buffer), which must
              outlive the program.
    device:   where it runs.
    counters: kernel wrappers with a ``launches`` count (block_chol).
    library:  torch.linalg's preferred CUDA library while the body runs on
              the card (None: PyTorch's choice).
    mutates:  tensors the body updates in place (besides its static
              inputs, which it must not change): restored after the
              warm-up, so that the first call updates them once.

    After the first call on the card: ``warmup_s`` and ``capture_s`` (host
    seconds of the warm-up and of the capture with its instantiation),
    ``nodes`` (the graph's node count) and ``graph``."""

    def __init__(self, name: str, key: tuple, body, device,
                 counters=(), library=None, mutates=()):
        self.name = name
        self.key = key
        self.body = body
        self.device = program_device(device)
        self.counters = tuple(counters)
        self.library = library
        self.mutates = tuple(mutates)
        self.static = None          # the static input buffers
        self.graph = None
        self.out = None             # the graph's static output
        self.per_replay = ()        # launches per counter a replay makes
        self.warmup_s = self.capture_s = 0.0
        self.nodes = 0

    @property
    def prepared(self) -> bool:
        return self.static is not None

    def eager(self, *inputs):
        """The body run eagerly on ``inputs`` (no capture, no copy)."""
        with _linalg_library(self.library, self.device):
            return self.body(*inputs)

    def prepare(self, *inputs) -> None:
        """Allocate the static buffers from ``inputs`` and, on the card,
        warm up and capture (once; a prepared program does nothing)."""
        if self.prepared:
            return
        for t in inputs:
            if t.device != self.device:
                raise ValueError(f"{self.name}: input on {t.device}, the "
                                 f"program runs on {self.device}")
        static = tuple(t.detach().clone() for t in inputs)
        if self.device.type == "cuda":
            try:
                self._capture(static)
            except Exception as exc:
                self.graph = self.out = None
                raise RuntimeError(f"device program {self.name} {self.key}: "
                                   f"capture failed: {exc}") from exc
        self.static = static

    def _capture(self, static) -> None:
        _check_precision()
        dev = self.device
        before = [c.launches for c in self.counters]
        try:
            t0 = time.perf_counter()
            saved = [t.clone() for t in self.mutates]
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.eager(*static)
            cur.wait_stream(side)
            for t, s in zip(self.mutates, saved):
                t.copy_(s)
            del saved
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            for c, n in zip(self.counters, before):
                c.launches = n
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                out = self.eager(*static)
            self.per_replay = tuple(c.launches - n for c, n
                                    in zip(self.counters, before))
        finally:
            for c, n in zip(self.counters, before):
                c.launches = n
        self.nodes = _graph_nodes(graph)
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.graph, self.out = graph, out
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1

    def __call__(self, *inputs):
        """The body's result on ``inputs``, cloned: a replay on the card,
        an eager run on the CPU."""
        if not self.prepared:
            self.prepare(*inputs)
        else:
            if len(inputs) != len(self.static):
                raise ValueError(f"{self.name}: {len(inputs)} inputs, the "
                                 f"program takes {len(self.static)}")
            for s, t in zip(self.static, inputs):
                if s.shape != t.shape or s.dtype != t.dtype:
                    raise ValueError(
                        f"{self.name} {self.key}: input {tuple(t.shape)} "
                        f"{t.dtype}, the program's buffer {tuple(s.shape)} "
                        f"{s.dtype}")
                s.copy_(t)
        if self.graph is None:
            return _tree_map(torch.clone, self.eager(*self.static))
        try:
            self.graph.replay()
        except Exception as exc:
            raise RuntimeError(f"device program {self.name} {self.key}: "
                               f"replay failed: {exc}") from exc
        for c, n in zip(self.counters, self.per_replay):
            c.launches += n
        return _tree_map(torch.clone, self.out)


def cached_program(cache: dict, key: tuple, make_body, device,
                   **kw) -> DeviceProgram:
    """The program cached under ``key`` in ``cache`` (a plan's or a
    factor's own ``_cache``, so that it is freed with it), made with the
    body ``make_body()`` on first use.  ``key[0]`` names the program."""
    prog = cache.get(key)
    if prog is None:
        prog = cache[key] = DeviceProgram(key[0], key, make_body(), device,
                                          **kw)
    return prog


@dataclasses.dataclass
class Binding:
    """Whose values a plan's static buffers hold, when programs read a
    factor as data (the reference passes it as an argument): a weak
    reference to the object copied in and the in-place versions of its
    tensors at the copy, so that the next copy is skipped only for the
    same object with the same values."""

    owner: object = None
    versions: tuple = ()

    def holds(self, obj, *tensors) -> bool:
        return (self.owner is not None and self.owner() is obj
                and tuple(t._version for t in tensors) == self.versions)

    def set(self, obj, *tensors) -> None:
        self.owner = weakref.ref(obj)
        self.versions = tuple(t._version for t in tensors)

    def clear(self) -> None:
        self.owner, self.versions = None, ()
