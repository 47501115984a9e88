"""The pf extend-add kernel (``cholesky/pf.extend_add``,
``csrc/pf_extend_add.cu``) against its plain version, and timed over one
factor's pair instructions beside its byte bound.

    python -m suitesparse_tpu_torch.tools.bench_extend_add [matrix]

holds the kernel against ``extend_add_plain`` at the pair-class shapes
``SHAPES`` (G = 1, 2 and 16 classes of lap3d_64) in float32 and float64,
with and without the bfloat16 placement, then builds the matrix's pf plan
(default lap3d_64), holds the kernel against the plain version on every
pair instruction of it (``check_plan``), and prints one JSON line:
every pair instruction of one factor launched in stream order on a random
buffer, captured into a CUDA graph and replayed (``kernel_ms``: CUDA
events over ``REPS`` replays, the gaps between launches included); the
plain version over the same instructions (``plain_ms``, host clock ended
by a sync); and the least time the card could take (``bound_ms``): each
child value placed read once and each parent entry it reaches read and
written once, with the row maps, over 3.35 TB/s.  What the card tests and
``chip_smoke.py`` share lives here too: ``case`` (random operands at a
class's shape), ``check`` (kernel against plain, bit for bit, and a
repeat) and ``check_plan``.  Needs the card.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..cholesky.pf import extend_add, extend_add_launches, extend_add_plain

__all__ = ["SHAPES", "case", "check", "check_plan", "main", "plan_bound_bytes",
           "time_plan"]

PEAK_BYTES = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
REPS = 20
TOP_CLASSES = 12           # pair classes listed by their kernel time
# (Pq, G, Mbc, Npt, Mbt) of pair classes at lap3d_64: the largest G = 1
# class (3 instructions, the top separator), a G = 1 class with an update
# slot and one with four parents, the largest G = 2 one, and one of many
# parents with G = 16 small children
SHAPES = ((1, 1, 3840, 7936, 0), (1, 1, 2816, 1024, 3840),
          (4, 1, 2048, 512, 2560), (1, 2, 2560, 768, 3584),
          (8, 16, 32, 128, 128))


def case(rng, Pq, G, Mbc, Npt, Mbt, dtype=torch.float32, device="cuda"):
    """Random operands of one pair instruction: a flat buffer holding the
    Pq * G child slabs, then the Pq parent panels and slots; each child
    reaches between Mbc / 2 and Mbc frame rows at random places.  As in a
    plan, parent 0 has one real child when G > 1 (the others all pads,
    reading child 0's slab), the last parent's slot is dropped (offset
    -1) when Pq > 1, and the one before's panel too when Pq > 2.  Returns
    (Fx, idxf, coff, pdst, udst)."""
    Mft = Npt + Mbt
    idxf = np.full((Pq, G, Mft), Mbc, dtype=np.int32)
    for p in range(Pq):
        for g in range(1 if (p == 0 and G > 1) else G):
            mb = int(rng.integers(Mbc // 2, Mbc + 1))
            at = np.sort(rng.choice(Mft, mb, replace=False))
            idxf[p, g, at] = np.arange(mb, dtype=np.int32)
    slab = Mbc * Mbc
    coff = np.arange(Pq * G, dtype=np.int64).reshape(Pq, G) * slab
    coff[0, 1:] = coff[0, 0]
    p0 = Pq * G * slab
    pdst = p0 + np.arange(Pq, dtype=np.int64) * Mft * Npt
    u0 = p0 + Pq * Mft * Npt
    udst = u0 + np.arange(Pq, dtype=np.int64) * Mbt * Mbt
    if Pq > 1:
        udst[-1] = -1
    if Pq > 2:
        pdst[-2] = -1
    n = u0 + Pq * Mbt * Mbt
    Fx = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=device)
    dev = Fx.device
    return (Fx, torch.as_tensor(idxf, device=dev),
            torch.as_tensor(coff, device=dev),
            torch.as_tensor(pdst, device=dev),
            torch.as_tensor(udst, device=dev) if Mbt else None)


def check(rng, shape, dtype, bf16=False) -> dict:
    """The kernel against ``extend_add_plain`` at one class shape: equal
    bit for bit (the same gathers, and the children summed in the same
    order), a repeat equal too, and one launch counted.  Raises on a
    difference."""
    Pq, G, Mbc, Npt, Mbt = shape
    Fx, idxf, coff, pdst, udst = case(rng, *shape, dtype=dtype)
    args = (idxf, coff, pdst, udst, Mbc, Npt, Mbt, bf16)
    plain = Fx.clone()
    extend_add_plain(plain, *args)
    before = extend_add.launches
    got = [Fx.clone(), Fx.clone()]
    for g in got:
        extend_add(g, *args)
    torch.cuda.synchronize()
    if extend_add.launches - before != 2:
        raise RuntimeError("extend_add: launches not counted")
    moved = int((plain != Fx).sum())
    if not (torch.equal(got[0], plain) and torch.equal(got[1], got[0])):
        bad = int((got[0] != plain).sum())
        raise RuntimeError(f"extend_add {shape} {dtype} bf16={bf16}: "
                           f"{bad} entries differ from the plain version "
                           f"(or between repeats)")
    if not moved:
        raise RuntimeError(f"extend_add {shape}: nothing placed")
    return dict(shape=list(shape), dtype=str(dtype), bf16=bf16, moved=moved)


def plan_bound_bytes(pfp, itemsize: int = 4) -> dict:
    """Bytes one factor's extend-adds must move at least: each child value
    placed (its panel columns, and its lower triangle of the slot's rows)
    read once, each parent entry some child reaches read and written once,
    and the row maps read once.  Counted on the card from the plan's row
    maps (a parent entry is reached when some child has both its row and
    its column)."""
    dev = torch.device("cuda")
    nf, npc = len(pfp.fmeta), len(pfp.pmeta)
    child = parent = index = 0
    for cid, pos in zip(pfp.instr_cls.tolist(), pfp.instr_pos.tolist()):
        if cid < nf + npc:
            continue
        q = cid - nf - npc
        Mbc, G, Pq, Npt, Mbt = pfp.qmeta[q][:5]
        Mft = Npt + Mbt
        ops = pfp.qops[q]
        idxf = ops["idxf"][pos]
        index += idxf.size * 4
        keep = ops["pdst"][pos] + Mft * Npt <= pfp.buf
        for p in np.nonzero(keep)[0].tolist():
            V = torch.as_tensor(idxf[p] < Mbc, device=dev,
                                dtype=torch.float32)      # (G, Mft)
            n_all, n_below = V.sum(1), V[:, Npt:].sum(1)
            n_cols = n_all - n_below
            child += int((n_all * n_cols
                          + n_below * (n_below + 1) / 2).sum())
            parent += int(((V.T @ V[:, :Npt]) > 0).sum())
            if Mbt:
                B = V[:, Npt:]
                parent += int(torch.tril((B.T @ B) > 0).sum())
    return dict(child_values=child, parent_entries=parent,
                bytes=itemsize * (child + 2 * parent) + index)


def _pair_stream(pfp, dtype, dev):
    """The plan's pair instructions in stream order, each as (Mbc, Npt,
    Mbt, G, Pq, operands): the operands are ``extend_add``'s after the
    buffer, on ``dev``; and a random buffer of the plan's size."""
    nf, npc = len(pfp.fmeta), len(pfp.pmeta)
    qops = pfp.arrays(dtype, dev)[2]
    stream = []
    for c, pos in zip(pfp.instr_cls.tolist(), pfp.instr_pos.tolist()):
        if c < nf + npc:
            continue
        Mbc, G, Pq, Npt, Mbt = pfp.qmeta[c - nf - npc][:5]
        ops = qops[c - nf - npc]
        stream.append((Mbc, Npt, Mbt, G, Pq,
                       (ops["idxf"][pos], ops["coff"][pos], ops["pdst"][pos],
                        ops["udst"][pos] if Mbt else None)))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return stream, torch.randn(pfp.buf, dtype=dtype, device=dev,
                               generator=g)


def check_plan(pfp, dtype=torch.float32, bf16: bool = False,
               device="cuda") -> dict:
    """Every pair instruction of the plan ``pfp`` on its own operands
    (the plan's row maps, offsets and pad parents), in stream order on two
    copies of one random buffer: ``extend_add`` (the kernel, on the card)
    on one, ``extend_add_plain`` on the other, the two equal bit for bit
    after each instruction.  Raises on the first difference; returns the
    instructions covered: all, G = 1 ones, those with an update slot or
    several parents, G > 1 ones, and those with a pad parent."""
    dev = torch.device(device)
    stream, Fk = _pair_stream(pfp, dtype, dev)
    Fp = Fk.clone()
    seen = dict(instructions=0, g1=0, g1_slot=0, g1_parents=0, gmany=0,
                pads=0)
    for Mbc, Npt, Mbt, G, Pq, ops in stream:
        extend_add(Fk, *ops, Mbc, Npt, Mbt, bf16)
        extend_add_plain(Fp, *ops, Mbc, Npt, Mbt, bf16)
        if not torch.equal(Fk, Fp):
            bad = int((Fk != Fp).sum())
            raise RuntimeError(
                f"extend_add (Pq, G, Mbc, Npt, Mbt) = {(Pq, G, Mbc, Npt, Mbt)}"
                f" {dtype} bf16={bf16}: {bad} entries differ from the plain "
                f"version on the plan's operands")
        seen["instructions"] += 1
        seen["g1"] += G == 1
        seen["g1_slot"] += G == 1 and Mbt > 0
        seen["g1_parents"] += G == 1 and Pq > 1
        seen["gmany"] += G > 1
        seen["pads"] += bool((ops[2] < 0).any()) or bool(
            Mbt and (ops[3] < 0).any())
    return seen


def time_plan(pfp, dtype=torch.float32, reps: int = REPS) -> dict:
    """One factor's pair instructions in stream order on a random buffer:
    the kernel's time a factor (a CUDA graph of the launches, replayed
    ``reps`` times between CUDA events) and the plain version's (once,
    host clock ended by a sync)."""
    dev = torch.device("cuda")
    stream, Fx = _pair_stream(pfp, dtype, dev)

    def run(fn):
        for Mbc, Npt, Mbt, _, _, ops in stream:
            fn(Fx, *ops, Mbc, Npt, Mbt)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        run(extend_add)                  # warm: builds and loads the kernel
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(extend_add)
    graph.replay()
    torch.cuda.synchronize(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize(dev)
    kernel_ms = t0.elapsed_time(t1) / reps
    by_class = _by_class(graph, stream, dev)
    del graph
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    run(extend_add_plain)
    torch.cuda.synchronize(dev)
    plain_ms = (time.perf_counter() - t) * 1e3
    return dict(launches=len(stream), kernel_ms=kernel_ms,
                plain_ms=plain_ms, **by_class)


def _by_class(graph, stream, dev) -> dict:
    """One replay under torch.profiler: each launch's kernel time, summed
    by pair class (Pq, G, Mbc, Npt, Mbt); ``busy_ms`` is their sum, the
    gaps between launches left out."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize(dev)
    ev = sorted((e for e in prof.events() if "extend_add" in e.name
                 and e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if len(ev) != len(stream):
        return dict(by_class=None)
    cls = {}
    for e, (Mbc, Npt, Mbt, G, Pq, _) in zip(ev, stream):
        key = str((Pq, G, Mbc, Npt, Mbt))
        cls[key] = cls.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    top = dict(sorted(cls.items(), key=lambda kv: -kv[1])[:TOP_CLASSES])
    return dict(busy_ms=sum(cls.values()), by_class=top)


def main(name: str = "lap3d_64") -> dict:
    """The shape checks, then ``name``'s factor timed against its bound;
    prints and returns the JSON line."""
    from .profile_attrib import pf_setup
    if not torch.cuda.is_available():
        raise RuntimeError("bench_extend_add: needs a CUDA device")
    rng = np.random.default_rng(22)
    for shape in SHAPES:
        for dt in (torch.float32, torch.float64):
            for bf16 in (False, True):
                print("[extend_add] " + json.dumps(check(rng, shape, dt,
                                                         bf16)), flush=True)
    _, _, pfp, _ = pf_setup(name, "cuda")
    out = dict(matrix=name, device=torch.cuda.get_device_name(0),
               plan_launches=extend_add_launches(pfp))
    for bf16 in (False, True):
        out["checked_bf16" if bf16 else "checked"] = check_plan(
            pfp, torch.float32, bf16)
    out.update(time_plan(pfp))
    out.update(plan_bound_bytes(pfp))
    out["bound_ms"] = out["bytes"] / PEAK_BYTES * 1e3
    out["roofline_pct"] = 100.0 * out["bound_ms"] / out["kernel_ms"]
    if out["roofline_pct"] > 105.0:
        raise RuntimeError(f"bench_extend_add: {out['roofline_pct']:.1f}% "
                           f"of the bound: the bytes or the time are wrong")
    print("[extend_add] " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "lap3d_64")
