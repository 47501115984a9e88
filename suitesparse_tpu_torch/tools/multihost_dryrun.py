"""Rank entry point of the port's distributed layer (parallel/dist.py and
parallel/block_cyclic.py): one process per rank.

    python -m suitesparse_tpu_torch.tools.multihost_dryrun \\
        RANK WORLD INIT_FILE JOB_JSON OUT_DIR

Each rank sets its device (``cuda:RANK % count`` for a "cuda" job), joins
the default process group through the ``file://INIT_FILE`` store with the
backend the job names ("gloo" or "nccl"; nothing switches one for the
other), runs the job's cases in order and writes ``OUT_DIR/rank<RANK>.json``
(numbers) and ``OUT_DIR/rank<RANK>.npz`` (arrays).  A case that fails
raises, and the rank exits nonzero.

``launch(world, job, workdir)`` starts WORLD such processes, waits for all
of them within a time limit and kills every rank when one fails or hangs
(a rank that dies leaves the others waiting in a collective).  The CPU
tests, ``chip_smoke.py``'s ``[dist]`` phase, ``dist_scaling.py`` and
``dryrun_multichip`` (the twin of the JAX package's dry run) use it.

Cases (``job["cases"]``, each a dict with a ``kind``):
  dist          distributed_factorize of a generated matrix: the plan
                digest checked across ranks, refactorizations
                bit-identical, collective counts against the plan's
                (counted twice: by the Mesh and by a wrapper of
                torch.distributed's functions), per-phase times and bytes,
                the gathered factor against the single-process wave
                program, the distributed solve with float64 refinement,
                each rank program against its eager body (``pairs``
                rounds), value rescaling, a held factor unchanged by later
                refactorizations, the fan-out switched off, and a solve of
                a factor adopted from numpy arrays
  notposdef     an indefinite matrix: status and minor, beside the
                single-process factor's minor
  level_step    distributed_level_step of one bucket against the
                single-process level step
  block_cyclic  block_cyclic_cholesky of a dense SPD matrix against a
                float64 host Cholesky
  dryrun        the dry run's assertions on laplacian_3d(8)
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
POLL_S = 0.2


# ---------------------------------------------------------------------------
# Launching the ranks
# ---------------------------------------------------------------------------

def launch(world: int, job: dict, workdir: str,
           timeout: float = 600.0) -> list:
    """Run ``job`` on ``world`` rank processes; returns each rank's JSON
    result, in rank order.  Raises (after killing every rank) when a rank
    exits nonzero or the ranks outlast ``timeout`` seconds."""
    os.makedirs(workdir, exist_ok=True)
    init = os.path.join(workdir, "init")
    if os.path.exists(init):
        os.remove(init)
    jobf = os.path.join(workdir, "job.json")
    with open(jobf, "w") as fh:
        json.dump(job, fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    logs, procs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "suitesparse_tpu_torch.tools.multihost_dryrun", str(r),
                 str(world), init, jobf, workdir],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                why = f"rank exit codes {codes}"
                break
            if all(c == 0 for c in codes):
                why = None
                break
            if time.monotonic() > deadline:
                why = f"ranks still running after {timeout:.0f} s"
                break
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    if why is not None:
        tails = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.log")) as fh:
                tails.append(f"--- rank {r} ---\n{fh.read()[-3000:]}")
        raise RuntimeError(f"distributed run failed: {why}\n"
                           + "\n".join(tails))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as fh:
            out.append(json.load(fh))
    return out


def dryrun_multichip(n: int, backend: str = "gloo", device: str = "cpu",
                     workdir: str = None, timeout: float = 600.0) -> list:
    """n ranks on laplacian_3d(8) with root_2d_min = root_2d_nb = 16: every
    regime of the distributed program (the subtree phase, the phase
    boundary, the replicated top waves, the fanned top front and the
    root fan-out) and the distributed solve, with the assertions of the
    JAX package's dry run.  Returns the ranks' results."""
    workdir = workdir or os.path.join(ROOT, "build", f"dryrun_{n}")
    res = launch(n, dict(backend=backend, device=device,
                         cases=[dict(kind="dryrun")]), workdir, timeout)
    r0 = res[0]["dryrun"]
    print(f"dryrun_multichip({n}): {backend} on {device}, n={r0['n']} "
          f"residual={r0['residual']:.2e} "
          f"phase1_waves={r0['phase1_waves']} top_waves={r0['top_waves']} "
          f"per_rank_buf={r0['lbuf']}/{r0['buf']} "
          f"psum={r0['psum_bytes']}B ok", flush=True)
    return res


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------

def _count_collectives(counts: collections.Counter) -> None:
    """Wrap torch.distributed's collectives so that every call this
    process makes is counted by name, whatever issued it."""
    import torch.distributed as tdist
    for name in ("all_reduce", "broadcast", "all_gather"):
        fn = getattr(tdist, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        setattr(tdist, name, wrapped)


def _matrix(spec: dict):
    """A generated matrix, ``shift`` times I added when given."""
    import scipy.sparse as sp
    from ..core.sparse import SparseCSC
    from ..io import generators
    A = getattr(generators, spec["gen"])(spec["arg"])
    if spec.get("shift"):
        S = A.to_scipy()
        A = SparseCSC.from_scipy(
            (S + spec["shift"] * sp.identity(S.shape[0])).tocsc())
    return A


def _digest(*arrays) -> int:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def _same_on_every_rank(mesh, value: int, what: str) -> None:
    import torch
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    got = [int(v.item()) for v in mesh.all_gather(t, "check")]
    if len(set(got)) != 1:
        raise AssertionError(f"{what} differs across ranks: {got}")


def _tensor_digest(t) -> int:
    return _digest(t.detach().cpu().numpy())


def _expected_factor_counts(dp) -> dict:
    """The collectives one distributed factorization issues: one
    all-reduce at the phase boundary (when there is a top), per fanned
    front Np/nb broadcasts and one all-reduce, for the root K broadcasts
    and one all-reduce, and one all-reduce of the NaN flag."""
    exp = collections.Counter()
    if dp.Btop:
        exp["boundary/all_reduce"] += 1
    for _t, nb in dp.top_fan:
        cid = int(dp.top_cls[_t])
        exp["fanout/broadcast"] += dp.wp.classes[cid].Np // nb
        exp["fanout/all_reduce"] += 1
    if dp.root is not None:
        exp["root/broadcast"] += dp.root[1] // dp.root[2]
        exp["root/all_reduce"] += 1
    exp["nan/all_reduce"] += 1
    return dict(exp)


def _sync(dev) -> None:
    """Wait for the device, so that a host clock read after it spans the
    work queued before it."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_counts(mesh) -> dict:
    return {f"{ph}/{op}": n for (ph, op), n in sorted(mesh.counts.items())}


def _kernel_launches() -> dict:
    """The launch counts of the port's four hand-written kernels."""
    from ..cholesky.kernels import block_chol
    from ..ops.spmv import bcsr_spmm
    from . import microbench_dispatch as probe
    return {k.__name__: int(k.launches)
            for k in (block_chol, bcsr_spmm, probe.scale_blocks,
                      probe.scale_gather)}


def _pair_hook(rs, reps: int, dev, rows: list):
    """A ``run`` hook for the rank's ``_factor_local``/``_solve_local``:
    each program's eager body and its replay, ``reps`` rounds after one
    untimed round, alternating which goes first, each started from the
    same state of the rank's buffers and timed on the host clock ended by
    a sync.  The state each leaves must be the same bit for bit; the eager
    body runs under ``torch.cuda.set_sync_debug_mode("error")`` (no host
    sync).  Appends one row per program to ``rows``; the buffers end as
    the replay leaves them."""
    import torch

    def state():
        out = [rs.Lx, rs.init_top]
        for sv in rs.solves.values():
            out += [sv.x0, sv.x, sv.xm, sv.delta]
        return out

    def eager(prog, inputs):
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            prog.eager(*inputs)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)

    def run(prog, *inputs):
        t0 = time.perf_counter()
        prog.prepare(*inputs)
        _sync(dev)
        setup_s = time.perf_counter() - t0
        start = [t.clone() for t in state()]
        times = dict(eager=[], replay=[])
        want = None
        for r in range(reps + 1):
            order = (("eager", lambda: eager(prog, inputs)),
                     ("replay", lambda: prog(*inputs)))
            for name, fn in (order if r % 2 == 0 else order[::-1]):
                for t, s in zip(state(), start):
                    t.copy_(s)
                _sync(dev)
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                if r:
                    times[name].append((time.perf_counter() - t0) * 1e3)
                got = [t.clone() for t in state()]
                if want is None:
                    want = got
                elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{prog.name} {prog.key}: replay "
                                         f"and eager body differ")
        rows.append(dict(
            program=prog.name, key=str(prog.key[1:]),
            replayed=prog.graph is not None,
            eager_ms=float(np.median(times["eager"])),
            replay_ms=float(np.median(times["replay"])),
            eager_ms_all=times["eager"], replay_ms_all=times["replay"],
            setup_s=setup_s, warmup_s=prog.warmup_s,
            capture_s=prog.capture_s, graph_nodes=prog.nodes))
    return run


def _case_dist(spec, mesh, raw, arrays):
    import torch
    import torch.distributed as tdist
    from ..cholesky import residual_norm
    from ..cholesky.super_numeric import _assemble_values
    from ..cholesky.wave import wave_numeric
    from ..core.common import default_common
    from ..core.sparse import SparseCSC
    from ..parallel import dist as pd

    dev = mesh.device
    dtype = np.dtype(spec.get("dtype", "float64"))
    A = _matrix(spec)
    n = A.ncol
    out = dict(n=n, nnz=int(A.nnz), rank=mesh.rank, ndev=mesh.ndev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cm = default_common()
    model = spec.get("model")
    t0 = time.perf_counter()
    dp = pd.build_dist_plan(
        A, mesh.ndev, cm, root_2d_min=spec.get("root_2d_min", 256),
        root_2d_nb=spec.get("root_2d_nb", 128),
        seq=spec.get("seq", "merge"),
        model_rate=model[0] if model else None,
        model_dispatch_s=model[1] if model else None)
    out["plan_s"] = time.perf_counter() - t0
    _same_on_every_rank(mesh, _digest(np.asarray(dp.seq_cls), dp.seq_pos,
                                      dp.owner, dp.a_dst_local),
                        "the plan digest")
    out["comm"] = dp.comm
    out.update(lbuf=dp.lbuf, Bloc=dp.Bloc, Btop=dp.Btop, buf=dp.buf,
               top_fan=[list(t) for t in dp.top_fan],
               root=list(dp.root[:3]) if dp.root else None,
               seq_slots=len(dp.seq_cls))
    expected = _expected_factor_counts(dp)
    out["expected_factor_counts"] = expected

    def factor(M):
        mesh.reset_counts()
        raw.clear()
        f, _ = pd.distributed_factorize(M, mesh, cm, dtype=dtype, dp=dp)
        counts = _mesh_counts(mesh)
        if counts != expected or sum(raw.values()) != sum(counts.values()):
            raise AssertionError(f"factor collectives {counts} (raw "
                                 f"{dict(raw)}), expected {expected}")
        return f

    t0 = time.perf_counter()
    f = factor(A)
    _sync(dev)
    out["first_factor_s"] = time.perf_counter() - t0
    out["factor_raw_counts"] = dict(raw)
    out.update(status=int(cm.status), minor=int(f.minor),
               factor_bytes=dict(mesh.nbytes),
               info_bytes={k: v for k, v in cm.info.items()
                           if k.startswith("dist_") and k.endswith("_bytes")})
    phases = ("dist_factor_time", "dist_phase1_time", "dist_boundary_time",
              "dist_phase2_time", "dist_root_time")
    times = {k: [] for k in phases}
    ref_local = f.Lx[:dp.Bloc + dp.Btop].clone()
    for _ in range(spec.get("reps", 0)):
        f = factor(A)
        for k in phases:
            times[k].append(cm.info[k])
        if not torch.equal(f.Lx[:dp.Bloc + dp.Btop], ref_local):
            raise AssertionError("a refactorization is not bit-identical")
    out["refactor_times_s"] = times
    del ref_local
    # the replicated top is bit-identical on every rank
    _same_on_every_rank(mesh, _tensor_digest(f.top), "the top region")
    if spec.get("save"):
        arrays["own"] = f.own.cpu().numpy()
        arrays["top"] = f.top.cpu().numpy()
    if spec.get("check_wave"):
        G = f.gather()
        if mesh.rank == 0:
            vals = torch.as_tensor(_assemble_values(A, dp.sym, dp.ss, dtype),
                                   device=dev)
            W = wave_numeric(vals, dp.wp, dtype, device=dev)
            tot = dp.plan.total
            out["gather_vs_wave_rel"] = float(
                (G.Lx[:tot] - W[:tot]).abs().max()
                / max(float(W[:tot].abs().max()), 1.0))
            if spec.get("save"):
                arrays["gather"] = G.Lx[:tot].cpu().numpy()
            del W, vals
        del G
    b = np.random.default_rng(spec.get("seed", 0)).standard_normal(n)
    Sf = A.to_scipy().astype(np.float64)
    tdist.barrier(group=mesh.group)     # time the solve, not the wait
    mesh.reset_counts()
    raw.clear()
    t0 = time.perf_counter()
    x = f.solve(b, cm).astype(np.float64)
    solve_s = [time.perf_counter() - t0]
    x_first = x.copy()
    out["solve_counts"] = _mesh_counts(mesh)
    out["solve_raw_counts"] = dict(raw)
    if out["solve_counts"] != {"solve/all_reduce": 2} or dict(raw) != {
            "all_reduce": 2}:
        raise AssertionError(f"solve collectives {out['solve_counts']} "
                             f"(raw {dict(raw)})")
    out["solve_bytes"] = dict(mesh.nbytes)
    if spec.get("save"):
        arrays["x"] = x
    res = [residual_norm(A, x, b)]
    for _ in range(spec.get("refine", 0)):
        r = b - Sf @ x
        t0 = time.perf_counter()
        dx = f.solve(r)
        solve_s.append(time.perf_counter() - t0)
        x = x + dx.astype(np.float64)
        res.append(residual_norm(A, x, b))
    out.update(residuals=res, solve_s=solve_s)
    held = f.Lx.clone()
    if spec.get("pairs"):
        # each program of the rank timed against its eager body, through a
        # refactorization and a solve of the held factor
        rows = []
        vals = torch.as_tensor(_assemble_values(A, dp.sym, dp.ss, dtype),
                               device=dev)
        rs = pd._rank_programs(dp, mesh, vals.dtype)
        hook = _pair_hook(rs, spec["pairs"], dev, rows)
        pd._factor_local(vals, dp, mesh, [], run=hook)
        if not torch.equal(rs.Lx, held):
            raise AssertionError("the paired refactorization differs")
        pd._solve_local(f, b.reshape(n, 1), run=hook)
        out["program_pairs"] = rows
        del vals
    for s in spec.get("scales", ()):
        As = SparseCSC(A.indptr, A.indices, A.data * s, A.shape)
        fs = factor(As)
        xs = fs.solve(b).astype(np.float64)
        out[f"residual_scale_{s}"] = residual_norm(As, xs, b)
        if spec.get("save"):
            arrays[f"own_{s}"] = fs.own.cpu().numpy()
            arrays[f"top_{s}"] = fs.top.cpu().numpy()
            arrays[f"x_{s}"] = xs
        del fs
    # the factor handed out is a copy: the later refactorizations left it
    # as it was, and solving it again copies it back into the rank's
    # buffer and gives the first solve's x bit for bit
    if not torch.equal(f.Lx, held):
        raise AssertionError("a later refactorization changed a held factor")
    if not np.array_equal(f.solve(b).astype(np.float64), x_first):
        raise AssertionError("a held factor's solve changed")
    del held
    if spec.get("fanout_off"):
        dp0 = dataclasses.replace(dp, top_fan=())
        f0, _ = pd.distributed_factorize(A, mesh, cm, dtype=dtype, dp=dp0)
        G0, G = f0.gather(), f.gather()
        tot = dp.plan.total
        out["fanout_vs_replicated_rel"] = float(
            (G.Lx[:tot] - G0.Lx[:tot]).abs().max()
            / max(float(G0.Lx[:tot].abs().max()), 1.0))
        if spec.get("save") and mesh.rank == 0:
            arrays["gather_nofan"] = G0.Lx[:tot].cpu().numpy()
        del f0, G0, G
    if spec.get("ref_npz"):
        ref = np.load(spec["ref_npz"])
        fr = pd.dist_factor_from_numpy(dp, ref["own"], ref["top"],
                                       dp.sym.perm, rank=mesh.rank,
                                       mesh=mesh)
        arrays["x_from_ref"] = fr.solve(b)
    if dev.type == "cuda":
        out["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(dev))
    return out


def _case_notposdef(spec, mesh, raw, arrays):
    from ..cholesky import analyze, factorize_super, super_symbolic
    from ..core.common import default_common
    from ..parallel import dist as pd
    A = _matrix(spec)
    dtype = np.dtype(spec.get("dtype", "float64"))
    cm = default_common()
    f, _ = pd.distributed_factorize(A, mesh, cm, dtype=dtype,
                                    root_2d_min=spec.get("root_2d_min", 256),
                                    root_2d_nb=spec.get("root_2d_nb", 128))
    out = dict(status=int(cm.status), minor=int(f.minor), n=A.ncol)
    if spec.get("single") and mesh.rank == 0:
        c1 = default_common()
        c1.cholesky.supernodal = "supernodal"
        sym = analyze(A, c1)
        ss = super_symbolic(A, sym, c1)
        f1 = factorize_super(A, sym, ss, common=c1, dtype=dtype,
                             device=mesh.device)
        out.update(single_status=int(c1.status), single_minor=int(f1.minor))
    return out


def _case_level_step(spec, mesh, raw, arrays):
    import torch
    from ..cholesky import analyze, super_symbolic
    from ..cholesky.super_numeric import (_a_sorted_maps, _assemble_values,
                                          _index, _level_step_segsum,
                                          assemble, build_plan)
    from ..core.common import default_common
    from ..parallel import dist as pd
    dev = mesh.device
    dtype = np.dtype(spec.get("dtype", "float64"))
    A = _matrix(spec)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    plan = build_plan(ss)
    li = spec.get("level", 0)
    bi = max(range(len(plan.levels[li])),
             key=lambda i: (plan.levels[li][i].Mb > 0,
                            len(plan.levels[li][i].sids)))
    bucket = plan.levels[li][bi]
    vals = torch.as_tensor(_assemble_values(A, sym, ss, dtype), device=dev)
    a_src, a_dst = _a_sorted_maps(ss)
    Lx0 = assemble(vals, _index(a_src, dev), _index(a_dst, dev),
                   plan.total + 1)
    mesh.reset_counts()
    got = pd.distributed_level_step(mesh, Lx0, bucket, plan.total)
    single = _level_step_segsum(Lx0.clone(),
                                [plan.arrays_segsum(dtype, dev)[li][bi]],
                                [plan.meta[li][bi]])
    tot = plan.total
    out = dict(level=li, bucket=bi, B=len(bucket.sids), Np=bucket.Np,
               Mb=bucket.Mb, counts=_mesh_counts(mesh),
               vs_single_max_abs=float((got[:tot] - single[:tot]).abs().max()),
               vs_single_rel=float((got[:tot] - single[:tot]).abs().max()
                                   / max(float(single[:tot].abs().max()),
                                         1.0)))
    if spec.get("save") and mesh.rank == 0:
        arrays["level_in"] = Lx0.cpu().numpy()
        arrays["level_out"] = got[:tot].cpu().numpy()
    return out


def _case_block_cyclic(spec, mesh, raw, arrays):
    import torch
    from ..parallel.block_cyclic import block_cyclic_cholesky
    N, nb = spec["N"], spec["nb"]
    dtype = np.dtype(spec.get("dtype", "float64"))
    if spec.get("on_device"):
        # M M^T / N + I, made on the device from the seed: the same bits on
        # every rank of one card
        g = torch.Generator(device=mesh.device).manual_seed(spec["seed"])
        M = torch.randn((N, N), generator=g, dtype=torch.float64,
                        device=mesh.device)
        F = (M @ M.T / N + torch.eye(N, dtype=torch.float64,
                                     device=mesh.device)).cpu().numpy()
        del M
    else:
        M = np.random.default_rng(spec["seed"]).standard_normal((N, N))
        F = M @ M.T + N * np.eye(N)
    mesh.reset_counts()
    t0 = time.perf_counter()
    L = block_cyclic_cholesky(F, mesh, nb=nb, dtype=dtype)
    _sync(mesh.device)
    out = dict(N=N, nb=nb, seconds=time.perf_counter() - t0,
               counts=_mesh_counts(mesh))
    if mesh.rank == 0:
        ref = np.linalg.cholesky(F)
        out["vs_float64_rel"] = float(np.abs(L - ref).max()
                                      / np.abs(ref).max())
        if spec.get("save"):
            arrays[f"L_{N}_{nb}"] = L
    return out


def _case_dryrun(spec, mesh, raw, arrays):
    from ..cholesky import residual_norm
    from ..core.common import default_common
    from ..io import generators
    from ..parallel import dist as pd
    from ..utils.device import default_dtype
    nd = mesh.ndev
    A = generators.laplacian_3d(8)
    cm = default_common()
    dp = pd.build_dist_plan(A, nd, cm, root_2d_min=16, root_2d_nb=16)
    assert dp.root is not None, "dry run must exercise the root fan-out"
    assert (dp.owner >= 0).any(), "dry run must exercise subtree phase"
    assert dp.comm["dist_phase1_waves"] > 0, "empty subtree phase"
    assert dp.comm["dist_top_waves"] > 0, "empty replicated-top phase"
    dtype = default_dtype(mesh.device)
    f, _ = pd.distributed_factorize(A, mesh, cm, dtype=dtype, dp=dp)
    assert tuple(f.own.shape) == (dp.Bloc,)
    assert f.Lx.numel() == dp.lbuf == dp.buf - (nd - 1) * dp.Bloc
    b = np.ones(A.ncol)
    x = f.solve(b, cm)
    res = residual_norm(A, x.astype(np.float64), b)
    assert np.isfinite(res) and res < 1e-3, f"distributed residual {res}"
    arrays["own"] = f.own.cpu().numpy()
    arrays["top"] = f.top.cpu().numpy()
    arrays["x"] = x
    return dict(n=A.ncol, residual=float(res),
                phase1_waves=dp.comm["dist_phase1_waves"],
                top_waves=dp.comm["dist_top_waves"], lbuf=dp.lbuf,
                buf=dp.buf, top_fan=len(dp.top_fan),
                psum_bytes=cm.info["dist_psum_bytes"])


CASES = dict(dist=_case_dist, notposdef=_case_notposdef,
             level_step=_case_level_step, block_cyclic=_case_block_cyclic,
             dryrun=_case_dryrun)


def main(rank: int, world: int, init_file: str, job_file: str,
         out_dir: str) -> int:
    import torch
    import torch.distributed as tdist
    from ..parallel import dist as pd
    with open(job_file) as fh:
        job = json.load(fh)
    if job["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = None                  # make_mesh's default: this rank's card
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        device = "cpu"
    raw = collections.Counter()
    _count_collectives(raw)
    tdist.init_process_group(job["backend"], init_method=f"file://{init_file}",
                             rank=rank, world_size=world)
    try:
        mesh = pd.make_mesh(device=device)
        results = dict(rank=rank, world=world, backend=job["backend"],
                       device=str(mesh.device))
        arrays = {}
        for spec in job["cases"]:
            t0 = time.perf_counter()
            res = CASES[spec["kind"]](spec, mesh, raw, arrays)
            res["case_s"] = time.perf_counter() - t0
            results[spec.get("name", spec["kind"])] = res
        results["kernel_launches"] = _kernel_launches()
        if mesh.device.type == "cuda":
            results["max_memory_allocated"] = int(
                torch.cuda.max_memory_allocated(mesh.device))
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(results, fh)
    print(json.dumps(dict(rank=rank, ok=True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                  sys.argv[4], sys.argv[5]))
