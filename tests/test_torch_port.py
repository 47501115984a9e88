"""Package-level contracts of the PyTorch port: it stands alone (no jax,
no suitesparse_tpu), and its entry points default to the card and raise
without one."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.cholesky import pf as port_pf
from suitesparse_tpu_torch.cholesky import super_numeric as port_sn
from suitesparse_tpu_torch.core.common import default_common
from suitesparse_tpu_torch.io.generators import laplacian_3d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATION = """
import sys
import suitesparse_tpu_torch
import suitesparse_tpu_torch.bench
import suitesparse_tpu_torch.bench_extra
import suitesparse_tpu_torch.cholesky
import suitesparse_tpu_torch.cholesky.api
import suitesparse_tpu_torch.cholesky.extra
import suitesparse_tpu_torch.cholesky.kernels
import suitesparse_tpu_torch.cholesky.modify
import suitesparse_tpu_torch.cholesky.pf
import suitesparse_tpu_torch.cholesky.simplicial
import suitesparse_tpu_torch.cholesky.super_numeric
import suitesparse_tpu_torch.cholesky.wave
import suitesparse_tpu_torch.core.check
import suitesparse_tpu_torch.demos
import suitesparse_tpu_torch.demos.cholmod_demo
import suitesparse_tpu_torch.demos.cs_demo
import suitesparse_tpu_torch.demos.graphblas_demo
import suitesparse_tpu_torch.demos.klu_demo
import suitesparse_tpu_torch.demos.umfpack_demo
import suitesparse_tpu_torch.graph.btf
import suitesparse_tpu_torch.lu
import suitesparse_tpu_torch.lu.klu
import suitesparse_tpu_torch.lu.klu_device
import suitesparse_tpu_torch.lu.multifrontal
import suitesparse_tpu_torch.lu.report
import suitesparse_tpu_torch.lu.slip
import suitesparse_tpu_torch.ordering.colamd
import suitesparse_tpu_torch.io
import suitesparse_tpu_torch.io.collection
import suitesparse_tpu_torch.io.fixtures
import suitesparse_tpu_torch.io.generators
import suitesparse_tpu_torch.io.matrixmarket
import suitesparse_tpu_torch.io.rbio
import suitesparse_tpu_torch.utils.cuda_build
import suitesparse_tpu_torch.ops
import suitesparse_tpu_torch.ops.host
import suitesparse_tpu_torch.ops.spgemm
import suitesparse_tpu_torch.ops.spmv
import suitesparse_tpu_torch.parallel
import suitesparse_tpu_torch.parallel.block_cyclic
import suitesparse_tpu_torch.parallel.dist
import suitesparse_tpu_torch.graphblas
import suitesparse_tpu_torch.graphblas.algorithms
import suitesparse_tpu_torch.graphblas.core
import suitesparse_tpu_torch.graphblas.extra
import suitesparse_tpu_torch.graphblas.objects
import suitesparse_tpu_torch.models
import suitesparse_tpu_torch.models.csparse
import suitesparse_tpu_torch.models.factorize
import suitesparse_tpu_torch.models.ldl
import suitesparse_tpu_torch.models.meshnd
import suitesparse_tpu_torch.models.sparseinv
import suitesparse_tpu_torch.models.spqr_rank
import suitesparse_tpu_torch.models.ssmult
import suitesparse_tpu_torch.qr
import suitesparse_tpu_torch.qr.spqr
import suitesparse_tpu_torch.tools
import suitesparse_tpu_torch.tools.ablate_pf
import suitesparse_tpu_torch.tools.bench_bcsr
import suitesparse_tpu_torch.tools.bench_extend_add
import suitesparse_tpu_torch.tools.diag_residual
import suitesparse_tpu_torch.tools.dist_scaling
import suitesparse_tpu_torch.tools.klu_host
import suitesparse_tpu_torch.tools.microbench
import suitesparse_tpu_torch.tools.microbench_dense
import suitesparse_tpu_torch.tools.microbench_dispatch
import suitesparse_tpu_torch.tools.multihost_dryrun
import suitesparse_tpu_torch.tools.probe_prec_e2e
import suitesparse_tpu_torch.tools.probe_precision
import suitesparse_tpu_torch.tools.profile_attrib
import suitesparse_tpu_torch.utils
import suitesparse_tpu_torch.utils.serialize
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "suitesparse_tpu" or m.startswith("suitesparse_tpu."))
print(bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _setup(program="pf"):
    A = laplacian_3d(6)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = program
    sym = port_chol.analyze(A, cm)
    ss = port_chol.super_symbolic(A, sym, cm)
    return A, cm, sym, ss


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, cm, sym, ss = _setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_sn.factorize_super(A, sym, ss, common=cm)
    plan = port_sn.build_plan(ss)
    vals = port_sn._assemble_values(A, sym, ss, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_pf.pf_numeric(vals, plan.pf_plan(cm), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_sn.factor_from_numpy(plan, np.zeros(plan.total + 1), sym.perm)


def test_front_end_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """cholesky / CholeskySolver / spsolve_chol on the supernodal real
    path, the wave program, the probes and load_super_factor run on the
    card when no device is given, and raise without one."""
    from suitesparse_tpu_torch.cholesky import wave as port_wave
    from suitesparse_tpu_torch.tools import microbench_dispatch as probe
    from suitesparse_tpu_torch.utils import serialize
    A, cm, sym, ss = _setup(program="wave")
    f = port_sn.factorize_super(A, sym, ss, common=cm, device="cpu")
    serialize.save_super_factor(tmp_path / "f.npz", f)
    plan = port_sn.build_plan(ss)
    vals = port_sn._assemble_values(A, sym, ss, np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: port_wave.wave_numeric(vals, plan.wave_plan(), np.float32),
        lambda: port_chol.cholesky(A, default_common(), mode="supernodal"),
        lambda: port_chol.spsolve_chol(A, np.ones(A.ncol), cm,
                                       refine_steps=1),
        lambda: serialize.load_super_factor(tmp_path / "f.npz"),
        lambda: probe.main(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the simplicial switch and complex matrices run the host code
    cs = default_common()
    cs.cholesky.supernodal = "simplicial"
    x = port_chol.cholesky(A, cs).solve(np.ones(A.ncol))
    assert port_chol.residual_norm(A, x, np.ones(A.ncol)) < 1e-12


def test_sparse_product_entry_points_raise_without_a_card(monkeypatch):
    """The ops, graphblas and models entry points run on the card when no
    device is given, and raise without one: nothing falls back."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch import graphblas as gb
    from suitesparse_tpu_torch import models, ops
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    S = sp.random(40, 40, 0.1, random_state=np.random.default_rng(0),
                  format="csc") + sp.eye(40)
    A = SparseCSC.from_scipy(S)
    x = np.ones(40)
    bc = ops.to_bcsr(A)                       # host work needs no card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: ops.bcsr_spmm(bc, np.ones((40, 3))),
        lambda: ops.spmv_program(A),
        lambda: ops.spmm_program(A),
        lambda: ops.spgemm(A, A),
        lambda: ops.spgemm_apply(ops.cached_plan(A, A), A.data, A.data,
                                 "plus_times"),
        lambda: models.ssmult(A, A),
        lambda: models.sfmult(A, x),
        lambda: gb.GrBMatrix.from_csc(A),
        lambda: gb.mxv(A, x),
        lambda: gb.vxm(x, A),
        lambda: gb.mxm(A, A),
        lambda: gb.mxm(gb.realize(A, "bitmap"), gb.realize(A, "full")),
        lambda: gb.ewise_add(A, A),
        lambda: gb.ewise_mult(A, A),
        lambda: gb.ewise_union(A, A),
        lambda: gb.apply(A, "abs"),
        lambda: gb.kron(A, A),
        lambda: gb.reduce_rows(A),
        lambda: gb.reduce_scalar(A),
        lambda: gb.positional_mxm(A, A),
        lambda: gb.positional_mxv(A, x),
        lambda: gb.pagerank(A),
        lambda: gb.bfs_levels(A, 0),
        lambda: gb.triangle_count(A),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # host-only operations and the host BFS need no card
    assert gb.bfs_levels(A, 0, method="push")[0] == 0
    assert gb.select(A, "tril").nnz > 0


def test_lu_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """umf_numeric, klu_device and its two programs, and load_umf_numeric
    run on the card when no device is given, and raise without one; the
    host analyses (umf_symbolic, klu_*, btf, colamd) need no card."""
    from suitesparse_tpu_torch import lu
    from suitesparse_tpu_torch.graph import btf_order
    from suitesparse_tpu_torch.io.generators import circuit_like
    from suitesparse_tpu_torch.ordering import colamd
    from suitesparse_tpu_torch.utils import serialize
    A = circuit_like(60, seed=1)
    S = lu.umf_symbolic(A)
    serialize.save_umf_numeric(tmp_path / "n.npz",
                               lu.umf_numeric(A, S, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sym = lu.klu_analyze(A)
    num = lu.klu_factor(A, sym)
    plan = lu.klu_device_plan(A, sym, num)
    calls = [
        lambda: lu.umf_numeric(A, S),
        lambda: lu.umf_numeric(A, S, default_common(), np.float32),
        lambda: lu.klu_device(A, sym, num),
        lambda: lu.klu_refactor_jit(plan),
        lambda: lu.klu_solve_jit(plan),
        lambda: serialize.load_umf_numeric(tmp_path / "n.npz"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    b = np.ones(A.ncol)
    assert np.abs(A.to_scipy() @ lu.klu_solve(num, b) - b).max() < 1e-12
    assert btf_order(A).nblocks >= 1 and len(colamd(A)) == A.ncol


def test_qr_and_front_door_entry_points_raise_without_a_card(monkeypatch):
    """qr_factorize, qr_solve, the spqr_* utilities, Factorize(...).solve,
    backslash and the CSparse QR/Cholesky solves run on the card when no
    device is given, and raise without one; with device="cpu" they run
    here (float64)."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch import models, qr
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.models import csparse
    rng = np.random.default_rng(0)
    T = sp.random(40, 25, 0.2, random_state=rng, format="csc") + \
        sp.vstack([sp.identity(25), sp.csc_matrix((15, 25))])
    A = SparseCSC.from_scipy(sp.csc_matrix(T))
    S = qr.qr_symbolic(A)
    spd = laplacian_3d(4)
    b = np.ones(40)
    num = qr.qr_factorize(A, S, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: qr.qr_factorize(A, S),
        lambda: qr.qr_factorize(A, S, b=b, keep_q=True),
        lambda: qr.qr_solve(A, b),
        lambda: qr.qr_min2norm(A.transpose(), np.ones(25)),
        lambda: qr.qr_numeric_from_numpy(S, num.Rbuf.numpy(), num.qtb,
                                         num.rank, num.tol),
        lambda: models.spqr_basic(A, b),
        lambda: models.spqr_null(A),
        lambda: models.spqr_pinv(A, b),
        lambda: models.spqr_rank(A),
        lambda: models.Factorize(spd).solve(np.ones(spd.ncol)),
        lambda: models.Factorize(A).solve(b),
        lambda: models.backslash(spd, np.ones(spd.ncol)),
        lambda: models.backslash(A, b),
        lambda: csparse.cs_qrsol(A, b),
        lambda: csparse.cs_qr(A),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    x = models.backslash(A, b, device="cpu")
    ref = np.linalg.lstsq(T.toarray(), b, rcond=None)[0]
    assert np.abs(x - ref).max() < 1e-10
    F = models.Factorize(spd, device="cpu")
    assert F.kind == "cholesky"
    assert np.abs(spd.to_scipy() @ F.solve(np.ones(spd.ncol)) - 1).max() \
        < 1e-10
    assert num.Rbuf.dtype == torch.float64


def test_bench_entry_points_raise_without_a_card(monkeypatch):
    """bench_matrix, the four bench_extra functions and both entry
    points' main() run on the card unless "cpu" is asked for, and raise
    without one before any work."""
    from suitesparse_tpu_torch import bench, bench_extra
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: bench.bench_matrix("lap3d_6", 1, 1.0),
        lambda: bench_extra.bench_klu("circuit_100", 1),
        lambda: bench_extra.bench_umfpack("randunsym_200", 1),
        lambda: bench_extra.bench_spqr("randunsym_200", 1),
        lambda: bench_extra.bench_graphblas("lap3d_5", "lap3d_5", 1),
        lambda: bench.main(["--matrix", "lap3d_6", "--no-baseline"]),
        lambda: bench_extra.main(["klu", "--klu", "circuit_100"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cpu_defaults_to_float64_and_dtype_is_honoured():
    A, cm, sym, ss = _setup()
    f = port_sn.factorize_super(A, sym, ss, common=cm, device="cpu")
    assert f.Lx.dtype == torch.float64 and f.Lx.device.type == "cpu"
    f32 = port_sn.factorize_super(A, sym, ss, common=cm, device="cpu",
                                  dtype=np.float32)
    assert f32.Lx.dtype == torch.float32 and f32.ok
    b = np.ones(A.ncol)
    x = port_sn.solve_super(f32, b, "A", cm)
    assert port_chol.residual_norm(A, x.astype(np.float64), b) < 1e-5


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits nonzero and prints no result without a CUDA
    device, and alone in a directory without the package."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, None)):
        if script is None:
            script = tmp_path / "chip_smoke.py"
            script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
