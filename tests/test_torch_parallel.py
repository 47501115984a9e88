"""The port's distributed layer (suitesparse_tpu_torch/parallel) against the
JAX package's on the CPU, in float64.

The port runs as P rank processes of
``suitesparse_tpu_torch/tools/multihost_dryrun.py`` over gloo, through a
``file://`` store under ``tmp_path`` (no TCP port, so parallel test
workers cannot collide); ``launch`` kills every rank when one fails or the
time limit passes.  The reference runs ``distributed_factorize`` on a
virtual mesh of P devices in this process.  Both factor the same seeded
matrices from identical plans (tests/test_torch_dist_plan.py).  Limits:
own regions, top and the gathered factor within 1e-13 relative (gloo's
ring all-reduce adds in another order than XLA's), solves within 1e-12,
the fan-out against the replicated top within 1e-12, the block-cyclic
Cholesky and the legacy level step within 1e-12 / 1e-13.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from suitesparse_tpu.cholesky import analyze as ref_analyze
from suitesparse_tpu.cholesky import super_symbolic as ref_super_symbolic
from suitesparse_tpu.cholesky.super_numeric import (
    _assemble_values as ref_assemble_values, build_plan as ref_build_plan)
from suitesparse_tpu.cholesky.wave import wave_numeric as ref_wave_numeric
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.io import generators as ref_gen
from suitesparse_tpu.parallel import dist as ref_dist
from suitesparse_tpu.parallel.block_cyclic import \
    block_cyclic_cholesky as ref_block_cyclic

from suitesparse_tpu_torch.cholesky import residual_norm
from suitesparse_tpu_torch.io import generators as port_gen
from suitesparse_tpu_torch.tools.multihost_dryrun import (dryrun_multichip,
                                                          launch)

K = 8                    # laplacian_3d(K): n = 512
ROOT16 = dict(root_2d_min=16, root_2d_nb=16)
SEED = 3
SHIFTS = (-0.5, -2.0)    # NOT_POSDEF at the root (minor 400) / at a leaf
BLOCK_CYCLIC = ((130, 32, 60), (35, 8, 61))    # (N, nb, seed)
TIMEOUT = 300


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _ref_shifted(k, shift):
    S = ref_gen.laplacian_3d(k).to_scipy()
    return RefCSC.from_scipy((S + shift * sp.identity(S.shape[0])).tocsc())


def _reference(P, tmp):
    """The reference's results on a virtual mesh of P devices."""
    if len(jax.devices()) < P:
        pytest.skip(f"needs {P} virtual devices")
    mesh = ref_dist.make_mesh(P)
    A = ref_gen.laplacian_3d(K)
    n = A.ncol
    b = np.random.default_rng(SEED).standard_normal(n)
    cm = ref_common()
    dp = ref_dist.build_dist_plan(A, P, cm, **ROOT16)
    f, _ = ref_dist.distributed_factorize(A, mesh, cm, dtype=np.float64,
                                          dp=dp)
    out = dict(dp=dp, own=np.asarray(f.own), top=np.asarray(f.top),
               x=f.solve(b))
    vals = ref_assemble_values(A, dp.sym, dp.ss, np.float64)
    out["wave"] = np.asarray(ref_wave_numeric(vals, dp.wp,
                                              np.float64))[:dp.plan.total]
    A25 = RefCSC(A.indptr, A.indices, A.data * 2.5, A.shape)
    f25, _ = ref_dist.distributed_factorize(A25, mesh, cm,
                                            dtype=np.float64, dp=dp)
    out.update(own_25=np.asarray(f25.own), top_25=np.asarray(f25.top))
    out["minors"] = []
    for shift in SHIFTS:
        cs = ref_common()
        fs, _ = ref_dist.distributed_factorize(_ref_shifted(K, shift), mesh,
                                               cs, dtype=np.float64, **ROOT16)
        out["minors"].append((int(cs.status), int(fs.minor)))
    out["L"] = {}
    for N, nb, seed in BLOCK_CYCLIC:
        M = np.random.default_rng(seed).standard_normal((N, N))
        out["L"][(N, nb)] = ref_block_cyclic(M @ M.T + N * np.eye(N), mesh,
                                             nb=nb)
    out["ref_npz"] = str(tmp / "ref_factor.npz")
    np.savez(out["ref_npz"], own=out["own"], top=out["top"])
    out["mesh"] = mesh
    return out


def _port_job(ref_npz):
    cases = [
        dict(kind="dist", gen="laplacian_3d", arg=K, reps=1,
             scales=[1.0, 2.5], check_wave=True, fanout_off=True, save=True,
             ref_npz=ref_npz, seed=SEED, pairs=1, **ROOT16),
        dict(kind="dist", name="lap2d", gen="laplacian_2d", arg=20,
             pairs=1),
        dict(kind="level_step", gen="laplacian_3d", arg=K, save=True)]
    cases += [dict(kind="notposdef", name=f"notposdef{i}",
                   gen="laplacian_3d", arg=K, shift=s, **ROOT16)
              for i, s in enumerate(SHIFTS)]
    cases += [dict(kind="block_cyclic", name=f"bc{N}", N=N, nb=nb, seed=seed,
                   save=True) for N, nb, seed in BLOCK_CYCLIC]
    return dict(backend="gloo", device="cpu", cases=cases)


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def run(request, tmp_path_factory):
    """One spawn of P ranks running every case, beside the reference."""
    P = request.param
    tmp = tmp_path_factory.mktemp(f"dist{P}")
    ref = _reference(P, tmp)
    res = launch(P, _port_job(ref["ref_npz"]), str(tmp / "ranks"), TIMEOUT)
    arrays = [dict(np.load(tmp / "ranks" / f"rank{r}.npz"))
              for r in range(P)]
    return dict(P=P, ref=ref, res=res, arrays=arrays)


def test_own_and_top_match_reference(run):
    ref, P = run["ref"], run["P"]
    Btop = ref["dp"].Btop
    for r in range(P):
        a = run["arrays"][r]
        assert a["own"].shape == (ref["dp"].Bloc,)
        assert _rel(a["own"], ref["own"][r]) < 1e-13
        assert _rel(a["top"], ref["top"][:Btop]) < 1e-13
        # the replicated top is bit-identical on every rank
        np.testing.assert_array_equal(a["top"], run["arrays"][0]["top"])
    d = run["res"][0]["dist"]
    assert d["lbuf"] == ref["dp"].lbuf
    assert d["status"] == 0 and d["minor"] == d["n"]


def test_gather_matches_reference_wave_numeric(run):
    ref = run["ref"]
    assert _rel(run["arrays"][0]["gather"], ref["wave"]) < 1e-13
    assert run["res"][0]["dist"]["gather_vs_wave_rel"] < 1e-13


def test_solve_matches_reference(run):
    A = port_gen.laplacian_3d(K)
    b = np.random.default_rng(SEED).standard_normal(A.ncol)
    for r in range(run["P"]):
        x = run["arrays"][r]["x"]
        assert _rel(x, run["ref"]["x"]) < 1e-12
        assert residual_norm(A, x, b) < 1e-13


def test_fanout_matches_replicated_top(run):
    d = run["res"][0]["dist"]
    assert len(d["top_fan"]) == len(run["ref"]["dp"].top_fan)
    assert d["fanout_vs_replicated_rel"] < 1e-12


def test_refactorization_reuses_plan(run):
    """Scale 1.0 reproduces the first factor bit for bit; scale 2.5
    matches the reference's refactorization of the same plan."""
    ref = run["ref"]
    A = port_gen.laplacian_3d(K)
    b = np.random.default_rng(SEED).standard_normal(A.ncol)
    for r in range(run["P"]):
        a = run["arrays"][r]
        np.testing.assert_array_equal(a["own_1.0"], a["own"])
        np.testing.assert_array_equal(a["top_1.0"], a["top"])
        assert _rel(a["own_2.5"], ref["own_25"][r]) < 1e-13
        assert _rel(a["top_2.5"], ref["top_25"][:ref["dp"].Btop]) < 1e-13
        A25 = port_gen.laplacian_3d(K)
        A25.data = A25.data * 2.5
        assert residual_norm(A25, a["x_2.5"], b) < 1e-12
    assert run["res"][0]["dist"]["residual_scale_2.5"] < 1e-12


def test_rank_programs_between_the_collectives(run):
    """Each rank runs phase 1, every maximal run of replicated top waves
    (the fanned fronts split them) and the three solve pieces as programs
    of its own, each held against its eager body by the rank (the same
    buffers bit for bit, the refactorization equal to the factor), and the
    factor handed out stays as it was through later refactorizations (the
    rank checks it and that its solve is unchanged)."""
    dp = run["ref"]["dp"]
    fanned = {t for t, _nb in dp.top_fan}
    runs, inside = 0, False
    for t in range(len(dp.top_cls)):
        if t in fanned:
            inside = False
        elif not inside:
            runs, inside = runs + 1, True
    solves = ["dist_solve_forward", "dist_solve_top", "dist_solve_backward"]
    for r in run["res"]:
        # laplacian_2d(20) has no fanned front: one run of top waves
        for case, n_top in (("dist", runs), ("lap2d", 1)):
            rows = r[case]["program_pairs"]
            names = [row["program"] for row in rows]
            assert names == ["dist_phase1"] + ["dist_top"] * n_top + solves
            assert not any(row["replayed"] for row in rows)    # the CPU
            assert all(len(row["eager_ms_all"])
                       == len(row["replay_ms_all"]) == 1 for row in rows)


def test_not_posdef_minor_matches_reference(run):
    for i, (status, minor) in enumerate(run["ref"]["minors"]):
        for r in run["res"]:
            got = r[f"notposdef{i}"]
            assert got["status"] == status == 1
            assert got["minor"] == minor < got["n"]
    assert run["ref"]["minors"][0][1] > 0      # a NaN from the root fan-out


def test_collective_counts(run):
    """The counterpart of test_single_program_collective_count: one
    factor issues exactly one all-reduce at the phase boundary, per fanned
    front Np/nb broadcasts and one all-reduce, K broadcasts and one
    all-reduce for the root, one all-reduce of the NaN flag (counted by
    the Mesh and by a wrapper of torch.distributed's functions in each
    rank); a solve issues exactly two all-reduces."""
    dp = run["ref"]["dp"]
    want = {"boundary/all_reduce": 1, "nan/all_reduce": 1}
    if dp.top_fan:
        want["fanout/broadcast"] = sum(
            dp.wp.classes[int(dp.top_cls[t])].Np // nb for t, nb in dp.top_fan)
        want["fanout/all_reduce"] = len(dp.top_fan)
    want["root/broadcast"] = dp.root[1] // dp.root[2]
    want["root/all_reduce"] = 1
    for r in run["res"]:
        d = r["dist"]
        assert d["expected_factor_counts"] == want
        assert d["factor_raw_counts"] == {
            "all_reduce": sum(v for k, v in want.items()
                              if k.endswith("all_reduce")),
            "broadcast": sum(v for k, v in want.items()
                             if k.endswith("broadcast"))}
        assert d["solve_counts"] == {"solve/all_reduce": 2}
        assert d["solve_raw_counts"] == {"all_reduce": 2}
        assert d["factor_bytes"]["boundary"] == \
            d["info_bytes"]["dist_psum_bytes"]
        # no root, no fan-out: the boundary all-reduce and the NaN flag
        small = r["lap2d"]
        assert small["root"] is None and not small["top_fan"]
        assert small["expected_factor_counts"] == {"boundary/all_reduce": 1,
                                                   "nan/all_reduce": 1}
        assert small["factor_raw_counts"] == {"all_reduce": 2}


def test_dist_factor_from_numpy_solves_like_reference(run):
    for r in range(run["P"]):
        assert _rel(run["arrays"][r]["x_from_ref"], run["ref"]["x"]) < 1e-13


def test_block_cyclic_matches_reference(run):
    for N, nb, _seed in BLOCK_CYCLIC:
        L = run["arrays"][0][f"L_{N}_{nb}"]
        assert _rel(L, run["ref"]["L"][(N, nb)]) < 1e-12
        got = run["res"][0][f"bc{N}"]
        K_ = -(-(-(-N // nb)) // run["P"]) * run["P"]
        assert got["counts"] == {"block_cyclic/broadcast": K_,
                                 "block_cyclic/all_gather": 1}
        assert got["vs_float64_rel"] < 1e-12


def test_level_step_matches_reference(run):
    """The legacy batch-sharded level step: the same bucket from the same
    input buffer through both packages (duplicate extend-add targets
    folded by the port's sorted segment sum, not atomics)."""
    got = run["res"][0]["level_step"]
    a = run["arrays"][0]
    A = ref_gen.laplacian_3d(K)
    cm = ref_common()
    cm.cholesky.supernodal = "supernodal"
    sym = ref_analyze(A, cm)
    plan = ref_build_plan(ref_super_symbolic(A, sym, cm))
    bucket = plan.levels[got["level"]][got["bucket"]]
    out = ref_dist.distributed_level_step(run["ref"]["mesh"],
                                          jnp.asarray(a["level_in"]), bucket,
                                          plan.total)
    assert _rel(a["level_out"], np.asarray(out)[:plan.total]) < 1e-13
    assert got["vs_single_max_abs"] == 0.0
    assert got["counts"] == {"level_step/all_gather": 1}


def test_dryrun_multichip_8_matches_reference(tmp_path):
    """The twin of __graft_entry__.dryrun_multichip(8): 8 gloo ranks on
    laplacian_3d(8) with root_2d_min = root_2d_nb = 16, beside the
    reference on the 8-device virtual mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    res = dryrun_multichip(8, "gloo", "cpu", workdir=str(tmp_path),
                           timeout=TIMEOUT)
    A = ref_gen.laplacian_3d(K)
    cm = ref_common()
    dp = ref_dist.build_dist_plan(A, 8, cm, **ROOT16)
    f, _ = ref_dist.distributed_factorize(A, ref_dist.make_mesh(8), cm,
                                          dtype=np.float64, dp=dp)
    x_ref = f.solve(np.ones(A.ncol))
    own, top = np.asarray(f.own), np.asarray(f.top)
    for r in range(8):
        a = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert _rel(a["own"], own[r]) < 1e-13
        assert _rel(a["top"], top[:dp.Btop]) < 1e-13
        assert _rel(a["x"], x_ref) < 1e-12
    assert res[0]["dryrun"]["top_fan"] == len(dp.top_fan) > 0
    assert res[0]["dryrun"]["residual"] < 1e-13
