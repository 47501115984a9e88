"""The unwrap3d configuration on the CPU: its generator's matrix is
G^T G + mu^2 I, the SPQR front end reads each value set's least-squares
matrix back from it without loss, a cell of it runs through the command
line as files at nx = 6 (n = 216, m = 756) in float64 and is correct
with a thousandth of each limit to spare, and the
least-squares judge reads an answer or a factor perturbed by 1e-3 as not
correct."""
import json

import numpy as np
import pytest
import scipy.sparse as sp

import bench_support as bs
from harness import spec as spec_mod, traffic
from suitesparse_tpu_torch.qr import spqr

CONFIG = "unwrap3d_64"
SMALL = "unwrap3d_6"
CELL = f"{CONFIG}.irls"


@pytest.fixture
def root(tmp_path):
    """A checkout with the cell unwrap3d_6.irls: unwrap3d_64's
    configuration at nx = 6 in float64, under unwrap3d_64.irls's
    limits."""
    root = bs.checkout(tmp_path)
    cfg = json.loads((bs.BENCH / "configs" / f"{CONFIG}.json").read_text())
    cfg.update(name=SMALL, params=dict(cfg["params"], nx=6),
               dtype="float64")
    rel = f"benchmark/configs/{SMALL}.json"
    (root / rel).write_text(json.dumps(cfg))
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec["configs"].append({"name": SMALL, "source": "test", "file": rel,
                            "reduced": [], "why": "test"})
    path.write_text(json.dumps(spec, indent=1))
    limits = spec_mod.Spec(bs.REPO).limits(CELL)
    bs.add_cell(root, SMALL, "irls", limits=limits)
    return root


def _front_end(nx=5, seed=3):
    spec = spec_mod.Spec(bs.REPO)
    cfg = spec.config(CONFIG)
    L = spec.generator("grid_normal_3d").make(nx=nx, mu=cfg["params"]["mu"])
    drv = spec.solver("spqr").Driver(L, cfg, "cpu", None)
    mix = traffic.full(spec.mix("irls"), "irls")
    pools = traffic.make_pools(L, mix, seed)
    return L, drv, pools


def test_the_generator_and_the_decoding():
    spec = spec_mod.Spec(bs.REPO)
    cfg = spec.config(CONFIG)
    gen = spec.generator("grid_normal_3d")
    L = gen.make(nx=5, mu=0.1)
    D = sp.diags([-np.ones(4), np.ones(4)], [0, 1], shape=(4, 5))
    eye = sp.identity(5)
    G = sp.vstack([sp.kron(sp.kron(D, eye), eye),
                   sp.kron(sp.kron(eye, D), eye),
                   sp.kron(sp.kron(eye, eye), D)])
    assert abs(L - (G.T @ G + 0.01 * sp.identity(125))).max() == 0
    L64 = gen.make(**cfg["params"])
    assert (L64.shape[0], L64.nnz) == (cfg["n"], cfg["nnz"])
    # each value set's A: A^T A is its L, m = edges + n
    L, drv, pools = _front_end()
    for data in pools.values[:3]:
        A, sw = drv.least_squares(data)
        S = A.to_scipy()
        assert S.shape == (3 * 4 * 25 + 125, 125)
        Lv = sp.csc_matrix((data, L.indices, L.indptr), shape=L.shape)
        assert abs(S.T @ S - Lv).max() <= 1e-14 * abs(Lv).max()
        assert np.all(sw ** 2 >= 0.01 - 1e-15) and np.all(sw ** 2 <= 1.0)


def _perturbed_answer():
    real = spqr.qr_rsolve

    def solve(num, c, *a, **kw):
        x = real(num, c, *a, **kw).copy()
        x *= 1 + 1e-3
        return x
    return solve


def _perturbed_factor():
    real = spqr.qr_get_r

    def get(num):
        R = real(num).tocoo(copy=True)
        # the largest entry off the diagonal, 0.1% larger
        k = np.flatnonzero(R.row != R.col)
        R.data[k[np.argmax(np.abs(R.data[k]))]] *= 1 + 1e-3
        return R.tocsc()
    return get


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_the_float64_answer_passes(root, capsys, trace):
    rc, res, err = bs.run(root, capsys, f"{SMALL}.irls", trace=trace)
    assert rc == 0 and res["correct"] is True, err
    assert res["failed"] == 0 and res["program"] == "spqr"
    assert set(res["checks"]) == {"ls_berr", "qr_factor_berr"}
    for c in res["checks"].values():
        assert 0 <= c["value"] <= 1e-3 * c["limit"]
    got = set(res["metrics"])
    if trace:
        assert {"qr_numeric_ms", "qr_values_ms", "qr_solve_ms",
                "qr_symbolic_s", "analyze_s"} <= got
        assert not {"qr_device_ms", "qr_front_roofline_pct",
                    "capture_s"} & got
        m = {k: v["value"] for k, v in res["metrics"].items()}
        assert 0 < m["qr_values_ms"] < m["qr_numeric_ms"]
        assert 0 < m["qr_symbolic_s"] <= m["analyze_s"]
    else:
        assert {"setup_s", "refactor_step_ms"} <= got


@pytest.mark.parametrize("name,fault,caught_by", [
    ("qr_rsolve", _perturbed_answer, "ls_berr"),
    ("qr_get_r", _perturbed_factor, "qr_factor_berr"),
])
def test_the_judge_reads_a_perturbed_answer_or_factor_as_not_correct(
        root, capsys, monkeypatch, name, fault, caught_by):
    # the front end's file imports the program's functions when a run
    # loads it, so it takes the faulty one
    monkeypatch.setattr(spqr, name, fault())
    rc, res, _ = bs.run(root, capsys, f"{SMALL}.irls")
    assert rc == 0 and res["correct"] is False
    c = res["checks"][caught_by]
    assert c["value"] > c["limit"]
    other = ({"ls_berr", "qr_factor_berr"} - {caught_by}).pop()
    assert res["checks"][other]["value"] <= res["checks"][other]["limit"]
    if caught_by == "ls_berr":
        assert res["failed"] > 0
