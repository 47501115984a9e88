"""The cd3d configuration on the CPU: its generator is chip_smoke's
operator, the UMFPACK front end runs a cell of it through the command
line as files at nx = 8 (n = 512) and is correct, and the LU judge reads
a factor or an answer that is wrong as not correct."""
import json
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import bench_support as bs
from harness import spec as spec_mod
from suitesparse_tpu_torch.lu import multifrontal

CONFIG = "cd3d_64"
SMALL = "cd3d_8"


@pytest.fixture
def root(tmp_path):
    """A checkout with the cell cd3d_8.refactor: cd3d_64's configuration
    at nx = 8, under cd3d_64.refactor's limits."""
    root = bs.checkout(tmp_path)
    cfg = json.loads((bs.BENCH / "configs" / f"{CONFIG}.json").read_text())
    cfg.update(name=SMALL, params=dict(cfg["params"], nx=8))
    rel = f"benchmark/configs/{SMALL}.json"
    (root / rel).write_text(json.dumps(cfg))
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec["configs"].append({"name": SMALL, "source": "test", "file": rel,
                            "reduced": [], "why": "test"})
    path.write_text(json.dumps(spec, indent=1))
    limits = spec_mod.Spec(bs.REPO).limits(f"{CONFIG}.refactor")
    bs.add_cell(root, SMALL, "refactor", limits=limits)
    return root


def test_the_generator_is_chip_smokes_operator():
    sys.path.insert(0, str(bs.REPO))
    from chip_smoke import cd3d
    gen = spec_mod.Spec(bs.REPO).generator("convdiff_3d")
    A = gen.make(nx=6, peclet=0.5)
    B = cd3d(6, 0.5)
    assert isinstance(A, sp.csc_matrix) and A.shape == (216, 216)
    for a, b in ((A.indptr, B.indptr), (A.indices, B.indices),
                 (A.data, B.data)):
        assert np.array_equal(a, b)
    cfg = spec_mod.Spec(bs.REPO).config(CONFIG)
    A = gen.make(**cfg["params"])
    assert (A.shape[0], A.nnz) == (cfg["n"], cfg["nnz"])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_through_the_front_end_and_is_correct(root, capsys,
                                                            trace):
    rc, res, err = bs.run(root, capsys, f"{SMALL}.refactor", trace=trace)
    assert rc == 0 and res["correct"] is True, err
    assert res["failed"] == 0 and res["program"] == "umf"
    assert set(res["checks"]) == {"solve_berr", "lu_factor_berr"}
    for c in res["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    got = set(res["metrics"])
    if trace:
        # the program's spans on the CPU; the device metrics need a card
        assert {"umf_numeric_ms", "umf_values_ms", "umf_solve_ms",
                "umf_refine_ms", "umf_symbolic_s", "analyze_s"} <= got
        assert not {"lu_device_ms", "lu_front_roofline_pct",
                    "capture_s"} & got
        m = {k: v["value"] for k, v in res["metrics"].items()}
        assert 0 < m["umf_values_ms"] < m["umf_numeric_ms"]
        assert 0 < m["umf_refine_ms"] < m["umf_solve_ms"]
    else:
        assert {"setup_s", "refactor_step_ms"} <= got


def _altered_factor(part):
    real = multifrontal.umf_get_numeric

    def get(num):
        f = real(num)
        M = f[part].tocoo(copy=True)
        # the largest entry off the diagonal, 0.1% larger
        k = np.flatnonzero(M.row != M.col)
        M.data[k[np.argmax(np.abs(M.data[k]))]] *= 1 + 1e-3
        return dict(f, **{part: M.tocsc()})
    return get


def _nan_factor():
    real = multifrontal.umf_get_numeric

    def get(num):
        f = real(num)
        U = f["U"].copy()
        U.data[U.nnz // 2] = np.nan
        return dict(f, U=U)
    return get


def _stale_answer():
    """Every answer solves the first value set's system, whatever set the
    step factors."""
    real = multifrontal.umf_solve
    first = []

    def solve(num, b, *a, A=None, **kw):
        if not first:
            first.append((num, A))
        return real(first[0][0], b, *a, A=first[0][1], **kw)
    return solve


def _nan_answer():
    real = multifrontal.umf_solve

    def solve(num, b, *a, **kw):
        x = real(num, b, *a, **kw).copy()
        x[len(x) // 3] = np.nan
        return x
    return solve


@pytest.mark.parametrize("name,fault,caught_by", [
    ("umf_get_numeric", lambda: _altered_factor("L"), "lu_factor_berr"),
    ("umf_get_numeric", lambda: _altered_factor("U"), "lu_factor_berr"),
    ("umf_get_numeric", _nan_factor, "lu_factor_berr"),
    ("umf_solve", _stale_answer, "solve_berr"),
    ("umf_solve", _nan_answer, "solve_berr"),
])
def test_the_lu_judge_reads_a_wrong_factor_or_answer_as_not_correct(
        root, capsys, monkeypatch, name, fault, caught_by):
    # the front end's file imports the program's functions when a run
    # loads it, so it takes the faulty one
    monkeypatch.setattr(multifrontal, name, fault())
    rc, res, _ = bs.run(root, capsys, f"{SMALL}.refactor")
    assert rc == 0 and res["correct"] is False
    c = res["checks"][caught_by]
    assert c["value"] == "inf" or c["value"] > c["limit"]
    if caught_by == "solve_berr":
        assert res["failed"] > 0
    else:
        assert res["checks"]["solve_berr"]["value"] <= \
            res["checks"]["solve_berr"]["limit"]
