"""The command line of the benchmark, driven on the CPU at n = 512: the
result line, a configuration, mix and metric added as files, the runs
that must print no result, and the faults the judge must catch."""
import json
import subprocess
import sys

import numpy as np
import pytest

import bench_support as bs
from suitesparse_tpu_torch.cholesky.api import CholeskySolver

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")
EXTRA = ("program", "kernel_cache", "power_limit_w", "checks")
DEVICE = ("platform", "kind", "count", "memory_peak_bytes")


@pytest.fixture
def root(tmp_path):
    return bs.checkout(tmp_path)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("traffic", ["refactor", "solve"])
def test_last_line_holds_the_contract_keys(root, capsys, traffic, trace):
    cell = f"lap3d_8.{traffic}"
    rc, res, err = bs.run(root, capsys, cell, trace=trace)
    assert rc == 0
    keys = list(res)
    want = REQUIRED + (("breakdown",) if trace else ()) + EXTRA
    assert keys == list(want), keys
    assert keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    dev = res["device"]
    assert list(dev)[:4] == list(DEVICE)
    assert (("busy_s" in dev) and ("window_s" in dev)) == bool(trace)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    group = spec["per_layer" if trace else "end_to_end"]
    units = {m["name"]: m["unit"] for m in group}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
        assert "analyze_s" in res["metrics"]
    else:
        kind = "refactor_step_ms" if traffic == "refactor" \
            else "solve_step_ms"
        assert {"setup_s", kind} <= set(res["metrics"])
    # a CPU run reports no device metric
    for name in ("peak_mem_gib", "capture_s", "factor_device_ms",
                 "device_idle_pct.refactor"):
        assert name not in res["metrics"]
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
        assert 0 < c["value"] <= c["limit"]
    # the compared numbers are the last lines of standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [t.split()[1] for t in tail] == list(res["checks"])


def test_finds_a_config_a_mix_and_a_metric_added_as_files(root, capsys):
    bench = root / "benchmark"
    (bench / "generators" / "band_spd.py").write_text(
        "import scipy.sparse as sp\n\n\n"
        "def make(n):\n"
        "    A = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n))\n"
        "    return sp.csc_matrix(A)\n")
    bs.add_config(root, "band_300", "band_spd", {"n": 300})
    mix = json.loads((bench / "mixes" / "refactor.json").read_text())
    mix.update(rhs_width=3, value_sets=2)
    (bench / "mixes" / "refactor3.json").write_text(json.dumps(mix))
    (bench / "metrics" / "rhs_columns.py").write_text(
        "def read(run):\n    return run.mix['rhs_width']\n")
    cell = bs.add_cell(root, "band_300", "refactor3")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "rhs_columns", "unit": "count",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, res, _ = bs.run(root, capsys, cell)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["rhs_columns"] == {"value": 3.0, "unit": "count"}
    assert "refactor_step_ms" not in res["metrics"]
    # the cells that do not list the metric do not report it
    rc, res, _ = bs.run(root, capsys, "lap3d_8.refactor")
    assert rc == 0 and "rhs_columns" not in res["metrics"]


# An LU front end with a refinement step, on SciPy's SuperLU: it stands
# for a program whose step and factor the Cholesky files do not know.
LU_SOLVER = """import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

ALTER = {alter}


class Driver:
    def __init__(self, A0, config, device, spans):
        self.A0, self.spans, self.lu, self.v = A0, spans, None, None

    def analyze(self):
        pass

    def set_values(self, values):
        self.mats = [sp.csc_matrix((v, self.A0.indices, self.A0.indptr),
                                   shape=self.A0.shape) for v in values]

    def step_refactor_refine(self, pools, i):
        v, r = pools.step(i)
        with self.spans("refactorize"):
            self.lu, self.v = spla.splu(self.mats[v]), v
        b = pools.rhs[r]
        with self.spans("solve"):
            x = self.lu.solve(b)
            for _ in range(pools.mix["refine_steps"]):
                x = x + self.lu.solve(b - self.mats[v] @ x)
        x[0] *= 1 + ALTER
        return v, r, x

    def counters(self):
        return {{"program": "superlu"}}

    def factor(self):
        n = self.A0.shape[0]
        U = sp.csc_matrix(self.lu.U)
        U[0, 0] *= 1 + ALTER
        return dict(relation="PrAPc=LU", values=self.v,
                    perm_r=self.lu.perm_r, perm_c=self.lu.perm_c,
                    L=sp.csc_matrix(self.lu.L), U=U)

    def close(self):
        self.lu = None
"""

LU_JUDGE = """import numpy as np
import scipy.sparse as sp

from reference import backward_error


def judge(case):
    e = backward_error.answers_berr(case)
    f = case.factor
    assert f["relation"] == "PrAPc=LU"
    A = case.matrix(f["values"]).tocsr()
    n = A.shape[0]
    Pr = sp.csr_matrix((np.ones(n), (f["perm_r"], np.arange(n))))
    Pc = sp.csc_matrix((np.ones(n), (np.arange(n), f["perm_c"])))
    z = np.random.default_rng(case.seed).standard_normal(n)
    r = Pr @ (A @ (Pc @ z)) - f["L"] @ (f["U"] @ z)
    lu = np.abs(r).max() / (backward_error.norm_inf(A) * np.abs(z).max())
    return {{"values": {{"solve_berr": float(e.max()), "lu_berr": lu}},
            "per_answer": {{"solve_berr": e}}}}
"""


def test_a_new_front_end_step_and_judge_are_added_as_files(root, capsys):
    bench = root / "benchmark"
    (bench / "generators" / "convdiff_2d.py").write_text(
        "import scipy.sparse as sp\n\n\n"
        "def make(m):\n"
        "    T = sp.diags([-1.3, 4.2, -0.7], [-1, 0, 1], shape=(m, m))\n"
        "    I = sp.identity(m)\n"
        "    return sp.csc_matrix(sp.kron(I, T) + sp.kron(T, I))\n")
    (bench / "solvers" / "superlu.py").write_text(LU_SOLVER.format(alter=0))
    (bench / "reference" / "lu_berr.py").write_text(LU_JUDGE.format())
    (bench / "mixes" / "refine.json").write_text(json.dumps(dict(
        step="refactor_refine", setup=["refactor_refine"], value_sets=3,
        offdiag_scale=[0.5, 1.5], rhs_pool=4, trace_steps=2,
        refine_steps=1)))
    bs.add_config(root, "convdiff_20", "convdiff_2d", {"m": 20},
                  solver="superlu", judge="lu_berr")
    cell = bs.add_cell(root, "convdiff_20", "refine",
                       limits={"solve_berr": 1e-13, "lu_berr": 1e-13})
    rc, res, err = bs.run(root, capsys, cell)
    assert rc == 0 and res["correct"] is True, err
    assert res["program"] == "superlu"
    assert set(res["checks"]) == {"solve_berr", "lu_berr"}
    assert 0 <= res["checks"]["lu_berr"]["value"] < 1e-15
    # the same files with the answers and the factor altered
    (bench / "solvers" / "superlu.py").write_text(
        LU_SOLVER.format(alter=1e-3))
    rc, res, _ = bs.run(root, capsys, cell)
    assert rc == 0 and res["correct"] is False
    assert res["failed"] == res["attempted"]
    assert all(c["value"] > c["limit"] for c in res["checks"].values())


def test_without_a_card_the_command_prints_no_result():
    got = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "lap3d_64.refactor", "--seed", str(bs.BIG_SEED), "--seconds", "1",
         "--trace", "0"], cwd=bs.REPO, capture_output=True, text=True,
        timeout=300)
    if "no CUDA device" not in got.stderr:
        pytest.skip("a card is present")
    assert got.returncode != 0 and got.stdout == ""


def test_a_checkout_without_the_program_prints_no_result(root, capsys):
    rc, res, err = bs.run(root, capsys, "lap3d_8.refactor", port_root=root)
    assert rc != 0 and res is None
    assert "outside the checkout" in err


def _stale_factor(monkeypatch):
    real = CholeskySolver.refactorize
    calls = []

    def refactorize(self, A, *a, **kw):
        calls.append(1)
        return real(self, A, *a, **kw) if len(calls) == 1 else self
    monkeypatch.setattr(CholeskySolver, "refactorize", refactorize)


def _altered_factor(monkeypatch):
    real = CholeskySolver.refactorize

    def refactorize(self, A, *a, **kw):
        real(self, A, *a, **kw)
        # the first supernode's first diagonal entry
        self.factor.Lx[int(self.plan.ss.panel_off[0])] *= 1.001
        return self
    monkeypatch.setattr(CholeskySolver, "refactorize", refactorize)


def _stale_answer(monkeypatch):
    real = CholeskySolver.solve
    last = []

    def solve(self, b, *a, **kw):
        if len(last) >= 2:
            return last[-1].copy()
        last.append(real(self, b, *a, **kw))
        return last[-1]
    monkeypatch.setattr(CholeskySolver, "solve", solve)


def _altered_answer(monkeypatch):
    real = CholeskySolver.solve
    calls = []

    def solve(self, b, *a, **kw):
        x = real(self, b, *a, **kw)
        calls.append(1)
        if len(calls) == 5:
            x = x.copy()
            x[np.argmax(np.abs(x))] *= 1.001
        return x
    monkeypatch.setattr(CholeskySolver, "solve", solve)


@pytest.mark.parametrize("fault,traffic,caught_by", [
    (_stale_factor, "refactor", "solve_berr"),
    (_altered_factor, "refactor", "factor_berr"),
    (_stale_answer, "solve", "solve_berr"),
    (_altered_answer, "refactor", "solve_berr"),
    (_altered_answer, "solve", "solve_berr"),
])
def test_a_broken_timed_path_is_not_correct(root, capsys, monkeypatch,
                                            fault, traffic, caught_by):
    fault(monkeypatch)
    rc, res, _ = bs.run(root, capsys, f"lap3d_8.{traffic}")
    assert rc == 0 and res["correct"] is False
    c = res["checks"][caught_by]
    assert c["value"] > c["limit"]
    if caught_by == "solve_berr":
        assert res["failed"] > 0
