"""The port's benchmark entry points (suitesparse_tpu_torch/bench.py,
bench_extra.py) and demos (suitesparse_tpu_torch/demos/) against the JAX
package on the CPU in float64, at small sizes.

The reference's own bench_matrix is never called: its splu cache rewrites
the tracked BASELINE_SPLU.json.  Its bench_extra functions write nothing
and are called with their matrix names set through their environment
variables.  The genuine fixtures the demos load are absent here, so both
packages' loaders are monkeypatched to return the same generated
matrices."""
import contextlib
import functools
import importlib
import importlib.util
import io
import json
import os
import pathlib
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.cholesky import pf as ref_pf
from suitesparse_tpu.cholesky import super_numeric as ref_sn
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.io import collection as ref_collection
from suitesparse_tpu.io import fixtures as ref_fixtures
from suitesparse_tpu.io import generators as ref_gen

from suitesparse_tpu_torch import bench, bench_extra
from suitesparse_tpu_torch.io import fixtures as port_fixtures
from suitesparse_tpu_torch.io import generators as port_gen

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_KEYS = ("name", "n", "fl", "lnz", "t_analyze", "t_factor", "gflops",
            "t_solve", "solve_gflops", "solve32_gflops", "residual",
            "t_base", "bf16_gflops", "bf16_residual", "t_first",
            "pct_gemm_peak")
FACTOR_TOL = 1e-13           # float64 panels, as tests/test_torch_pf.py
RESIDUAL_MAX = 1e-11         # after 3 float64 refinement steps


@pytest.fixture
def no_home_cache(monkeypatch, tmp_path):
    """The collection's cache directory under tmp_path, no reference
    checkout: lookups write nothing under the home directory."""
    coll = tmp_path / "collection"
    coll.mkdir()
    monkeypatch.setenv("SSTPU_COLLECTION", str(coll))
    monkeypatch.setenv("SSTPU_REFERENCE", str(tmp_path / "no_reference"))
    return coll


def _ref_bench_plan(name):
    """The reference's protocol up to the first factor (bench.py:100-150)
    in float64: (sym, ss, plan, pf plan, panels)."""
    A = ref_collection.get(name)
    if A.stype == 0:
        A = ref_gen.symmetrize_upper(A)
    cm = ref_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"
    sym = ref_chol.analyze(A, cm)
    ss = ref_chol.super_symbolic(A, sym, cm)
    plan = ref_sn.build_plan(ss)
    pfp = plan.pf_plan(cm)
    vals = ref_sn._assemble_values(A, sym, ss, np.float64)
    Lx = np.asarray(ref_pf.pf_numeric(vals, pfp, np.float64))
    return sym, ss, plan, pfp, Lx


@pytest.mark.parametrize("name", ["lap3d_8", "fem3d_400"])
def test_bench_row_matches_the_reference(name, no_home_cache, tmp_path):
    row, factor = bench.bench_matrix(
        name, 1, 1.0, device="cpu", splu_cache=tmp_path / "splu.json",
        return_factor=True)
    sym, ss, plan, pfp, Lx = _ref_bench_plan(name)
    assert set(REF_KEYS) <= set(row)
    assert (row["n"], row["fl"], row["lnz"]) == (sym.n, float(sym.flops),
                                                 int(sym.lnz))
    assert (row["nsuper"], row["buckets"], row["instr"], row["buf"],
            row["total"]) == (ss.nsuper, plan.nbuckets,
                              len(pfp.instr_cls), pfp.buf, plan.total)
    t = plan.total
    rel = np.abs(factor - Lx[:t]).max() / max(np.abs(Lx[:t]).max(), 1.0)
    assert rel < FACTOR_TOL
    assert row["residual"] <= RESIDUAL_MAX
    assert row["residual_device"] < bench.DEVICE_RESIDUAL_MAX
    assert np.isfinite(row["bf16_residual"]) and row["bf16_residual"] < 1e-6
    assert row["bit_identical"] and row["t_base"] > 0
    assert all(row[k] > 0 for k in ("t_factor", "t_solve", "gflops",
                                    "solve32_gflops", "bf16_gflops"))
    # the CPU takes block_chol's plain version: nothing launches
    assert row["block_chol_launches"] == row["block_chol_per_factor"] == 0
    assert row["block_chol_plan"] > 0
    assert (row["device"], row["dtype"]) == ("cpu", "float64")
    assert json.loads((tmp_path / "splu.json").read_text())[name][
        "time_s"] == row["t_base"]


def _load_ref_bench_extra():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_extra", ROOT / "bench_extra.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXTRA_CASES = {
    # key: (port keyword arguments, the reference's environment)
    "klu": ({"name": "circuit_200"}, {"BENCH_KLU_MATRIX": "circuit_200"}),
    "umfpack": ({"name": "randunsym_1000"},
                {"BENCH_UMF_MATRIX": "randunsym_1000"}),
    "spqr": ({"name": "randunsym_400"},
             {"BENCH_SPQR_MATRIX": "randunsym_400"}),
    "graphblas": ({"name": "lap3d_6", "pagerank_name": "lap3d_5"},
                  {"BENCH_GB_MATRIX": "lap3d_6",
                   "BENCH_PR_MATRIX": "lap3d_5"}),
}
EXACT = {"klu": ("n", "nnz", "flops"),
         "umfpack": ("n", "nnz", "panel_entries"),
         "spqr": ("m", "n", "nnz", "rank"),
         "graphblas": ("mxm_flops", "pagerank_matrix")}


@pytest.mark.parametrize("key", list(EXTRA_CASES))
def test_bench_extra_rows_match_the_reference(key, monkeypatch,
                                              no_home_cache):
    kw, env = EXTRA_CASES[key]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = getattr(_load_ref_bench_extra(), f"bench_{key}")(repeats=1)
    got = getattr(bench_extra, f"bench_{key}")(repeats=1, device="cpu",
                                                **kw)
    assert got["metric"] == ref["metric"] and got["unit"] == ref["unit"]
    for k in EXACT[key]:
        assert got[k] == ref[k], k
    assert got["value"] > 0
    if key in ("klu", "umfpack"):
        # the port in float64 on the CPU; the reference's KLU twin runs in
        # float32 (bench_extra.py:52)
        assert got["residual"] < 1e-14 and ref["residual"] < 1e-5
    if key == "spqr":
        assert got["lsq_optimality"] < 1e-9
        assert ref["lsq_optimality"] < 1e-9
    if key == "graphblas":
        assert abs(got["pagerank_sum"] - 1.0) < 1e-12


def test_only_the_default_fixtures_fall_back(no_home_cache):
    """An absent reference default (bcspwr10, Franz6_id1959_aug) falls
    back as the reference does; a matrix named otherwise that is missing
    fails."""
    row = bench_extra.bench_graphblas("lap3d_5", repeats=1, device="cpu")
    assert row["pagerank_matrix"] == "lap3d_5"
    with pytest.raises(FileNotFoundError, match="nosuch_matrix"):
        bench_extra.bench_graphblas("lap3d_5", "nosuch_matrix", repeats=1,
                                    device="cpu")
    with pytest.raises(FileNotFoundError, match="nosuch_matrix"):
        bench_extra.bench_spqr("nosuch_matrix", repeats=1, device="cpu")


def _run(module, args, tmp_path, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), HOME=str(tmp_path / "home"),
               SSTPU_COLLECTION=str(tmp_path / "collection"),
               SSTPU_REFERENCE=str(tmp_path / "no_reference"))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def _tree(path: pathlib.Path) -> set:
    return {str(p.relative_to(path)) for p in path.rglob("*")}


@pytest.mark.parametrize("module,args,wrote", [
    ("suitesparse_tpu_torch.bench",
     ["--device", "cpu", "--matrix", "lap3d_6,bcsstk16", "--repeats", "1"],
     {"detail.json", "splu_cache.json"}),
    ("suitesparse_tpu_torch.bench_extra",
     ["--device", "cpu", "--klu", "circuit_100", "--umfpack",
      "randunsym_200", "--spqr", "randunsym_200", "--graphblas", "lap3d_5"],
     {"extra.json"}),
])
def test_entry_point_last_line_and_files(module, args, wrote, tmp_path):
    """The run exits 0, its last line has the reference's shape, and it
    writes nothing but its files in the output directory: not beside the
    reference's tracked files, not in its working directory, not under
    the home directory."""
    for d in ("home", "collection", "cwd"):
        (tmp_path / d).mkdir()
    tracked = {p: (ROOT / p).read_bytes()
               for p in ("BASELINE_SPLU.json", "BENCH_DETAIL.json")}
    out = tmp_path / "out"
    proc = _run(module, args + ["--out", str(out)], tmp_path,
                tmp_path / "cwd")
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    if module.endswith(".bench"):
        got = json.loads(last)
        assert set(got) == {"metric", "value", "unit", "vs_baseline"}
        assert got["metric"] == "supernodal_cholesky_factor_gflops[lap3d_6]"
        assert got["unit"] == "GFLOP/s" and got["vs_baseline"] > 0
        assert "[bench] skipped: fixture absent: bcsstk16" in proc.stderr
        detail = json.loads((out / "detail.json").read_text())
        assert [r["name"] for r in detail["cholesky"]] == ["lap3d_6"]
        assert detail["matmul_precision"] == "float32, TF32 off"
    else:
        assert last.startswith("RESULT:")
        rows = json.loads(last[len("RESULT:"):])
        assert [r["metric"].split("[")[0] for r in rows] == [
            "klu_device_refactor_ms", "umfpack_refactor_ms",
            "spqr_factorize_ms", "graphblas_mxm_mflops"]
        assert rows == json.loads((out / "extra.json").read_text())
    assert _tree(out) == wrote
    assert _tree(tmp_path) - {"out"} - {f"out/{w}" for w in wrote} == {
        "home", "collection", "cwd"}
    for p, data in tracked.items():
        assert (ROOT / p).read_bytes() == data


@pytest.mark.parametrize("module,args", [
    ("suitesparse_tpu_torch.bench",
     ["--device", "cpu", "--matrix", "lap3d_5,nosuch_12", "--repeats",
      "1", "--no-baseline"]),
    ("suitesparse_tpu_torch.bench_extra",
     ["--device", "cpu", "klu", "--klu", "nosuch_12"]),
])
def test_a_failed_matrix_fails_the_run(module, args, tmp_path):
    for d in ("home", "collection"):
        (tmp_path / d).mkdir()
    proc = _run(module, args + ["--out", str(tmp_path / "out")], tmp_path,
                tmp_path)
    assert proc.returncode != 0
    assert "metric" not in proc.stdout and "RESULT:" not in proc.stdout
    assert "failed" in proc.stderr
    assert not (tmp_path / "out").exists()


# -- the demos ---------------------------------------------------------------

DEMOS = ["cholmod_demo", "klu_demo", "cs_demo", "umfpack_demo",
         "graphblas_demo"]
DEVICE_DEMOS = ["cs_demo", "umfpack_demo", "graphblas_demo"]  # the card
_NUM = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _fixtures(gen):
    """The generated stand-ins for the fixtures the demos load, built by
    one package's generators."""
    return {"bcsstk01": gen.random_spd(48, density=0.15, seed=1),
            "west0067": gen.random_unsym(67, density=0.06, seed=2),
            "impcol_a": gen.circuit_like(207, seed=3),
            "bcspwr10": gen.fem3d(300, seed=4)}


def _run_demo(main, monkeypatch, fixtures_mod, gen, **kw) -> str:
    table = _fixtures(gen)
    monkeypatch.setattr(fixtures_mod, "load",
                        lambda name, dtype=np.float64: table[name])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(**kw)
    return buf.getvalue()


def _tokens_match(exp: str, got: str) -> bool:
    """tests/test_demos.py's rule: text exactly; numbers within 1e-3
    relative, and a residual-class value (below 1e-10) only stays tiny."""
    if exp == got:
        return True
    if not (_NUM.match(exp) and _NUM.match(got)):
        return False
    e, g = float(exp), float(got)
    if abs(e) < 1e-10:
        return abs(g) < 1e-9
    return abs(e - g) <= 1e-3 * max(abs(e), abs(g))


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
@pytest.mark.parametrize("name", DEVICE_DEMOS)
def test_device_demo_runs_on_the_card_unless_cpu_is_asked(name, monkeypatch):
    """A demo that takes a device runs on the card by default: without
    one it raises, from main() and from the command line, and runs on the
    CPU with --device cpu."""
    module = f"suitesparse_tpu_torch.demos.{name}"
    mod = importlib.import_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run_demo(mod.main, monkeypatch, port_fixtures, port_gen)
    for argv, raises in ((["demo"], True), (["demo", "--device", "cpu"],
                                            False)):
        monkeypatch.setattr(sys, "argv", argv)
        run = functools.partial(runpy.run_module, module,
                                run_name="__main__")
        if raises:
            with pytest.raises(RuntimeError, match="CUDA"):
                _run_demo(run, monkeypatch, port_fixtures, port_gen)
        else:
            assert _run_demo(run, monkeypatch, port_fixtures, port_gen)


@pytest.mark.parametrize("name", DEMOS)
def test_demo_output_matches_the_reference_demo(name, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", ROOT / "demos" / f"{name}.py")
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    port_mod = importlib.import_module(f"suitesparse_tpu_torch.demos.{name}")
    want = _run_demo(ref_mod.main, monkeypatch, ref_fixtures, ref_gen)
    kw = {"device": "cpu"} if name in DEVICE_DEMOS else {}
    got = _run_demo(port_mod.main, monkeypatch, port_fixtures, port_gen,
                    **kw)
    wl, gl = want.strip().splitlines(), got.strip().splitlines()
    assert len(wl) == len(gl) > 0, f"{name}\n{want}\n{got}"
    for le, lg in zip(wl, gl):
        te, tg = le.split(), lg.split()
        assert len(te) == len(tg), f"{name}: {le!r} vs {lg!r}"
        for a, b in zip(te, tg):
            assert _tokens_match(a, b), f"{name}: {le!r} vs {lg!r}"
