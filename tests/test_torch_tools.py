"""The port's primitive and precision probes (suitesparse_tpu_torch/tools/
microbench.py, microbench_dense.py, probe_precision.py, probe_prec_e2e.py,
diag_residual.py) on the CPU at tiny shapes: every section runs, the
datasheet-peak guard raises on a timing that cannot be right, the matmul
settings come back as they were, and diag_residual's refinement history
is held against the reference tool's."""
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from suitesparse_tpu_torch.io.generators import laplacian_3d
from suitesparse_tpu_torch.tools import (ablate_pf, diag_residual,
                                         microbench, microbench_dense,
                                         probe_prec_e2e, probe_precision,
                                         profile_attrib)
from suitesparse_tpu_torch.utils import programs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# each section of microbench at a tiny size
TINY = {
    "roofline": dict(cases=((torch.float32, 64), (torch.bfloat16, 32))),
    "slice": dict(N=1 << 16, M=1 << 14),
    "gather": dict(N=1 << 12, blocks=((8, 16, 16),), rows=((16, 64),)),
    "scatter": dict(N=1 << 12, Ks=(256,)),
    "segsum": dict(L=1 << 12, K=1 << 8),
    "project": dict(cases=((2, 2, 32, 8), (1, 2, 400, 300))),
    "chol": dict(cases=((2, 16, 16), (1, 32, 8))),
}


@pytest.mark.parametrize("name", sorted(microbench.SECTIONS))
def test_microbench_section_runs_on_the_cpu(name):
    out = microbench.SECTIONS[name](CPU, reps=2, **TINY[name])
    assert out and all(np.isfinite(v["ms"]) and v["ms"] > 0
                       for v in _leaves(out))


def _leaves(d):
    if "ms" in d:
        return [d]
    return [x for v in d.values() for x in _leaves(v)]


def test_microbench_dense_runs_on_the_cpu():
    out = microbench_dense.main(((4, 8, 8), (2, 32, 0), (1, 256, 64)),
                                device="cpu", reps=2)
    assert set(out[(4, 8, 8)]) == {"chol", "trsm", "syrk", "panel_factor"}
    assert set(out[(2, 32, 0)]) == {"chol", "panel_factor"}
    assert all(r["gflops"] > 0 for row in out.values() for r in row.values())


def test_peak_guard_raises_on_a_forged_timing(monkeypatch):
    monkeypatch.setattr(microbench, "per_call_s", lambda fn, dev, reps: 1e-12)
    with pytest.raises(RuntimeError, match="float32 peak"):
        microbench.sec_roofline(CPU, cases=((torch.float32, 64),), reps=1)
    monkeypatch.setattr(microbench_dense, "per_call_s",
                        lambda fn, dev, reps: 1e-12)
    with pytest.raises(RuntimeError, match="the timing is wrong"):
        microbench_dense.main(((2, 8, 8),), device="cpu", reps=1)
    # a byte rate: held against HBM only beyond twice the L2 cache
    with pytest.raises(RuntimeError, match="hbm peak"):
        microbench.check_bytes(4e9, 4e9, 1e-3, "forged")
    assert "within L2" in microbench.check_bytes(4e9, 1e6, 1e-3, "cached")
    assert microbench.check_peak(1.0e12, "hbm", "ok") == 1.0e12


def test_probe_precision_restores_the_matmul_settings():
    torch.set_float32_matmul_precision("medium")
    try:
        out = probe_precision.main(device="cpu", m=64, reps=1)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert set(out) == {"highest", "high", "medium", "bfloat16"}
    assert out["highest"]["relerr"] < 1e-5
    # inputs rounded to bfloat16: ~2^-9 relative
    assert 1e-4 < out["bfloat16"]["relerr"] < 1e-2
    probe_precision.main(device="cpu", m=32, reps=1)
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    programs._check_precision()        # a device program may be captured


def test_device_programs_refuse_to_capture_with_tf32_on():
    with microbench.matmul_precision("high"):
        with pytest.raises(RuntimeError, match="full float32"):
            programs._check_precision()
    programs._check_precision()


def _ref_diag_residual(monkeypatch, capsys, name, steps):
    """The reference tool's residual after each step, from its output."""
    monkeypatch.delenv("SSTPU_TRSM_INV", raising=False)
    monkeypatch.delenv("SSTPU_POTRF", raising=False)
    spec = importlib.util.spec_from_file_location(
        "_ref_tool_diag_residual",
        os.path.join(ROOT, "tools", "diag_residual.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["diag_residual.py", name, str(steps)])
    capsys.readouterr()
    mod.main()
    out = capsys.readouterr().out
    return [float(v) for v in re.findall(r"step \d+: residual (\S+)", out)]


def test_diag_residual_follows_the_reference_tool(monkeypatch, capsys):
    """lap3d_10, float32 factor, CPU: step 0 within a factor of 4 of the
    reference tool's, and both at most 1e-12 by step 3."""
    want = _ref_diag_residual(monkeypatch, capsys, "lap3d_10", 3)
    got = [r for r, _, _ in diag_residual.residuals(laplacian_3d(10), 3,
                                                    device="cpu")]
    assert len(want) == len(got) == 4
    assert want[0] / 4 <= got[0] <= want[0] * 4
    assert max(want[3], got[3]) <= 1e-12


def test_diag_residual_cases_run_on_the_cpu():
    out = diag_residual.main("lap3d_6", 2, device="cpu")
    assert set(out) == set(diag_residual.CASES)
    assert all(h[-1][0] <= 1e-12 for h in out.values())


def test_probe_prec_e2e_child_process_on_the_cpu():
    out = probe_prec_e2e.main("lap3d_6", ("highest",), device="cpu")
    r = out["highest"]
    assert r["device"] == "cpu" and r["finite"]
    assert len(r["residuals"]) == probe_prec_e2e.REFINE_STEPS + 1
    assert r["residuals"][-1] <= 1e-12 and r["refactor_ms"] > 0


@pytest.mark.parametrize("call", [
    lambda: microbench.main(("chol",)),
    lambda: microbench_dense.main(((2, 8, 8),)),
    lambda: probe_precision.main(m=32),
    lambda: diag_residual.main("lap3d_6", 1),
    lambda: profile_attrib.main("lap3d_6"),
    lambda: ablate_pf.main("lap3d_6")],
    ids=["microbench", "microbench_dense", "probe_precision",
         "diag_residual", "profile_attrib", "ablate_pf"])
def test_tools_run_on_the_card_by_default_and_raise_without_one(
        monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
