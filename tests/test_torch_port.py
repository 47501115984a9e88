"""Package-level contracts of the PyTorch port: it stands alone (no jax,
no suitesparse_tpu), its entry points default to the card and raise
without one, and the parts not ported yet refuse clearly."""
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
import suitesparse_tpu_torch.cholesky
import suitesparse_tpu_torch.cholesky.kernels
import suitesparse_tpu_torch.cholesky.pf
import suitesparse_tpu_torch.cholesky.super_numeric
import suitesparse_tpu_torch.cholesky.wave
import suitesparse_tpu_torch.io.generators
import suitesparse_tpu_torch.utils.cuda_build
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


def test_unported_options_refuse():
    A, cm, sym, ss = _setup(program="wave")
    with pytest.raises(NotImplementedError, match="wave"):
        port_sn.factorize_super(A, sym, ss, common=cm, device="cpu")
    A, cm, sym, ss = _setup()
    cm.cholesky.syrk_bf16 = True
    with pytest.raises(NotImplementedError, match="syrk_bf16"):
        port_sn.factorize_super(A, sym, ss, common=cm, device="cpu")


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
