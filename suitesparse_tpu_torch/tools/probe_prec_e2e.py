"""End-to-end precision A/B on the pf refactorization: the counterpart of
tools/probe_prec_e2e.py.

    python -m suitesparse_tpu_torch.tools.probe_prec_e2e [matrix] [setting ...]

For each float32 matmul precision setting (default "highest", "high",
"medium"; ``torch.set_float32_matmul_precision`` is process-wide, so each
runs in a fresh process), the child builds the matrix's pf plan (default
lap3d_28), runs the refactorization's eager body (``DeviceProgram.eager``
of ``pf_program``: a captured program refuses TF32, and that guard stays)
once to warm up and REPS times under the setting, and reports the first
call's and the median refactor's host time (each ended by a sync).  The
last factor is then solved back in full float32 (the solve programs are
captured, so the setting is reset to "highest" first) with 0-3 float64
refinement steps; the residuals after each step are reported.  Only the
factor runs under the setting.  Runs on the card unless ``device="cpu"``
is asked for.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

__all__ = ["SETTINGS", "child", "main"]

SETTINGS = ("highest", "high", "medium")
REPS = 5
REFINE_STEPS = 3
CHILD_TIMEOUT = 1200        # s a setting's process may take
ROOT = pathlib.Path(__file__).resolve().parents[2]


def child(setting: str, name: str, device: str) -> dict:
    """One setting's run, in this process (see the module's doc)."""
    import torch
    from ..cholesky import residual_norm
    from ..cholesky.pf import pf_program
    from ..cholesky.super_numeric import SuperFactor, solve_super
    from ..utils.device import resolve_device
    from .microbench import matmul_precision
    from .profile_attrib import pf_setup
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    A, sym, pfp, vals = pf_setup(name, dev)
    prog = pf_program(pfp, np.float32, device=dev)
    times = []
    with matmul_precision(setting):
        for _ in range(REPS + 1):
            sync()
            t0 = time.perf_counter()
            Lx = prog.eager(vals)
            sync()
            times.append(time.perf_counter() - t0)
    n = A.ncol
    f = SuperFactor(plan=pfp.plan, Lx=Lx, perm=sym.perm, minor=n,
                    dtype=np.float32)
    b = np.ones(n)
    Sf = A.to_scipy().astype(np.float64)
    x = solve_super(f, b, "A").astype(np.float64)
    hist = [residual_norm(A, x, b)]
    for _ in range(REFINE_STEPS):
        x = x + solve_super(f, b - Sf @ x, "A").astype(np.float64)
        hist.append(residual_norm(A, x, b))
    return dict(setting=setting, matrix=name, device=str(dev),
                first_s=times[0], refactor_ms=float(np.median(times[1:]))
                * 1e3, refactor_ms_all=[t * 1e3 for t in times[1:]],
                gflops=sym.flops / np.median(times[1:]) / 1e9,
                residuals=hist, finite=bool(torch.isfinite(Lx).all()))


def main(name: str = "lap3d_28", settings=SETTINGS, device=None) -> dict:
    """Run each setting's child process on ``device`` (the card unless
    "cpu" is asked for) and print one line each; a child that fails
    raises with its error output."""
    dev = "cuda" if device is None else str(device)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else [])))
    out = {}
    for setting in settings:
        p = subprocess.run(
            [sys.executable, "-m", "suitesparse_tpu_torch.tools.probe_prec_e2e",
             "--child", setting, name, dev], cwd=str(ROOT), env=env,
            capture_output=True, text=True, timeout=CHILD_TIMEOUT)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT:")]
        if p.returncode or not lines:
            raise RuntimeError(f"probe_prec_e2e {setting}: rc={p.returncode}"
                               f"\n{p.stderr[-2000:]}")
        r = out[setting] = json.loads(lines[-1][len("RESULT:"):])
        res = " -> ".join(f"{v:.1e}" for v in r["residuals"])
        print(f"{setting:8s} ({r['device']}): first {r['first_s']:6.2f} s  "
              f"refactor {r['refactor_ms']:8.2f} ms ({r['gflops']:6.1f} GF/s)"
              f"  residual {res}", flush=True)
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print("RESULT:" + json.dumps(child(*sys.argv[2:5])), flush=True)
    else:
        main(sys.argv[1] if len(sys.argv) > 1 else "lap3d_28",
             tuple(sys.argv[2:]) or SETTINGS)
