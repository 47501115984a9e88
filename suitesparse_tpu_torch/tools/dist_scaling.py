"""The distributed factorization at P = 1, 2, 4 and 8 ranks on one lap3d
pattern: the counterpart of the repository's tools/dist_scaling.py.

    python3 -m suitesparse_tpu_torch.tools.dist_scaling [nx] \\
        [--device cuda|cpu] [--reps 3]

For each P it runs P rank processes of ``multihost_dryrun`` (through
``launch``, gloo over a ``file://`` store under build/dist_scaling: P
ranks may share one device, which NCCL refuses) and prints one
line per P and one JSON line: the refactor median of the slowest rank,
its phases, the solve, the residual after one float64 refinement step,
the per-rank buffer against the global one, the padded slot ratio and the
plan's model speedup (total flops over the largest rank's subtree work
plus the replicated top plus the fanned fronts at 1/P).

Ranks placed on one device (every rank of a one-card machine, or the
CPU) take turns on it, so their times give the cost of each phase and the
per-rank memory, not scaling; the model speedup is the plan's projection
for P separate devices.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .multihost_dryrun import ROOT, launch

RANKS = (1, 2, 4, 8)
BACKEND = "gloo"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nx", type=int, nargs="?", default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    dtype = "float32" if a.device == "cuda" else "float64"
    rows = []
    for nd in RANKS:
        job = dict(backend=BACKEND, device=a.device, cases=[dict(
            kind="dist", gen="laplacian_3d", arg=a.nx, dtype=dtype,
            reps=a.reps, refine=1)])
        res = launch(nd, job, os.path.join(ROOT, "build", "dist_scaling",
                                           f"p{nd}"))
        d = [r["dist"] for r in res]
        med = {k: max(float(np.median(r["refactor_times_s"][k])) for r in d)
               for k in d[0]["refactor_times_s"]}
        comm = d[0]["comm"]
        row = dict(ndev=nd, device=res[0]["device"], backend=BACKEND,
                   factor_ms=med["dist_factor_time"] * 1e3,
                   phase_ms={k[5:-5]: v * 1e3 for k, v in med.items()
                             if k != "dist_factor_time"},
                   solve_ms=max(r["solve_s"][0] for r in d) * 1e3,
                   residual=d[0]["residuals"][-1],
                   per_rank_buf=d[0]["lbuf"], global_buf=d[0]["buf"],
                   model_speedup=comm["dist_model_speedup"],
                   pad_ratio=comm["dist_pad_ratio"],
                   phase1_waves=comm["dist_phase1_waves"],
                   padded_slots=comm["dist_phase1_padded_waves"])
        rows.append(row)
        print(f"ndev={nd}: factor {row['factor_ms']:8.1f} ms  solve "
              f"{row['solve_ms']:7.1f} ms  model speedup "
              f"{row['model_speedup']:4.2f}  pad {row['pad_ratio']:4.2f}x  "
              f"per-rank buf {row['per_rank_buf']} "
              f"({100.0 * row['per_rank_buf'] / row['global_buf']:.0f}% of "
              f"global)  residual {row['residual']:.1e}", flush=True)
    print(json.dumps({"matrix": f"lap3d_{a.nx}", "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
