"""The control of a cell's judge, and the program's readings on many seeds,
in one process:

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        [--sound <seed,...>] [--control <seed,...>]

For each ``--sound`` seed, a run of the cell as the benchmark makes it
(set-up once for all seeds); for each ``--control`` seed, the same run with
the program computing one precision below the configuration's: float32
products in TF32.  The program captures float32 products in full float32
only (``utils/programs.py`` refuses TF32 at capture), so the control runs
each device program's body eagerly, through the same front end, with
``torch.backends.cuda.matmul.allow_tf32`` on.  One JSON line per seed:
the numbers the judge compares, their limits and ``correct``.  The control
has to come out not correct.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from harness import cli  # noqa: E402


@contextlib.contextmanager
def tf32_eager():
    """Every device program runs its body eagerly, with float32 products
    in TF32."""
    import torch
    from suitesparse_tpu_torch.utils import programs
    P = programs.DeviceProgram
    saved = (P.__call__, P.prepare, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)

    def call(self, *inputs):
        return programs._tree_map(torch.clone, self.eager(*inputs))

    P.__call__ = call
    P.prepare = lambda self, *inputs: None
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (P.__call__, P.prepare, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(session, seed: int, seconds: float, mode: str) -> dict:
    t = time.perf_counter()
    run, steps, pools = session.run(seed, seconds, False, t)
    verdict = session.judge(seed, steps, pools, close=False)
    checks = verdict["checks"]
    return {"seed": seed, "mode": mode, "steps": len(steps),
            "step_ms": 1e3 * run.window_s / max(len(steps), 1),
            "correct": verdict["correct"],
            "failed": verdict["failed"],
            "checks": {k: {"value": cli._number(v), "limit": lim}
                       for k, (v, lim) in checks.items()}}


def main(argv=None, root=None, device: str = "cuda", port_root=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sound", type=seeds, default=[])
    p.add_argument("--control", type=seeds, default=[])
    args = p.parse_args(argv)
    root = pathlib.Path(root) if root is not None else cli.ROOT
    from harness import spec as spec_mod
    spec = spec_mod.Spec(root)
    if device == "cuda":
        cli.check_card(int(spec.cell(args.workload)["chips"]))
    cli.import_port(pathlib.Path(port_root) if port_root else root)
    from harness.cell import Session
    session = Session(spec, args.workload, device, cli.log)
    for s in args.sound:
        print(json.dumps(readings(session, s, args.seconds, "sound")),
              flush=True)
    for s in args.control:
        with tf32_eager():
            print(json.dumps(readings(session, s, args.seconds, "control")),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
