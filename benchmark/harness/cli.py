"""The command line of the benchmark:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  It measures the cell on the card, judges
what the timed path produced, and prints one JSON line last on standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``; the compared numbers and their
limits come last, under ``checks``), after the same numbers as the last
lines of standard error.  With no card, with fewer cards than the cell
asks for, without the program's package in the checkout, or with JAX or
the JAX package loaded when the window has closed, it prints no result and
exits with a code other than 0.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
PORT = "suitesparse_tpu_torch"
# top-level module names that may not be loaded in the process that prints
# the result (JAX, and the JAX package the port was made from)
FORBIDDEN = ("jax", "jaxlib", "flax", "suitesparse_tpu")


class NoResult(Exception):
    """The run cannot give a result; the message says why."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def import_port(root: pathlib.Path):
    """The program's package, from the checkout at ``root`` and nowhere
    else."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    try:
        mod = __import__(PORT)
    except ImportError as exc:
        raise NoResult(f"the checkout holds no {PORT}: {exc}", 4) from exc
    where = pathlib.Path(mod.__file__).resolve()
    if root.resolve() not in where.parents:
        raise NoResult(f"{PORT} was imported from {where}, outside the "
                       f"checkout {root}", 4)
    return mod


def check_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoResult("no CUDA device is available", 2)
    if torch.cuda.device_count() < chips:
        raise NoResult(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are present", 2)


def power_limit_w():
    """The card's power limit in watts, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def measure(args, t0: float, root: pathlib.Path, device: str,
            port_root: pathlib.Path) -> dict:
    """One run of the cell: the result line's object."""
    from . import spec as spec_mod
    spec = spec_mod.Spec(root)
    cell = spec.cell(args.workload)
    if device == "cuda":
        check_card(int(cell["chips"]))
    import_port(port_root)
    import torch
    from suitesparse_tpu_torch.utils import cuda_build
    from .cell import Session
    cache_warm = cuda_build.library_path("block_chol").exists()
    session = Session(spec, args.workload, device, log)
    run, steps, pools = session.run(args.seed, args.seconds,
                                    bool(args.trace), t0)
    metrics = {}
    for m in spec.metrics(args.workload, bool(args.trace)):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # the other group's readings, for the log only
    for m in spec.metrics(args.workload, not args.trace):
        value = spec.reader(m["name"]).read(run)
        log(f"also {m['name']} = {value!r} {m['unit']}")
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(run.peak_bytes)}
    out = {"metrics": metrics, "device": info}
    if run.trace is not None:
        from .tracing import breakdown
        info["busy_s"] = run.trace["busy_us"] / 1e6
        info["window_s"] = run.trace["window_us"] / 1e6
        out["breakdown"] = breakdown(run.trace)
    verdict = session.judge(args.seed, steps, pools)
    checks = verdict["checks"]
    result = {"correct": bool(verdict["correct"]), "attempted": len(steps),
              "failed": int(verdict["failed"]), **out,
              "program": run.counters.get("program"),
              "kernel_cache": "warm" if cache_warm else "cold",
              "power_limit_w": power_limit_w() if dev.type == "cuda"
              else None,
              "checks": {k: {"value": _number(v), "limit": lim}
                         for k, (v, lim) in checks.items()}}
    return result


def _number(v: float):
    """A compared number for JSON: a NaN or an infinity as a string."""
    return v if math.isfinite(v) else str(v)


def main(argv=None, t0: float = None, root=None, device: str = "cuda",
         port_root=None) -> int:
    """Run the command line; returns the exit code.  ``root`` (the
    checkout holding BENCHMARK.json), ``device`` and ``port_root`` (where
    the program's package is) are for the tests, which drive the rest of a
    run on the CPU."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    root = pathlib.Path(root) if root is not None else ROOT
    port_root = pathlib.Path(port_root) if port_root is not None else root
    try:
        result = measure(args, t0, root, device, port_root)
    except NoResult as exc:
        log(f"no result: {exc}")
        return exc.code
    bad = forbidden_modules()
    if bad:
        log(f"no result: loaded when the window closed: {', '.join(bad)}")
        return 3
    for k, c in result["checks"].items():
        ok = ("ok" if isinstance(c["value"], float)
              and c["value"] <= c["limit"] else "FAILED")
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
