"""What the benchmark's tests share: a checkout in a temporary directory
whose BENCHMARK.json runs the repository's metrics and mixes on a small
matrix, and a runner of the command line in this process.

Run the tests with ``python -m pytest benchmark/tests -q`` from the root of
the repository; the ones marked ``gpu`` need a card and skip without one.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import cli  # noqa: E402

LIMITS = {"solve_berr": 1e-5, "factor_berr": 1e-5}
BIG_SEED = 2 ** 31 + 12345


def add_cell(root: pathlib.Path, config: str, traffic: str,
             limits=None) -> str:
    """Add the cell ``<config>.<traffic>`` to the checkout's BENCHMARK.json
    and to every metric that lists a cell of the same traffic; returns its
    name."""
    name = f"{config}.{traffic}"
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1, "why": "test"})
    kinds = {w["name"]: w["traffic"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and any(kinds.get(w) == traffic
                                    for w in m["workloads"]):
            m["workloads"].append(name)
    path.write_text(json.dumps(spec, indent=1))
    (root / "benchmark" / "limits" / f"{name}.json").write_text(
        json.dumps({"limits": limits or LIMITS}))
    return name


def add_config(root: pathlib.Path, name: str, generator: str,
               params: dict, **keys) -> None:
    """Add a configuration like lap3d_64's with the generator ``generator``
    and its ``params``; ``keys`` (solver, judge, ...) replace the file's."""
    cfg = json.loads((BENCH / "configs" / "lap3d_64.json").read_text())
    cfg.update(name=name, generator=generator, params=params, **keys)
    rel = f"benchmark/configs/{name}.json"
    (root / rel).write_text(json.dumps(cfg))
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec["configs"].append({"name": name, "source": "test", "file": rel,
                            "reduced": [], "why": "test"})
    path.write_text(json.dumps(spec, indent=1))


def checkout(tmp: pathlib.Path) -> pathlib.Path:
    """The benchmark's folder and BENCHMARK.json copied under ``tmp``, with
    the cells lap3d_8.refactor and lap3d_8.solve (n = 512) added."""
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    add_config(tmp, "lap3d_8", "laplacian_3d", {"nx": 8})
    add_cell(tmp, "lap3d_8", "refactor")
    add_cell(tmp, "lap3d_8", "solve")
    return tmp


def run(root, capsys, cell: str, seed: int = BIG_SEED, seconds: float = 0.5,
        trace: int = 0, **kw) -> tuple:
    """The command line on the CPU against the checkout ``root``: (exit
    code, the last line's object or None, standard error)."""
    capsys.readouterr()
    rc = cli.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  device=kw.pop("device", "cpu"),
                  port_root=kw.pop("port_root", REPO))
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err
