"""``BENCHMARK.json`` and the files the harness finds by the names in it.

Under the benchmark's folder (``<root>/benchmark``):

configs/<config>.json       the configuration: generator, its parameters,
                            solver, judge (``backward_error`` if left
                            out), dtype, TF32 switch (the file named in
                            BENCHMARK.json's ``configs``)
generators/<generator>.py   ``make(**params)``: the matrix, SciPy CSC
                            (a symmetric one stored in full)
solvers/<solver>.py         ``Driver(A0, config, device, spans)``: the
                            program's front end as users call it, with
                            ``analyze()``, ``set_values(values)``, a method
                            ``step_<step>(pools, i)`` for each step a mix
                            names (returns the answer: value set,
                            right-hand side, solution), ``counters()``,
                            ``factor()`` (the claim the judge checks, or
                            None) and ``close()``
mixes/<traffic>.json        the traffic mix's parameters (harness.traffic)
reference/<judge>.py        ``judge(case)``: the plain reference's numbers
                            for the answers and the factor of a run
                            (harness.cell.Case), {"values": {name: number},
                            "per_answer": {name: one number an answer}}
limits/<cell>.json          the limit of each number the cell's judge
                            returns
metrics/<metric>.py         ``read(run)``: one metric, or None where the
                            run holds nothing to read

A configuration, a front end with its steps, a judge, a mix, a metric or a
cell is added by adding its files and its entries in BENCHMARK.json; no
file of the harness changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_module(path: pathlib.Path, prefix: str):
    """The Python file ``path`` imported as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """The benchmark of the checkout at ``root``."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.dir = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def _name(self, name: str) -> str:
        if not NAME.match(name):
            raise ValueError(f"not a name: {name!r}")
        return name

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(has {sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        entry = self.configs[self._name(name)]
        return json.loads((self.root / entry["file"]).read_text())

    def mix(self, name: str) -> dict:
        path = self.dir / "mixes" / f"{self._name(name)}.json"
        return json.loads(path.read_text())

    def limits(self, cell: str) -> dict:
        path = self.dir / "limits" / f"{self._name(cell)}.json"
        return json.loads(path.read_text())["limits"]

    def generator(self, name: str):
        return load_module(self.dir / "generators" / f"{self._name(name)}.py",
                           "bench_generator_")

    def solver(self, name: str):
        return load_module(self.dir / "solvers" / f"{self._name(name)}.py",
                           "bench_solver_")

    def judge(self, name: str):
        return load_module(self.dir / "reference" / f"{self._name(name)}.py",
                           "bench_judge_")

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics a run of ``cell`` reports: with ``trace`` the
        per-layer ones, else the end-to-end ones; a metric with a
        ``workloads`` key only in the cells it lists."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{self._name(metric)}.py",
                           "bench_metric_")
