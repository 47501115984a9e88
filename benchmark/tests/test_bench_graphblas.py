"""The kron_g500 configuration on the CPU: the spec finds its files, a
cell of it runs through the command line at scale 10 (n = 1,024) and the
float64 answers pass the judge with the limits far to spare, the
reference's loop in bfloat16 and the iterate before the answer's count
fail it, a dtype the program does not run is refused, and the PageRank
metrics read the window's calls and None where a run holds nothing for
them."""
import json
import types

import numpy as np
import pytest
import torch

import bench_support as bs
from harness import cell as cell_mod, counts, pr_counts, spec as spec_mod
from harness import tracing, traffic

CONFIG = "kron_g500"
SMALL = "kron_g500_10"
CELL = f"{CONFIG}.pagerank"
METRICS = ("pr_device_ms", "pr_spmv_roofline_pct", "pr_steps_run",
           "pr_download_ms")


def _checkout(tmp_path, **keys):
    """A checkout with the cell kron_g500_10.pagerank: kron_g500's
    configuration at scale 10 (``keys`` replace the file's), under
    kron_g500.pagerank's limits."""
    root = bs.checkout(tmp_path)
    cfg = json.loads((bs.BENCH / "configs" / f"{CONFIG}.json").read_text())
    cfg.update(name=SMALL, params=dict(cfg["params"], scale=10), **keys)
    rel = f"benchmark/configs/{SMALL}.json"
    (root / rel).write_text(json.dumps(cfg))
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec["configs"].append({"name": SMALL, "source": "test", "file": rel,
                            "reduced": [], "why": "test"})
    path.write_text(json.dumps(spec, indent=1))
    bs.add_cell(root, SMALL, "pagerank",
                limits=spec_mod.Spec(bs.REPO).limits(CELL))
    return root


def _kron(scale):
    """kron_g500's graph (its strictly lower triangle) at ``scale``."""
    spec = spec_mod.Spec(bs.REPO)
    cfg = spec.config(CONFIG)
    return spec.generator(cfg["generator"]).make(
        **dict(cfg["params"], scale=scale))


def test_the_spec_loads_the_config_mix_cell_and_limits():
    spec = spec_mod.Spec(bs.REPO)
    w = spec.cell(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "pagerank", 1)
    cfg = spec.config(CONFIG)
    assert (cfg["solver"], cfg["judge"], cfg["dtype"], cfg["tf32"]) == (
        "graphblas", "pagerank", "float32", False)
    assert cfg["scale"] == cfg["params"]["scale"] == 25
    assert cfg["n"] == 2 ** cfg["scale"]
    mix = traffic.full(spec.mix("pagerank"), "pagerank")
    assert (mix["step"], mix["setup"], mix["value_sets"],
            mix["rhs_pool"]) == ("pagerank", ["pagerank"], 1, 1)
    # the mix's kernel is the one the judge holds the answers to
    ref = spec.judge("pagerank")
    assert (mix["damping"], mix["tol"], mix["max_iter"]) == (
        ref.DAMPING, ref.TOL, ref.MAX_ITER)
    assert set(spec.limits(CELL)) == {"pr_l1_err", "pr_iter_gap"}
    assert spec.limits(CELL)["pr_iter_gap"] == 1
    e2e = {m["name"] for m in spec.metrics(CELL, False)}
    assert e2e == {"setup_s", "solve_step_ms", "peak_mem_gib"}
    per_layer = {m["name"] for m in spec.metrics(CELL, True)}
    assert set(METRICS) | {"analyze_s", "capture_s"} == per_layer
    for name in METRICS:
        spec.reader(name)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_the_float64_answer_passes(tmp_path, capsys,
                                                     trace):
    root = _checkout(tmp_path, dtype="float64")
    rc, res, err = bs.run(root, capsys, f"{SMALL}.pagerank", trace=trace)
    assert rc == 0 and res["correct"] is True, err
    assert res["failed"] == 0 and res["program"] == "pagerank"
    c = res["checks"]
    assert c["pr_iter_gap"]["value"] == 0
    assert 0 <= c["pr_l1_err"]["value"] <= 1e-6 * c["pr_l1_err"]["limit"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    if trace:
        # the device's metrics need a card
        assert set(got) == {"pr_steps_run", "pr_download_ms", "analyze_s"}
        assert got["pr_steps_run"] % 8 == 0 and got["pr_steps_run"] >= 8
        assert got["pr_download_ms"] > 0
    else:
        assert set(got) == {"setup_s", "solve_step_ms"}


def _judged(L, answers):
    """The cell's judge on the CPU against its limits: (values, limits)."""
    spec = spec_mod.Spec(bs.REPO)
    case = types.SimpleNamespace(A0=L, answers=answers,
                                 device=torch.device("cpu"))
    return spec.judge("pagerank").judge(case)["values"], spec.limits(CELL)


def test_the_judge_fails_the_ranks_in_bfloat16():
    """The control: the reference's own loop in bfloat16 put in the
    program's place reads far past pr_l1_err's limit."""
    ref = spec_mod.Spec(bs.REPO).judge("pagerank")
    L = _kron(10)
    k, r = ref.ranks(ref.Graph(L, torch.device("cpu"), torch.bfloat16))
    got, lim = _judged(L, [(k, r.float().numpy())])
    assert got["pr_l1_err"] > 100 * lim["pr_l1_err"], got


def test_the_judge_fails_the_iterate_before_the_answers_count():
    """A program that drops its last update: the reference's iterate
    k - 1 labelled k fails pr_l1_err, though its distance to iterate k is
    within the stop tolerance; iterate k itself passes."""
    ref = spec_mod.Spec(bs.REPO).judge("pagerank")
    L = _kron(10)
    g = ref.Graph(L, torch.device("cpu"))
    k, r = ref.ranks(g)
    prev = next(x for i, x, _ in ref.iterates(g) if i == k - 1)
    assert float((r - prev).abs().sum()) <= ref.TOL
    got, lim = _judged(L, [(k, prev.numpy())])
    assert got["pr_l1_err"] > 10 * lim["pr_l1_err"], got
    got, _ = _judged(L, [(k, r.numpy())])
    assert got == {"pr_l1_err": 0.0, "pr_iter_gap": 0.0}


def test_a_dtype_the_program_does_not_run_fails_at_once(tmp_path, capsys):
    """The configuration's dtype is the program's on the device: a
    bfloat16 configuration on the CPU (which runs float64) is refused in
    set-up."""
    root = _checkout(tmp_path, dtype="bfloat16")
    with pytest.raises(ValueError, match="dtype bfloat16"):
        bs.run(root, capsys, f"{SMALL}.pagerank")


def _run(counters=None, trace=None, device="cpu"):
    import torch
    return cell_mod.Run(cell={}, config={}, mix={},
                        device=torch.device(device),
                        spans=tracing.Spans(),
                        counters=counters or {}, trace=trace)


def test_each_metric_reads_none_where_the_run_holds_nothing():
    spec = spec_mod.Spec(bs.REPO)
    trace = {"calls": {"solve": 3}, "graph_busy_us": {"solve": 3e5}}
    other = {"program": "cholesky"}
    setup_only = {"program": "pagerank", "n": 1000, "arcs": 30000,
                  "itemsize": 4, "phases": {"setup": dict(
                      calls=1, iterations=10, steps_run=16, program_runs=2)}}
    for name in METRICS:
        read = spec.reader(name).read
        assert read(_run()) is None, name
        assert read(_run(other, trace, "cuda")) is None, name
    for name in ("pr_spmv_roofline_pct", "pr_steps_run"):
        assert spec.reader(name).read(_run(setup_only, trace, "cuda")) \
            is None, name
    # a run of this program on the card: the window's and the traced
    # calls' counts, not set-up's
    c = dict(setup_only, phases=dict(
        setup_only["phases"],
        window=dict(calls=4, iterations=40, steps_run=96, program_runs=12),
        traced=dict(calls=5, iterations=50, steps_run=120,
                    program_runs=15)))
    run = _run(c, trace, "cuda")
    assert spec.reader("pr_device_ms").read(run) == 100.0
    assert spec.reader("pr_steps_run").read(run) == 24
    least = 10 * (4 * 30000 + 1000 * 16) / counts.PEAK_HBM_BYTES
    assert least == pr_counts.pagerank_least_s(1000, 30000, 10, 4)
    pct = spec.reader("pr_spmv_roofline_pct").read(run)
    assert pct == pytest.approx(100 * least / 0.1)
    # a time below the count's least raises
    fast = _run(c, {"calls": {"solve": 1}, "graph_busy_us": {"solve": 1e-3}},
                "cuda")
    with pytest.raises(RuntimeError):
        spec.reader("pr_spmv_roofline_pct").read(fast)
