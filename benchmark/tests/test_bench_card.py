"""The benchmark on the card at lap3d_44 (n = 85,184, the pf program):
a traced run reads every per-layer metric of its cells from the device
trace, and the control (the program's bodies run eagerly with float32
products in TF32) comes out not correct where the program's own runs are
correct.  Marked ``gpu``: each test skips without a card.

    python -m pytest benchmark/tests -q -m gpu
"""
import json

import pytest
import torch

import bench_support as bs

CELL_CONFIG = ("lap3d_44", "laplacian_3d", {"nx": 44})


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def root(tmp_path):
    _need_card()
    root = bs.checkout(tmp_path)
    bs.add_config(root, *CELL_CONFIG)
    for traffic in ("refactor", "solve"):
        bs.add_cell(root, CELL_CONFIG[0], traffic)
    return root


@pytest.mark.gpu
@pytest.mark.parametrize("traffic,names", [
    ("refactor", {"refactorize_ms", "analyze_s", "capture_s",
                  "factor_graph_nodes", "factor_device_ms",
                  "block_chol_roofline_pct", "device_idle_pct.refactor"}),
    ("solve", {"solve_call_ms", "analyze_s", "capture_s", "solve_device_ms",
               "device_idle_pct.solve"}),
])
def test_a_traced_run_reads_every_per_layer_metric(root, capsys, traffic,
                                                   names):
    rc, res, _ = bs.run(root, capsys, f"lap3d_44.{traffic}", seconds=2,
                        trace=1, device="cuda")
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == names
    assert res["program"] == "pf"
    dev = res["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    if "block_chol_roofline_pct" in res["metrics"]:
        assert 0 < res["metrics"]["block_chol_roofline_pct"]["value"] <= 105


@pytest.mark.gpu
def test_the_control_is_not_correct(root, capsys):
    import control
    capsys.readouterr()
    control.main(["--workload", "lap3d_44.refactor", "--seconds", "2",
                  "--sound", "11,12", "--control", "13,14,15"], root=root,
                 device="cuda", port_root=bs.REPO)
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    sound = [r for r in rows if r["mode"] == "sound"]
    ctrl = [r for r in rows if r["mode"] == "control"]
    assert len(sound) == 2 and len(ctrl) == 3
    assert all(r["correct"] for r in sound)
    assert not any(r["correct"] for r in ctrl)
