"""The port's phase scopes against the reference's named scopes, the
attribution of a device trace by scope, and the ablation tool, on the CPU
(suitesparse_tpu_torch/cholesky/pf.py, tools/profile_attrib.py,
tools/ablate_pf.py).

The reference's labels are read as tools/profile_attrib.py reads them:
its scope pattern over the text of the lowered ``_pf_program_unroll``
(float64, potrf="xla", the CPU route), here with the location info that
carries the ``jax.named_scope`` labels.  The port's are the
``record_function`` ranges of one profiled eager pf body.

lap3d_10's default plan has no mode-2 (1-hop scatter) class: the
reference's cost model, with its TPU constants, prefers the projection on
every small generated pattern.  lap3d_6 with Common.cholesky.pf_mode =
"scatter" is the matrix that covers ``Fscat``."""
import collections
import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.cholesky import pf as ref_pf
from suitesparse_tpu.cholesky import super_numeric as ref_sn
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.cholesky import pf as port_pf
from suitesparse_tpu_torch.cholesky import super_numeric as port_sn
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.io import generators as port_gen
from suitesparse_tpu_torch.tools import ablate_pf
from suitesparse_tpu_torch.tools import profile_attrib as attrib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (grid edge, Common.cholesky options)
MATRICES = {"lap3d_10": (10, {}),
            "lap3d_6_scatter": (6, {"pf_mode": "scatter"})}


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(chol, gens, common, sn, pf, key):
    k, opts = MATRICES[key]
    A = gens.laplacian_3d(k)
    cm = common()
    cm.cholesky.supernodal = "supernodal"
    for name, v in opts.items():
        setattr(cm.cholesky, name, v)
    sym = chol.analyze(A, cm)
    ss = chol.super_symbolic(A, sym, cm)
    plan = sn.build_plan(ss)
    return ss, pf.build_pf_plan(plan, cm), sn._assemble_values(
        A, sym, ss, np.float64)


def _ref_labels(key):
    ss, pfp, vals = _setup(ref_chol, ref_gen, ref_common, ref_sn, ref_pf, key)
    a_src, a_dst = ref_sn._a_sorted_maps(ss)
    seq = tuple((int(c), int(p))
                for c, p in zip(pfp.instr_cls, pfp.instr_pos))
    txt = ref_pf._pf_program_unroll.lower(
        jnp.asarray(vals), jnp.asarray(a_src), jnp.asarray(a_dst), seq,
        pfp.arrays(np.float64), pfp.meta, pfp.buf, False,
        ref_pf._tri_inv_enabled(), "xla").as_text(debug_info=True)
    return set(_ref_tool("profile_attrib").SCOPE_RE.findall(txt))


def _port_ranges(key):
    _, pfp, vals = _setup(port_chol, port_gen, port_common, port_sn, port_pf,
                          key)
    prog = port_pf.pf_program(pfp, np.float64, device="cpu")
    res = attrib.attribute_pf(prog, torch.as_tensor(vals))
    assert res["device"] == "cpu" and "eager" not in res
    return pfp, collections.Counter(res["scope_ranges"])


@pytest.mark.parametrize("key", sorted(MATRICES))
def test_scope_labels_equal_the_references(key):
    """The assembly and factor-wave labels are the reference's; each pair
    class the reference labels Qgather/QplaceW/QplaceR/Qeinsum/Qscat +
    f"{Mbc}g{G}" is the port's one Qextend + f"{Mbc}g{G}" (the extend-add
    kernel)."""
    want = _ref_labels(key)
    _, got = _port_ranges(key)
    ref_q = {w for w in want if w.startswith("Q")}
    classes = {re.fullmatch(r"Q[A-Za-z]+?(\d+g\d+)", w).group(1)
               for w in ref_q}
    assert set(got) == (want - ref_q) | {f"Qextend{c}" for c in classes}
    assert any(w.startswith("Fscat") for w in want) == (key ==
                                                        "lap3d_6_scatter")
    assert any(w.startswith("Q") for w in want) == (key == "lap3d_10")


def _expected_ranges(pfp):
    """Ranges per label from the plan: each factor instruction enters
    Fslice, Fpotrf, Fwrite, with below rows Fsyrk, in mode 2 Fscat; each
    pair instruction Qextend once; the program enters Assemble once."""
    want = collections.Counter({"Assemble": 1})
    nf, npc = len(pfp.fmeta), len(pfp.pmeta)
    for cid in pfp.instr_cls.tolist():
        if cid < nf:
            Np, Mb, W, mode, L, K = pfp.fmeta[cid]
            kinds = ["Fslice", "Fpotrf", "Fwrite"] + ["Fsyrk"] * bool(Mb) \
                + ["Fscat"] * bool(Mb and mode == 2 and L)
            for k in kinds:
                want[f"{k}{Np}x{Mb}"] += 1
        else:
            Mbc, G = pfp.qmeta[cid - nf - npc][:2]
            want[f"Qextend{Mbc}g{G}"] += 1
    return want


@pytest.mark.parametrize("key", sorted(MATRICES))
def test_scope_ranges_once_per_instruction_of_their_class(key):
    pfp, got = _port_ranges(key)
    assert got == _expected_ranges(pfp)
    if key == "lap3d_6_scatter":
        assert any(m[3] == 2 and m[4] for m in pfp.fmeta)


def _ev(cat, name, tid, ts, dur=None, corr=None):
    e = dict(cat=cat, name=name, tid=tid, ts=ts, ph="X")
    if dur is not None:
        e["dur"] = dur
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _synthetic_trace():
    """Thread 1: an outer range that is no scope holding Fpotrf8x8, which
    holds Qeinsum8g2; a torch operator around one launch; a ctypes-style
    launch with no operator around it; a launch outside every scope.
    Thread 2: a launch at a time thread 1's scopes cover.  One kernel has
    no launch record.  A device-side annotation must be ignored."""
    return [
        _ev("user_annotation", "refactor", 1, 0.0, 100.0),
        _ev("user_annotation", "Fpotrf8x8", 1, 10.0, 30.0),
        _ev("user_annotation", "Qeinsum8g2", 1, 15.0, 5.0),
        _ev("cpu_op", "aten::mm", 1, 11.0, 2.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 12.0, 1.0, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 16.0, 1.0, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 30.0, 1.0, corr=3),
        _ev("cuda_driver", "cuLaunchKernel", 1, 50.0, 1.0, corr=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 20.0, 1.0, corr=5),
        _ev("gpu_user_annotation", "Fpotrf8x8", 7, 100.0, 50.0),
        _ev("kernel", "ampere_sgemm_32x32", 7, 100.0, 10.0, corr=1),
        _ev("kernel", "elementwise_kernel", 7, 110.0, 4.0, corr=2),
        _ev("kernel", "block_chol_kernel<float>", 7, 114.0, 6.0, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoD", 7, 120.0, 2.0, corr=4),
        _ev("kernel", "index_put_kernel", 8, 121.0, 3.0, corr=5),
        _ev("kernel", "copy_kernel", 7, 130.0, 5.0, corr=6),
    ]


def test_attribute_joins_kernels_to_the_innermost_scope_of_their_launch():
    ops = attrib.attribute(_synthetic_trace())
    got = {op.name: (op.scope, op.launched) for op in ops}
    assert got == {
        "ampere_sgemm_32x32": ("Fpotrf8x8", True),
        "elementwise_kernel": ("Qeinsum8g2", True),
        "block_chol_kernel<float>": ("Fpotrf8x8", True),
        "Memcpy DtoD": (None, True),
        "index_put_kernel": (None, True),
        "copy_kernel": (None, False)}
    s = attrib.summarize(ops)
    assert s["ops"] == 6 and s["total_ms"] == pytest.approx(0.030)
    # the union of 100-122, 121-124 and 130-135
    assert s["busy_ms"] == pytest.approx(0.029)
    assert s["phase_ms"] == pytest.approx({"Fpotrf": 0.016, "Qeinsum": 0.004,
                                           "(unattributed)": 0.010})
    assert s["attributed_share"] == pytest.approx(20.0 / 30.0)
    assert s["cross_count"]["Fpotrf"] == {"gemm": 1, "block_chol": 1}
    assert s["cross_ms"]["(unattributed)"] == pytest.approx(
        {"cat/copy": 0.007, "index/scatter": 0.003})
    assert s["no_launch_record"] == 1
    assert set(s["unattributed_ms"]) == {"Memcpy DtoD", "index_put_kernel",
                                         "copy_kernel"}


def _port_plan(k, **opts):
    A = port_gen.laplacian_3d(k)
    cm = port_common()
    cm.cholesky.supernodal = "supernodal"
    for name, v in opts.items():
        setattr(cm.cholesky, name, v)
    sym = port_chol.analyze(A, cm)
    ss = port_chol.super_symbolic(A, sym, cm)
    pfp = port_sn.build_plan(ss).pf_plan(cm)
    vals = torch.as_tensor(port_sn._assemble_values(A, sym, ss, np.float64))
    return pfp, vals


def test_ablation_full_is_pf_numeric_bit_for_bit():
    pfp, vals = _port_plan(10)
    full = ablate_pf.variant_program(pfp, "full", np.float64, "cpu")
    want = port_pf.pf_numeric(vals, pfp, np.float64, device="cpu")
    assert torch.equal(full(vals), want)


def test_ablation_noproj_drops_exactly_the_projections():
    pfp, vals = _port_plan(10)
    nf = len(pfp.fmeta)
    stream = list(zip(pfp.instr_cls.tolist(), pfp.instr_pos.tolist()))
    kept = ablate_pf.instructions(pfp, "noproj")
    assert kept == [(c, p) for c, p in stream if c < nf]
    assert len(stream) - len(kept) == sum(c >= nf for c, _ in stream) > 0
    assert all(ablate_pf.instructions(pfp, v) == stream
               for v in ablate_pf.VARIANTS if v != "noproj")
    with pytest.raises(ValueError, match="unknown variant"):
        ablate_pf.instructions(pfp, "nothing")


@pytest.mark.parametrize("opts", [{}, {"pf_mode": "scatter"}])
def test_every_ablation_variant_runs(opts):
    """Each variant's body on the CPU at lap3d_6 (the scatter plan for
    noscat), timed in one pair with full; full is checked against
    pf_program inside ``ablate``."""
    pfp, vals = _port_plan(6, **opts)
    res = ablate_pf.ablate(pfp, vals, pairs=1)
    assert set(res) == set(ablate_pf.VARIANTS) - {"full"}
    assert all(r["ms"] > 0 and r["full_ms"] > 0 for r in res.values())


def test_idle_by_range_gives_idle_time_to_the_innermost_host_range():
    """Window 0-100 on thread 1: a refactorize call holding three program
    spans, a solve call holding one; device busy 35-55 and 68-72 (and a
    kernel after the window).  A range of another thread is no host range
    of the window's."""
    events = [
        _ev("user_annotation", "bench.window", 1, 0.0, 100.0),
        _ev("user_annotation", "bench.refactorize", 1, 10.0, 50.0),
        _ev("user_annotation", "super.factorize.assemble", 1, 12.0, 18.0),
        _ev("user_annotation", "super.factorize.program", 1, 30.0, 10.0),
        _ev("user_annotation", "super.factorize.wait", 1, 40.0, 18.0),
        _ev("user_annotation", "bench.solve", 1, 65.0, 25.0),
        _ev("user_annotation", "super.solve.upload", 1, 66.0, 4.0),
        _ev("user_annotation", "other", 2, 0.0, 100.0),
        _ev("cuda_runtime", "cudaGraphLaunch", 1, 31.0, 1.0, corr=1),
        _ev("kernel", "gemm", 7, 35.0, 20.0, corr=1),
        _ev("gpu_memcpy", "Memcpy HtoD", 7, 68.0, 4.0),
        _ev("kernel", "late", 7, 120.0, 10.0),
    ]
    got = attrib.idle_by_range(events, window="bench.window")
    assert got["window_us"] == 100.0 and got["busy_us"] == 24.0
    assert got["idle_us"] == pytest.approx({
        "bench.window": 25.0, "bench.refactorize": 4.0,
        "super.factorize.assemble": 18.0, "super.factorize.program": 5.0,
        "super.factorize.wait": 3.0, "bench.solve": 19.0,
        "super.solve.upload": 2.0})
    assert sum(got["idle_us"].values()) == pytest.approx(100.0 - 24.0)
    assert got["ranges"]["super.factorize.wait"] == 1
    assert "other" not in got["ranges"]
    # without a window: the extent of the device ops (35-130), on the
    # thread with the most ranges
    got = attrib.idle_by_range(events)
    assert got["window_us"] == 95.0 and got["busy_us"] == 34.0
    with pytest.raises(ValueError, match="no range"):
        attrib.idle_by_range(events, window="bench.missing")
