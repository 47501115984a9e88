"""The port's distributed host plan (suitesparse_tpu_torch/parallel/dist.py
``build_dist_plan``) against the JAX package's on the CPU: the same
seeded patterns at P in {2, 4, 8} give identical plans, every array and
every ``comm`` key (the "same plan first" rule: the distributed program's
offsets, schedules and rebasing all come from it).  Also the validity of
the merged slot schedule, the ``seq`` argument's check, and the entry
point's default device."""
import numpy as np
import pytest
import torch

from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.io import generators as ref_gen
from suitesparse_tpu.parallel import dist as ref_dist

from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.io import generators as port_gen
from suitesparse_tpu_torch.parallel import dist as port_dist

# the reference's timeline-model constants, its SSTPU_MODEL_GFLOPS and
# SSTPU_MODEL_DISPATCH_MS defaults (a TPU's measured rates), passed
# explicitly so that dist_model_speedup_disp is compared too
REF_MODEL = dict(model_rate=412e9, model_dispatch_s=0.37e-3)

ARRAYS = ("owner", "instr_cls", "instr_pos", "seq_pos", "top_cls",
          "top_pos", "top_solve_cls", "top_solve_pos", "a_dst_local")
SCALARS = ("ndev", "Bloc", "top_base", "Btop", "buf", "lbuf", "seq_cls",
           "top_fan", "nop_cls")


def _plans(gen, arg, ndev, monkeypatch, seq="merge", **kw):
    for var in ("SSTPU_DIST_SEQ", "SSTPU_MODEL_GFLOPS",
                "SSTPU_MODEL_DISPATCH_MS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SSTPU_DIST_SEQ", seq)
    ref = ref_dist.build_dist_plan(getattr(ref_gen, gen)(arg), ndev,
                                   ref_common(), **kw)
    port = port_dist.build_dist_plan(getattr(port_gen, gen)(arg), ndev,
                                     port_common(), seq=seq, **REF_MODEL,
                                     **kw)
    return ref, port


def _assert_same_plan(ref, port):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    for name in SCALARS:
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.root is None) == (ref.root is None)
    if ref.root is not None:
        assert port.root[:3] == ref.root[:3]
        for a, b in zip(port.root[3:], ref.root[3:]):
            np.testing.assert_array_equal(a, b)
    assert port.comm == ref.comm
    for name in ("panel_off", "panel_Np", "panel_Mp", "a_scatter_dst"):
        np.testing.assert_array_equal(getattr(port.ss, name),
                                      getattr(ref.ss, name), err_msg=name)
    assert port.ss.total == ref.ss.total
    assert port.wp.buf == ref.wp.buf and port.wp.xpad == ref.wp.xpad
    np.testing.assert_array_equal(port.wp.instr_cls, ref.wp.instr_cls)
    np.testing.assert_array_equal(port.wp.instr_pos, ref.wp.instr_pos)
    for cp, cr in zip(port.wp.classes, ref.wp.classes):
        for name in ("base", "dst", "src", "colidx", "rowidx"):
            np.testing.assert_array_equal(getattr(cp, name),
                                          getattr(cr, name), err_msg=name)


@pytest.mark.parametrize("thresholds", [{}, dict(root_2d_min=16,
                                                 root_2d_nb=16)],
                         ids=["default", "root16"])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_plan_identical_lap3d(ndev, thresholds, monkeypatch):
    ref, port = _plans("laplacian_3d", 8, ndev, monkeypatch, **thresholds)
    _assert_same_plan(ref, port)
    if thresholds:
        assert port.root is not None        # the root peel is exercised


@pytest.mark.parametrize("gen,arg,ndev,seq", [
    ("laplacian_2d", 12, 8, "merge"),
    ("fem3d", 600, 4, "merge"),              # an irregular mesh
    ("laplacian_3d", 8, 4, "level"),
    ("laplacian_3d", 10, 4, "level"),
])
def test_plan_identical_other(gen, arg, ndev, seq, monkeypatch):
    ref, port = _plans(gen, arg, ndev, monkeypatch, seq=seq,
                       root_2d_min=16, root_2d_nb=16)
    _assert_same_plan(ref, port)


def test_fanned_top_front_in_plan(monkeypatch):
    """lap3d_8 at P = 4 with the low thresholds fans one top front out
    and peels the root, so the multi-process tests reach both."""
    _ref, port = _plans("laplacian_3d", 8, 4, monkeypatch, root_2d_min=16,
                        root_2d_nb=16)
    assert len(port.top_fan) >= 1 and port.root is not None
    assert port.comm["dist_top_waves"] > 0


def test_model_speedup_disp_only_with_constants():
    A = port_gen.laplacian_3d(6)
    dp = port_dist.build_dist_plan(A, 4, port_common())
    assert "dist_model_speedup_disp" not in dp.comm
    assert "dist_model_speedup" in dp.comm
    dp = port_dist.build_dist_plan(A, 4, port_common(), model_rate=1e12,
                                   model_dispatch_s=1e-5)
    assert dp.comm["dist_model_speedup_disp"] > 0


@pytest.mark.parametrize("seq", ["merged", "MERGE", "", None])
def test_seq_outside_merge_level_raises(seq):
    with pytest.raises(ValueError, match="seq"):
        port_dist.build_dist_plan(port_gen.laplacian_3d(4), 2, port_common(),
                                  seq=seq)


@pytest.mark.parametrize("nd", [4, 8])
def test_merge_schedule_validity(nd):
    """The mirror of tests/test_parallel.py's test_merge_schedule_validity
    on the port's plan: every phase-1 wave runs exactly once on its owner
    rank, per-rank order respects the supernode-parent DAG (compaction
    included), and the merged form needs at most one slot more than the
    per-(level, class) barrier form."""
    A = port_gen.laplacian_3d(10)
    dp = port_dist.build_dist_plan(A, nd, port_common(), seq="merge")
    wp, plan, owner = dp.wp, dp.plan, dp.owner
    wave_sids, wave_owner = [], []
    for lv in plan.levels:
        for b in lv:
            for w0 in range(0, len(b.sids), b.W):
                wave_sids.append(np.asarray(b.sids[w0:w0 + b.W]))
                wave_owner.append(int(owner[int(b.sids[0])]))
    bywave = {(int(c), int(p)): wi for wi, (c, p)
              in enumerate(zip(wp.instr_cls, wp.instr_pos))}
    dead = [len(c.base) for c in wp.classes]
    slot_of = {}
    for c in range(nd):
        for t, cid in enumerate(dp.seq_cls):
            p = int(dp.seq_pos[c, t])
            if p == dead[cid]:
                continue
            wi = bywave[(cid, p)]
            assert wave_owner[wi] == c, "wave on a foreign rank"
            assert (c, wi) not in slot_of, "wave scheduled twice"
            slot_of[(c, wi)] = t
    assert len(slot_of) == sum(1 for o in wave_owner if o >= 0)
    wave_of = {}
    for wi, sd in enumerate(wave_sids):
        for s in sd.tolist():
            wave_of[int(s)] = wi
    parent = np.asarray(dp.ss.sn_parent)
    for s in range(dp.ss.nsuper):
        p = int(parent[s])
        if owner[s] < 0 or p < 0 or owner[p] != owner[s]:
            continue
        c, wu, wv = int(owner[s]), wave_of[s], wave_of[int(p)]
        if wu != wv:
            assert slot_of[(c, wu)] < slot_of[(c, wv)], (s, p)
    dp_lv = port_dist.build_dist_plan(A, nd, port_common(), seq="level")
    assert len(dp.seq_cls) <= len(dp_lv.seq_cls) + 1


def test_subtree_owner_closure():
    """Owners are etree-closed: a phase-1 supernode's parent is on the
    same rank or in the top phase, so phase 1 needs no communication."""
    dp = port_dist.build_dist_plan(port_gen.laplacian_2d(30), 8,
                                   port_common())
    parent = np.asarray(dp.ss.sn_parent)
    for s in range(dp.ss.nsuper):
        p = int(parent[s])
        if p >= 0 and dp.owner[s] >= 0:
            assert dp.owner[p] in (dp.owner[s], -1), (s, p)
    assert len(set(dp.owner[dp.owner >= 0])) == 8


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = port_gen.laplacian_3d(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_dist.distributed_factorize(A)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_dist.make_mesh()
    dp = port_dist.build_dist_plan(A, 1, port_common())
    with pytest.raises(RuntimeError, match="CUDA"):
        port_dist.dist_factor_from_numpy(dp, np.zeros((1, dp.Bloc)),
                                         np.zeros(1), dp.sym.perm)


def test_mesh_needs_a_process_group():
    """The port never creates a group itself: without one, make_mesh
    raises (the caller initializes torch.distributed and its backend)."""
    if torch.distributed.is_initialized():
        pytest.skip("a process group is already initialized")
    with pytest.raises(RuntimeError, match="process group"):
        port_dist.make_mesh(device="cpu")
