"""The port's pass-forward factor program (suitesparse_tpu_torch/cholesky/
pf.py) against the JAX reference's pf_numeric, f64 on the CPU, and its
extend-add (the pair projections' placement) against the one-hot chain it
replaced.

Same plan, same panels: the port's flat buffer must match the reference's
entry by entry to 1e-13 relative (the two differ only in the order of
floating-point sums, and the port factors every diagonal block through
panel_factor/block_chol where the reference's CPU default takes XLA's
cholesky)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.cholesky import pf as ref_pf
from suitesparse_tpu.cholesky import super_numeric as ref_sn
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.core.status import Status as RefStatus
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.cholesky import pf as port_pf
from suitesparse_tpu_torch.cholesky import super_numeric as port_sn
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.core.status import Status as PortStatus
from suitesparse_tpu_torch.io import generators as port_gen


def _both(gen, arg, **opts):
    """(reference, port) of (plan, pf plan, assembled f64 values)."""
    out = []
    for chol, gens, common, sn, pf in (
            (ref_chol, ref_gen, ref_common, ref_sn, ref_pf),
            (port_chol, port_gen, port_common, port_sn, port_pf)):
        A = getattr(gens, gen)(arg)
        cm = common()
        cm.cholesky.supernodal = "supernodal"
        for k, v in opts.items():
            setattr(cm.cholesky, k, v)
        sym = chol.analyze(A, cm)
        ss = chol.super_symbolic(A, sym, cm)
        plan = sn.build_plan(ss)
        out.append((plan, pf.build_pf_plan(plan, cm),
                    sn._assemble_values(A, sym, ss, np.float64)))
    return out


def _rel(got, want, total):
    return (np.abs(got[:total] - want[:total]).max()
            / max(np.abs(want[:total]).max(), 1.0))


@pytest.mark.parametrize("gen,arg", [("laplacian_2d", 20),
                                     ("laplacian_3d", 8),
                                     ("laplacian_3d", 12)])
@pytest.mark.parametrize("mode", ["project", "scatter", "auto"])
def test_pf_numeric_matches_reference(gen, arg, mode):
    (rp, rq, rv), (pp, pq, pv) = _both(gen, arg, pf_mode=mode)
    want = np.asarray(ref_pf.pf_numeric(rv, rq, np.float64))
    got = port_pf.pf_numeric(pv, pq, np.float64, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (pq.buf,)
    assert _rel(got.numpy(), want, rp.total) < 1e-13


def test_pf_numeric_matches_reference_pallas(monkeypatch):
    """Reference run through its Pallas panel factor (interpret mode)."""
    monkeypatch.setenv("SSTPU_POTRF", "pallas")
    (rp, rq, rv), (pp, pq, pv) = _both("laplacian_3d", 8)
    want = np.asarray(ref_pf.pf_numeric(rv, rq, np.float64))
    got = port_pf.pf_numeric(pv, pq, np.float64, device="cpu").numpy()
    assert _rel(got, want, rp.total) < 1e-13


def test_pf_refactorization_is_repeatable_and_reuses_plan():
    """Values change, pattern fixed: the same plan gives the new factor,
    and a repeated factorization is bit-identical."""
    (_, _, _), (pp, pq, pv) = _both("laplacian_3d", 8)
    F1 = port_pf.pf_numeric(pv, pq, np.float64, device="cpu")
    F1b = port_pf.pf_numeric(pv, pq, np.float64, device="cpu")
    F2 = port_pf.pf_numeric(pv * 4.0, pq, np.float64, device="cpu")
    assert torch.equal(F1, F1b)
    t = pp.total
    assert torch.allclose(F2[:t], 2.0 * F1[:t], rtol=0, atol=1e-12)


@pytest.mark.parametrize("gen,arg", [("laplacian_3d", 12),
                                     ("laplacian_3d", 16)])
def test_pf_numeric_bf16_matches_reference(gen, arg):
    """syrk_bf16 at both of its pf sites -- the factor step's SYRK and the
    pair projection's placement (laplacian_3d(16) has pair instructions
    of every kind, one-hot and gather placement both) -- in float64:
    1e-12 relative to the reference's bfloat16 run, and visibly off the
    plain factor."""
    (rp, rq, rv), (pp, pq, pv) = _both(gen, arg)
    assert len(pq.qmeta) > 0
    want = np.asarray(ref_pf.pf_numeric(rv, rq, np.float64, syrk_bf16=True))
    got = port_pf.pf_numeric(pv, pq, np.float64, syrk_bf16=True,
                             device="cpu").numpy()
    assert _rel(got, want, rp.total) < 1e-12
    plain = port_pf.pf_numeric(pv, pq, np.float64, device="cpu").numpy()
    assert 1e-6 < _rel(got, plain, rp.total) < 1e-2


# -- the extend-add of the pair projections against the one-hot chain ------

def _onehot_chain(Fx, ops, k, meta, bf16):
    """Instruction k of a pair class placed as pf placed it before the
    extend-add kernel, kept here as the reference: the slab gather (span
    or by offset), the one-hot Wh, the row placement (a one-hot product up
    to Mbc 256, a row gather above), the contractions against Wh, and a
    contiguous read-modify-write or a slab scatter-add that drops the
    slabs past the buffer."""
    Mbc, G, Pq, Npt, Mbt, pc, uc, spanq = meta
    Mft, ssz, buf = Npt + Mbt, Mbc * Mbc, Fx.numel()
    idxf = torch.as_tensor(ops["idxf"][k], dtype=torch.int64)
    if spanq:
        g0 = int(ops["g0"][k])
        slab = Fx[g0:g0 + spanq * ssz].view(spanq, ssz)
        Uc = slab[torch.as_tensor(ops["gsel"][k].reshape(-1),
                                  dtype=torch.int64)]
    else:
        Uc = Fx[torch.as_tensor(ops["uoff"][k])[..., None]
                + torch.arange(ssz)]
    Uc = Uc.reshape(Pq, G, Mbc, Mbc)
    Wh = (idxf[..., None] == torch.arange(Mbc)).to(Fx.dtype)
    if Mbc <= 256:
        R = Wh @ Uc
    else:
        Ucz = torch.cat([Uc, Uc.new_zeros((Pq, G, 1, Mbc))], dim=2)
        R = torch.gather(Ucz, 2, idxf[..., None].expand(Pq, G, Mft, Mbc))
    if bf16:
        R = R.to(torch.bfloat16).to(Fx.dtype)

    def land(dst, contiguous, L, patch):
        if contiguous:
            d0 = int(dst[0])
            Fx[d0:d0 + Pq * L] += patch.reshape(-1)
            return
        for p in range(Pq):
            d = int(dst[p])
            if d + L <= buf:
                Fx[d:d + L] += patch[p].reshape(-1)
    S = torch.einsum("pgfm,pghm->pfh", R, Wh[:, :, :Npt, :])
    land(ops["pdst"][k], pc, Mft * Npt, -S)
    if Mbt:
        St = torch.tril(torch.einsum("pgfm,pghm->pfh", R[:, :, Npt:, :],
                                     Wh[:, :, Npt:, :]))
        land(ops["udst"][k], uc, Mbt * Mbt, St)


@pytest.fixture(scope="module")
def lap16_pf():
    (_, _, _), (pp, pq, pv) = _both("laplacian_3d", 16)
    return pq


@pytest.mark.parametrize("bf16", [False, True])
def test_extend_add_matches_the_one_hot_chain(lap16_pf, bf16):
    """Every pair instruction of laplacian_3d(16) on one random float64
    buffer, through pf's pair step (the plain extend-add on the CPU) and
    through the one-hot chain: the whole buffer equal where G = 1 (one
    child per parent: each placed value lands alone) and within 1e-15
    relative where G > 1 (the children summed in another order).  The
    classes cover one-hot and gather placement, contiguous and scattered
    parents and slots, parents with and without below rows, and G = 1 and
    G > 1."""
    pq = lap16_pf
    metas = pq.qmeta
    assert {m[0] <= 256 for m in metas} == {True, False}
    assert {m[5] for m in metas} == {True, False}
    assert {m[6] for m in metas if m[4]} == {True, False}
    assert {m[4] > 0 for m in metas} == {True, False}
    assert {m[1] == 1 for m in metas} == {True, False}
    dops = pq.arrays(np.float64, "cpu")[2]
    base = torch.as_tensor(np.random.default_rng(22).standard_normal(pq.buf))
    for meta, ops, dop in zip(metas, pq.qops, dops):
        for k in range(len(ops["idxf"])):
            want = base.clone()
            _onehot_chain(want, ops, k, meta, bf16)
            got = base.clone()
            port_pf._pair_step(*meta, bf16)(got, k, dop)
            assert not torch.equal(got, base), meta
            if meta[1] == 1:
                assert torch.equal(got, want), meta
            else:
                err = float((got - want).abs().max() / want.abs().max())
                assert err <= 1e-15, (meta, err)


def test_extend_add_on_the_cpu_is_the_plain_version(lap16_pf):
    """The wrapper takes the plain version for a CPU buffer and launches
    nothing; a pf factor launches the kernel once a pair instruction on
    the card, as extend_add_launches counts from the plan."""
    pq = lap16_pf
    nf, npc = len(pq.fmeta), len(pq.pmeta)
    pairs = sum(c >= nf + npc for c in pq.instr_cls.tolist())
    assert port_pf.extend_add_launches(pq) == pairs == 25
    dops = pq.arrays(np.float64, "cpu")[2]
    meta, dop = pq.qmeta[0], dops[0]
    Mbc, G, Pq, Npt, Mbt = meta[:5]
    base = torch.as_tensor(np.random.default_rng(3).standard_normal(pq.buf))
    a, b = base.clone(), base.clone()
    before = port_pf.extend_add.launches
    args = (dop["idxf"][0], dop["coff"][0], dop["pdst"][0],
            dop["udst"][0] if Mbt else None, Mbc, Npt, Mbt)
    port_pf.extend_add(a, *args)
    port_pf.extend_add_plain(b, *args)
    assert port_pf.extend_add.launches == before
    assert torch.equal(a, b) and not torch.equal(a, base)


def test_check_plan_walks_every_kind_of_pair_instruction(lap16_pf):
    """tools/bench_extend_add.check_plan, which holds the kernel against
    the plain version on the card, runs every pair instruction of the
    plan on its own operands and counts the kinds it covered: at
    laplacian_3d(16) G = 1 with an update slot and with several parents,
    G > 1 and a pad parent are all among them.  On the CPU both sides
    are the plain version."""
    from suitesparse_tpu_torch.tools import bench_extend_add
    seen = bench_extend_add.check_plan(lap16_pf, torch.float64,
                                       device="cpu")
    assert seen == dict(instructions=25, g1=7, g1_slot=6, g1_parents=1,
                        gmany=18, pads=1)


@pytest.mark.parametrize("bad", ["slot_row", "bf16"])
def test_check_plan_catches_a_wrong_placement(lap16_pf, monkeypatch, bad):
    """check_plan raises when the launched side places a value wrongly:
    an update-slot entry moved one row down, or values rounded to
    bfloat16 where the plain version keeps them."""
    from suitesparse_tpu_torch.tools import bench_extend_add

    def wrong(Fx, idxf, coff, pdst, udst, Mbc, Npt, Mbt, bf16=False):
        if bad == "bf16":
            return port_pf.extend_add_plain(Fx, idxf, coff, pdst, udst,
                                            Mbc, Npt, Mbt, True)
        before = Fx.clone()
        port_pf.extend_add_plain(Fx, idxf, coff, pdst, udst, Mbc, Npt, Mbt)
        if Mbt > 1:
            d = int(udst[0])
            if d >= 0:
                Fx[d + Mbt] += Fx[d] - before[d]
                Fx[d] = before[d]

    monkeypatch.setattr(bench_extend_add, "extend_add", wrong)
    with pytest.raises(RuntimeError, match="differ from the plain"):
        bench_extend_add.check_plan(lap16_pf, torch.float64, device="cpu")


def _nan_supernodes(ss, Lx):
    return [s for s in range(ss.nsuper) if np.isnan(Lx[
        int(ss.panel_off[s]):int(ss.panel_off[s])
        + int(ss.panel_Mp[s]) * int(ss.panel_Np[s])]).any()]


def test_not_posdef_minor_through_pair_instructions():
    """laplacian_3d(12) with A[150, 150] = -3: the leaf supernode that
    holds it fails, and its NaN reaches its ancestors through pair
    instructions.  The one-hot products spread a child's NaN along whole
    rows of the parent's frame, the extend-add only to the entries it
    reaches; either way the first supernode holding a NaN is the failed
    one, so NOT_POSDEF comes with the reference's minor."""
    S = sp.lil_matrix(ref_gen.laplacian_3d(12).to_scipy())
    S[150, 150] = -3.0
    S = sp.csc_matrix(S)
    S.sort_indices()
    got = []
    for chol, common, sn, cls, status, kw in (
            (ref_chol, ref_common, ref_sn, RefCSC, RefStatus, {}),
            (port_chol, port_common, port_sn, PortCSC, PortStatus,
             {"device": "cpu"})):
        A = cls.from_scipy(S)
        cm = common()
        cm.cholesky.supernodal = "supernodal"
        cm.cholesky.program = "pf"
        sym = chol.analyze(A, cm)
        ss = chol.super_symbolic(A, sym, cm)
        plan = sn.build_plan(ss)
        f = sn.factorize_super(A, sym, ss, plan=plan, common=cm, **kw)
        assert cm.status == status.NOT_POSDEF and not f.ok
        got.append(f.minor)
    assert len(plan.pf_plan(cm).qmeta) > 0
    assert len(_nan_supernodes(ss, f.Lx.numpy())) > 2
    assert got[0] == got[1] == 365
