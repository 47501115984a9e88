"""The blocked Householder QR of the QR program's tall fronts
(``qr/spqr.front_qr``), on the CPU through its plain version
``front_qr_plain``: against LAPACK's geqrf and ormqr (``torch.geqrf``,
``torch.ormqr``) in float64, front by front, and through the whole program
on a matrix whose buckets exceed 256 rows, against dense float64 QR.  The
program takes ``front_qr`` on the card only; here the card's route is put
in place of ``front_qr_takes`` (``card_route``), so the program runs the
kernel's arithmetic through ``front_qr_plain``."""
import numpy as np
import pytest
import torch

from suitesparse_tpu_torch.io.generators import grad3d_tik
from suitesparse_tpu_torch.qr import spqr

# (B, FR, FC, k, how): fronts a bucket could hold.  "pad": zero rows and
# columns at the end, as padded fronts have; "zero": one column exactly 0
# (its reflector is the identity, tau 0); FC above QR_OUTER and no multiple
# of QR_PANEL, so outer blocks, merged T and ragged panels all run
SHAPES = {
    "tall": (3, 600, 200, 2, None),
    "square": (2, 320, 320, 1, None),
    "wide": (2, 300, 500, 3, None),
    "padded": (3, 512, 384, 1, "pad"),
    "zero_column": (2, 400, 300, 1, "zero"),
    "narrow": (4, 264, 40, 0, None),
}


def _fronts(B, FR, FC, k, how, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((B, FR, FC))
    if how == "pad":
        W[:, FR - 40:, :] = 0.0
        W[:, :, FC - 24:] = 0.0
    elif how == "zero":
        W[:, :, 37] = 0.0
    WB = rng.standard_normal((B, FR, k)) if k else None
    return (torch.as_tensor(W),
            None if WB is None else torch.as_tensor(WB))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_version_is_geqrf_and_ormqr(name):
    """The same Householder reflectors as LAPACK (dlarfg's sign), so QR,
    tau and Q'B agree to rounding: 1e-12 of the largest entry."""
    B, FR, FC, k, how = SHAPES[name]
    W, WB = _fronts(B, FR, FC, k, how)
    QR, tau, QtB = spqr.front_qr_plain(W.clone(),
                                       None if WB is None else WB.clone())
    QR0, tau0 = torch.geqrf(W)
    assert QR.shape == QR0.shape and tau.shape == tau0.shape
    # LAPACK's column-major layout, as geqrf returns it
    assert QR.transpose(1, 2).is_contiguous()
    scale = float(W.abs().max())
    assert float((QR - QR0).abs().max()) <= 1e-12 * scale
    assert float((tau - tau0).abs().max()) <= 1e-12
    if k:
        Q0 = torch.ormqr(QR0, tau0, WB, left=True, transpose=True)
        assert float((QtB - Q0).abs().max()) <= 1e-12 * float(WB.abs().max())
    if how == "zero":
        assert torch.all(tau[:, 37] == 0.0)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_r_with_b_is_r_without(name):
    """b's sums are kept apart from the front's own, so carrying b leaves
    R, V and tau bit for bit as they are without it."""
    B, FR, FC, k, how = SHAPES[name]
    W, WB = _fronts(B, FR, FC, max(k, 1), how, seed=1)
    QRb, taub, _ = spqr.front_qr_plain(W.clone(), WB)
    QR, tau, QtB = spqr.front_qr_plain(W.clone(), None)
    assert QtB is None
    assert torch.equal(QR, QRb) and torch.equal(tau, taub)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_complete_q_is_orthogonal_and_reproduces_the_front(name):
    B, FR, FC, k, how = SHAPES[name]
    W, _ = _fronts(B, FR, FC, k, how, seed=2)
    QR, tau, _ = spqr.front_qr_plain(W.clone())
    Q = spqr._complete_q(QR, tau)
    eye = torch.eye(FR, dtype=W.dtype)
    assert float((Q.transpose(1, 2) @ Q - eye).abs().max()) <= 1e-12
    R = torch.triu(QR)
    assert float((Q @ R - W).abs().max()) <= 1e-12 * float(W.abs().max())


def test_rank_deficient_front():
    """Column 60 is the sum of columns 10 and 11: its reflector is made
    from rounding noise, which no two implementations share, so R past it
    is not unique.  What is: Q R = W with Q orthogonal, R's diagonal at
    the dependent column at rounding level, and R's columns before it."""
    W, _ = _fronts(2, 400, 150, 0, None, seed=3)
    W[:, :, 60] = W[:, :, 10] + W[:, :, 11]
    QR, tau, _ = spqr.front_qr_plain(W.clone())
    QR0, _ = torch.geqrf(W)
    scale = float(W.abs().max())
    Q = spqr._complete_q(QR, tau)
    R = torch.triu(QR)
    assert float((Q @ R - W).abs().max()) <= 1e-12 * scale
    assert float(QR[:, 60, 60].abs().max()) <= 1e-12 * scale
    assert float((torch.triu(QR)[:, :, :60] - torch.triu(QR0)[:, :, :60])
                 .abs().max()) <= 1e-12 * scale


def test_front_qr_on_the_cpu_is_the_plain_version():
    W, WB = _fronts(2, 300, 100, 1, None, seed=4)
    kernel, plain = spqr.front_qr.launches, spqr.front_qr_plain.launches
    got = spqr.front_qr(W.clone(), WB.clone())
    want = spqr.front_qr_plain(W.clone(), WB.clone())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert spqr.front_qr.launches == kernel
    # one panel of QR_PANEL columns a launch: 100 columns, 4 panels, twice
    assert spqr.front_qr_plain.launches == plain + 8


@pytest.mark.parametrize("FR,dtype,device,takes", [
    (256, torch.float64, "cuda", False),        # cuSOLVER's batched geqrf
    (257, torch.float64, "cuda", True),
    (38400, torch.float64, "cuda", True),
    (300, torch.complex128, "cuda", False),     # complex fronts keep geqrf
    (300, torch.float64, "cpu", False),         # the host keeps LAPACK
    (132 * 512 + 1, torch.float64, "cuda", False),  # past one CTA an SM
])
def test_route_of_a_bucket(FR, dtype, device, takes, monkeypatch):
    monkeypatch.setattr(spqr, "_sm_count", lambda dev: 132)
    assert spqr.front_qr_takes(FR, dtype, torch.device(device)) is takes


def test_more_right_hand_sides_than_the_panels_carry():
    """Past QR_PANEL_RHS right-hand sides, front_qr factors without them
    and applies Q' by ormqr: R is R without b, bit for bit, and Q'B is
    ormqr's on LAPACK's factor to 1e-12."""
    k = spqr.QR_PANEL_RHS + 1
    W, WB = _fronts(2, 400, 160, k, None, seed=6)
    QR, tau, QtB = spqr.front_qr(W.clone(), WB.clone())
    QR0, tau0, none = spqr.front_qr(W.clone(), None)
    assert none is None
    assert torch.equal(QR, QR0) and torch.equal(tau, tau0)
    Qg, taug = torch.geqrf(W)
    want = torch.ormqr(Qg, taug, WB, left=True, transpose=True)
    assert float((QtB - want).abs().max()) <= 1e-12 * float(WB.abs().max())


@pytest.mark.parametrize("rows,sms,tiling", [
    (40, 132, (1, 8)),           # one CTA
    (128, 132, (1, 8)),
    (129, 132, (2, 8)),          # a cluster
    (1000, 132, (8, 8)),
    (2048, 132, (16, 8)),
    (2049, 132, (17, 8)),        # a cooperative grid
    (38400, 132, (132, 24)),     # the unwrap3d_64 root: one CTA an SM
    (132 * 512, 132, (132, 32)),
    (132 * 512 + 1, 132, None),  # taller than the grid holds
])
def test_panel_tiling_follows_the_height(rows, sms, tiling):
    """G CTAs of 16 warps hold a panel's rows, rpt rows a thread: 8 rows a
    thread while CTAs are free, more once the grid has one CTA an SM."""
    got = spqr.panel_tiling(rows, sms)
    assert got == tiling
    if got is not None:
        G, rpt = got
        assert G * 16 * rpt >= rows and rpt in spqr._PANEL_RPT


# ---------------------------------------------------------------------------
# The whole program on [G; mu I] of the 12^3 gradient: 7 buckets of fronts
# above 256 rows (up to 896 x 256)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grad12():
    A = grad3d_tik(12, 0.1)
    S = spqr.qr_symbolic(A)
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    return A, S, b


@pytest.fixture
def card_route(monkeypatch):
    """The card's route on any device: real fronts above QR_KERNEL_ROWS
    rows through ``front_qr`` (``front_qr_plain`` on the CPU)."""
    monkeypatch.setattr(
        spqr, "front_qr_takes", lambda FR, dtype, device:
        FR > spqr.QR_KERNEL_ROWS and dtype == torch.float64)


def test_host_program_keeps_lapack(grad12):
    A, S, b = grad12
    before = spqr.front_qr_plain.launches
    spqr.qr_factorize(A, S, b=b, device="cpu")
    assert spqr.front_qr_plain.launches == before


def test_program_takes_the_route_and_matches_dense_qr(grad12, card_route):
    A, S, b = grad12
    assert any(bq.FR > spqr.QR_KERNEL_ROWS for lv in S.levels for bq in lv)
    before = spqr.front_qr_plain.launches
    num = spqr.qr_factorize(A, S, b=b, device="cpu")
    assert spqr.front_qr_plain.launches > before
    assert num.rank == A.shape[1]
    Ap = torch.as_tensor(A.to_scipy().toarray()[:, S.sym.perm])
    Q, R = torch.linalg.qr(Ap)
    d = spqr.r_diagonal(S, num.Rbuf)
    dd = torch.diagonal(R).numpy()
    assert np.abs(np.abs(d) - np.abs(dd)).max() <= 1e-12 * np.abs(dd).max()
    # Q'b's top rows: Q is unique up to the signs of R's rows
    qtb = (Q.T @ torch.as_tensor(b)).numpy() * np.sign(dd)
    got = num.qtb[:, 0] * np.sign(d)
    assert np.abs(got - qtb).max() <= 1e-11 * np.abs(qtb).max()


def test_program_refactors_bit_identically_and_b_leaves_r(grad12,
                                                          card_route):
    """Two refactorizations are bit-identical, and R is the same with one
    right-hand side (carried through the panels), with QR_PANEL_RHS + 1
    (applied by ormqr after the factorization) and with none."""
    A, S, b = grad12
    one = spqr.qr_factorize(A, S, b=b, device="cpu")
    two = spqr.qr_factorize(A, S, b=b, device="cpu")
    assert torch.equal(one.Rbuf, two.Rbuf)
    assert np.array_equal(one.qtb, two.qtb)
    bare = spqr.qr_factorize(A, S, device="cpu")
    assert torch.equal(bare.Rbuf, one.Rbuf)
    wide = np.random.default_rng(7).standard_normal(
        (A.shape[0], spqr.QR_PANEL_RHS + 1))
    wide[:, 3] = b
    many = spqr.qr_factorize(A, S, b=wide, device="cpu")
    assert torch.equal(many.Rbuf, one.Rbuf)
    assert np.abs(many.qtb[:, 3] - one.qtb[:, 0]).max() <= \
        1e-12 * np.abs(one.qtb).max()


def test_tiling_constants_are_the_kernels():
    """panel_tiling and the launch read the kernel's shape from these
    constants: they have to be csrc/qr_panel.cu's."""
    import re
    from suitesparse_tpu_torch.utils import cuda_build
    src = (cuda_build.CSRC / "qr_panel.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))
    assert const("kWarps") == spqr._PANEL_WARPS
    assert const("kPanel") == spqr.QR_PANEL
    assert const("kMaxB") == spqr.QR_PANEL_RHS
    assert const("kClusterMax") == spqr._PANEL_CLUSTER
    rpts = re.findall(r"case (\d+): err = launch_mode<\1, kGrid>", src)
    assert tuple(map(int, rpts)) == spqr._PANEL_RPT
    assert const("kRptFree") == spqr._PANEL_RPT_PREF
    assert spqr._PANEL_MSG == 2 * const("kPanel") + 2 * const("kMaxB")
