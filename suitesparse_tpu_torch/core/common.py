"""Common: the suite-wide parameter + state block.

TPU-native analog of the reference's per-package Control/Common structs
(CHOLMOD cholmod_common: cholmod_core.h:416+; AMD Control: amd.h:341-346;
UMFPACK Control[20]: umfpack.h:267-304; KLU common: klu.h:145-166).
One dataclass tree instead of double arrays; an ``Info`` metrics dict
instead of Info[90] arrays (SURVEY.md §5 "Config / flag system").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ..utils.trace import Span
from .status import Status


# ---------------------------------------------------------------------------
# Ordering method identifiers (CHOLMOD method catalogue, cholmod_analyze.c:44-58)
# ---------------------------------------------------------------------------
ORDER_NATURAL = "natural"
ORDER_GIVEN = "given"
ORDER_AMD = "amd"
ORDER_COLAMD = "colamd"
ORDER_METIS = "nesdis"      # our native nested dissection stands in for METIS
ORDER_NESDIS = "nesdis"
ORDER_BEST = "best"


@dataclasses.dataclass
class CholeskyOptions:
    """CHOLMOD-equivalent knobs (defaults match cholmod_common.c unless retuned
    for TPU, in which case the reference default is noted)."""

    # Ordering search loop (cholmod_analyze.c:59-69): try these in order, keep
    # the one with min nnz(L). Empty => default escalation behaviour.
    methods: tuple[str, ...] = ()
    # Escalate from AMD to nested dissection iff fl/lnz >= 500 and
    # lnz/anz >= 5 (cholmod_analyze.c:59-69).
    nd_flops_per_lnz: float = 500.0
    nd_fill_ratio: float = 5.0
    # Supernodal vs simplicial auto switch: supernodal iff
    # flops/nnz(L) >= supernodal_switch (cholmod_core.h:458-465, default 40).
    supernodal: str = "auto"            # "auto" | "simplicial" | "supernodal"
    supernodal_switch: float = 40.0
    # Relaxed amalgamation (cholmod_core.h:498-507; defaults nrelax={4,16,48},
    # zrelax={0.8,0.1,0.05}).  TPU retune: wider supernodes feed the 128x128
    # MXU better, so we allow much larger merges (documented deviation, see
    # SURVEY.md §2b item 4: "the knob to retarget at 128x128 MXU tiles").
    nrelax: tuple[int, int, int] = (16, 64, 160)
    zrelax: tuple[float, float, float] = (0.9, 0.25, 0.10)
    # SYRK descendant updates with bf16 inputs + f32 accumulation (full-rate
    # MXU).  Opt-in: pairs with iterative refinement for accuracy (no
    # reference analog; TPU mixed-precision knob).
    syrk_bf16: bool = False
    # TRSM of the pass-forward factor through the explicit inverse of each
    # diagonal block (panel_factor, whose POTRF is the block_chol kernel).
    # False takes torch.linalg's Cholesky and the backward-stable
    # triangular solve for every panel class, so on the card it takes
    # block_chol off the factor: the reference's XLA path with its inverse
    # off (SSTPU_POTRF=xla with SSTPU_TRSM_INV=0; on the reference's
    # Pallas path SSTPU_TRSM_INV alone changes nothing), the accuracy
    # escape hatch of ACCURACY.md:81-98.  A field here, since the port
    # reads no environment switches.
    trsm_inv: bool = True
    # Numeric/solve program form: "unrolled" traces one op chain per
    # (level, bucket) — fastest at runtime for small patterns but compile
    # time is O(#buckets); "wave" compiles a lax.scan over a static
    # instruction stream with lax.switch over shape classes — compile time
    # O(#distinct shapes); "pf" is the wave form with the pass-forward
    # (multifrontal) MXU extend-add replacing the sorted-segment scatter
    # (see cholesky/pf.py) — the fast path on TPU.  "auto" picks pf for
    # real patterns and unrolled below wave_threshold buckets.
    program: str = "auto"               # auto | unrolled | wave | pf
    # pass-forward extend-add: per-bucket scatter-vs-project cost model
    # (pf.py).  "auto" compares measured rates; "project"/"scatter" force.
    pf_mode: str = "auto"
    # measured on v5e.  Round-5 device-profile recalibration
    # (tools/profile_attrib.py): the 1-hop gather/segsum/scatter chain
    # measured ~0.12 GB/s effective at program level (lap3d_28: 0.3 MB in
    # 2.6 ms; lap3d_44: Fscat32x32 alone was 9.8% of the program), 10x
    # below the round-3 microbench constant — while the projection path
    # got ~5x cheaper once placement moved onto the MXU.  The honest
    # constants flip most mode-2 buckets to projections.
    pf_scatter_bw: float = 1.2e8        # measured TPU scatter class (B/s)
    pf_proj_rate: float = 1e13          # measured projection class (FLOP/s)
    # pass-forward projection grouping: "pair" fuses ALL children of one
    # (child shape, parent bucket) pair per level into ONE instruction
    # (exact child count, segment-sum over children, slab-granular scatter
    # into the parent bucket region); "chunk" is the round-3-early form
    # (per parent-chunk windows, pow2 G<=8) kept for A/B.
    pf_group: str = "pair"
    # auto threshold: use the wave program when the schedule has more
    # buckets than this (compile cost ~linear in bucket count).
    wave_threshold: int = 32
    # Panel shape ladder: "coarse" {8,32,128,k*256} minimizes the number of
    # distinct shape classes (compile time, dispatch); "fine" pads tighter
    # (less flop/storage waste) at the cost of many more compiled shapes.
    shape_ladder: str = "coarse"
    # Per-level bucket clustering: merge a level's shape buckets (padding
    # both dims up) while the padded-volume increase stays under this
    # fraction of the level's original padded volume.  Cuts the number of
    # compiled (bucket x parent) instructions — the dispatch-bound resource
    # on TPU (tools/microbench_dispatch.py) — at a bounded storage/flop
    # cost.  0 disables.
    bucket_merge: float = 0.35
    # AMD dense-row handling (amd.h:140-148): rows with > dense*sqrt(n)
    # entries are deferred to the end of the order.
    amd_dense: float = 10.0
    amd_aggressive: bool = True
    # Numeric
    dbound: float = 0.0                 # min |D| for LDL' (cholmod dbound)
    factor_dtype: Any = None            # None => float64 on CPU, float32 on TPU
    # Iterative refinement steps applied in solve() when factor dtype is
    # lower-precision than the input (mixed-precision path, SURVEY.md §7).
    refine_steps: int = 2


@dataclasses.dataclass
class LUOptions:
    """UMFPACK/KLU-equivalent knobs (umfpack.h:267-335, klu.h:145-166)."""

    strategy: str = "auto"              # auto | unsymmetric | symmetric
    # auto strategy: symmetric iff pattern symmetry >= 0.5 and
    # nzdiag >= 0.9 n (umfpack_qsymbolic.c:1232-1247)
    sym_threshold: float = 0.5
    nzdiag_threshold: float = 0.9
    pivot_tol: float = 0.1              # threshold partial pivoting (umfpack.h:323)
    sym_pivot_tol: float = 0.001        # diagonal preference (umfpack.h:325)
    scale: str = "sum"                  # none | sum | max (UMFPACK default sum,
                                        # KLU default max)
    btf: bool = True                    # KLU: BTF preordering on by default
    # UMFPACK singleton pruning (umf_singletons, umfpack_qsymbolic.c:1081):
    # we generalize to full BTF block decomposition — 1x1 blocks are the
    # singleton pivots, larger blocks get the multifrontal treatment —
    # which avoids symmetrizing (near-)triangular parts of the pattern.
    singletons: bool = True
    ordering: str = "auto"              # amd | colamd | auto | natural | given
    refine_steps: int = 2               # max iterative refinement (UMFPACK IRSTEP)
    # static-pivot accuracy escape hatch: when iterative refinement stalls
    # with componentwise omega above this, umf_solve re-routes through the
    # native-KLU threshold-partial-pivoting path (reference accuracy class
    # of umf_local_search.c without per-value device retrace). 0 disables.
    escalate_omega: float = 1e-10
    halt_if_singular: bool = False      # klu.h:165
    factor_dtype: Any = None


@dataclasses.dataclass
class QROptions:
    """SPQR-equivalent knobs (SuiteSparseQR_definitions.h)."""

    ordering: str = "auto"              # colamd default for QR
    # rank-detection tol: 20*(m+n)*eps*max column 2-norm
    # (SuiteSparseQR_definitions.h:28, spqr_tol.cpp:23-24)
    tol: Optional[float] = None
    factor_dtype: Any = None


@dataclasses.dataclass
class Common:
    """Suite-wide state: options, status, metrics, pluggable printing.

    The reference routes all printing through a pluggable printf pointer
    (SuiteSparse_config.h:93,179-185) and all state through Common; we keep
    both ideas.
    """

    cholesky: CholeskyOptions = dataclasses.field(default_factory=CholeskyOptions)
    lu: LUOptions = dataclasses.field(default_factory=LUOptions)
    qr: QROptions = dataclasses.field(default_factory=QROptions)

    status: Status = Status.OK
    print_level: int = 1                # 0..4 like cholmod Common->print
    print_func: Callable[[str], None] = print

    # Info metrics dict — the Info[90]/Info[20] analog.  Populated by
    # analyze/factorize/solve with: ordering used, lnz, anz, flops,
    # per-phase wall times, residuals, memory estimates.
    info: dict[str, Any] = dataclasses.field(default_factory=dict)

    def log(self, level: int, msg: str) -> None:
        if self.print_level >= level:
            self.print_func(msg)

    # -- fault injection (the Tcov malloc-failure shim analog, SURVEY §4) --
    # The reference's torture suites override malloc_func to fail on the
    # N-th call, driving every out-of-memory branch.  Our resource
    # checkpoints play that role: phases call cm.checkpoint("phase") at
    # allocation-ish boundaries; an armed Common raises a graceful
    # SparseError(OUT_OF_MEMORY) on the N-th checkpoint.
    fail_after: Optional[int] = None    # arm: fail on the N-th checkpoint
    _checkpoints: int = 0

    def checkpoint(self, where: str = "") -> None:
        if self.fail_after is None:
            return
        self._checkpoints += 1
        if self._checkpoints > self.fail_after:
            from .status import SparseError
            self.status = Status.OUT_OF_MEMORY
            raise SparseError(Status.OUT_OF_MEMORY,
                              f"injected failure at checkpoint "
                              f"{self._checkpoints} ({where})")

    def arm_failure(self, after: int) -> None:
        """Arm the injector: the (after+1)-th checkpoint raises."""
        self.fail_after = after
        self._checkpoints = 0

    def disarm(self) -> None:
        self.fail_after = None
        self._checkpoints = 0

    # -- timers (SuiteSparse_tic/toc analog, SuiteSparse_config.h:139-154) --
    # on the port's spans (utils/trace): tic opens the span common.<key>,
    # toc closes it and adds its seconds to info["time_<key>"]
    def tic(self, key: str) -> None:
        sp = self.info[f"_tic_{key}"] = Span(f"common.{key}", nest=False)
        sp.__enter__()

    def toc(self, key: str) -> float:
        sp = self.info.pop(f"_tic_{key}", None)
        t = 0.0
        if sp is not None:
            sp.__exit__(None, None, None)
            t = sp.seconds
        self.info[f"time_{key}"] = self.info.get(f"time_{key}", 0.0) + t
        return t


def default_common() -> Common:
    return Common()
