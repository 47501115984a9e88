"""Device SpMV / SpMM: the counterpart of suitesparse_tpu/ops/spmv.py.

Two tiers, both pattern-static (the host work runs once per pattern):

1. `spmv_program` / `spmm_program`: CSR-sorted gather + sorted segment
   reduce -- the general-semiring path every GraphBLAS mxv/vxm rides.
   Indices are sorted by destination row on the host, so the reduction is
   one pass over contiguous segments (and float sums are deterministic).

2. `bcsr_spmm`: block-sparse x dense (BCSR).  On a CUDA tensor it launches
   the hand-written Hopper kernel ``csrc/bcsr_spmm.cu`` (which replaces the
   Pallas ``_bcsr_kernel``); on a CPU tensor it runs `bcsr_spmm_plain`, the
   same sum written with batched products.  The Pallas kernel's padding of
   X to 128 columns and its scalar-prefetch grid are TPU layout choices:
   the CUDA kernel takes X as it is.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.sparse import SparseCSC
from ..utils import cuda_build
from ..utils.device import device_of, resolve_device

__all__ = ["spmv_program", "spmm_program", "to_bcsr", "bcsr_spmm",
           "bcsr_spmm_plain", "bcsr_from_numpy", "BCSR"]


# -- tier 1: CSR sorted-segment programs ---------------------------------------

@dataclasses.dataclass
class _RowProgram:
    rows: np.ndarray    # (nnz,) destination rows, ascending
    cols: np.ndarray    # (nnz,) source columns (gather into x)
    gat: np.ndarray     # (nnz,) gather into A.data (CSC order)
    m: int
    n: int


def _row_program(A: SparseCSC) -> _RowProgram:
    m, n = A.shape
    rows = np.asarray(A.indices, dtype=np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    order = np.argsort(rows, kind="stable")
    return _RowProgram(rows=rows[order], cols=cols[order], gat=order,
                       m=m, n=n)


def _spmv_impl(vals, x, prog_arrays, m, mult_name, monoid_name):
    from ..graphblas.core import BINOPS
    from .spgemm import _seg_sorted
    rows, cols, gat, lengths = prog_arrays
    av = vals[gat]
    xv = x[cols]
    if xv.dim() == av.dim() + 1:        # multi-rhs X (n, k)
        av = av[:, None]
    terms = BINOPS[mult_name](av, xv)
    return _seg_sorted(monoid_name)(terms, rows, m, lengths)


def spmv_program(A: SparseCSC, device=None):
    """Returns f(vals, x, ring='plus_times') -> y, a device program for this
    pattern (index maps uploaded once).  vals in CSC data order; x dense
    (n,) or (n, k).  Runs on ``device`` (None: the card)."""
    prog = _row_program(A)
    dev = resolve_device(device)
    rows, cols, gat = (torch.as_tensor(a, device=dev)
                       for a in (prog.rows, prog.cols, prog.gat))
    arrays = (rows, cols, gat,
              torch.as_tensor(np.bincount(prog.rows, minlength=prog.m),
                              device=dev))

    def run(vals, x, ring="plus_times"):
        from ..graphblas.core import semiring
        r = semiring(ring) if isinstance(ring, str) else ring
        return _spmv_impl(torch.as_tensor(vals, device=dev),
                          torch.as_tensor(x, device=dev), arrays, prog.m,
                          r.name.partition("_")[2], r.add.name)

    run.rows_with_entries = rows   # for GrB empty-row semantics
    return run


def spmm_program(A: SparseCSC, device=None):
    """Same program shape for dense multi-rhs X (n, k): one extra trailing
    axis rides through the gathers and the segment reduce."""
    return spmv_program(A, device)   # _spmv_impl broadcasts over trailing axes


# -- tier 2: BCSR block-sparse x dense -----------------------------------------

@dataclasses.dataclass
class BCSR:
    """Uniform-slot BCSR: every block row holds exactly `nslots` blocks
    (padded with an all-zero block whose column index is 0)."""

    blocks: np.ndarray      # (nrb * nslots, bm, bk)
    block_cols: np.ndarray  # (nrb * nslots,) int32, block column index
    nrb: int                # number of block rows
    nslots: int             # blocks per row (uniform, padded)
    bm: int
    bk: int
    shape: tuple            # original (m, n)
    # device -> (blocks, block_cols) tensors, checked once when uploaded
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    def device_arrays(self, device: torch.device):
        """(blocks, block_cols) on ``device``; uploaded and checked once."""
        key = str(device)
        got = self._dev.get(key)
        if got is None:
            _check_bcsr(self)
            got = (torch.as_tensor(self.blocks, device=device),
                   torch.as_tensor(self.block_cols, device=device))
            self._dev[key] = got
        return got


def _check_bcsr(bc: BCSR) -> None:
    """Host checks of what the kernel reads, once per BCSR."""
    m, n = bc.shape
    ncb = -(-n // bc.bk)
    nb = bc.nrb * bc.nslots
    if bc.blocks.dtype != np.float32 or bc.blocks.shape != (nb, bc.bm, bc.bk):
        raise ValueError(f"BCSR blocks must be float32 ({nb}, {bc.bm}, "
                         f"{bc.bk}), got {bc.blocks.dtype} "
                         f"{bc.blocks.shape}")
    if bc.block_cols.dtype != np.int32 or bc.block_cols.shape != (nb,):
        raise ValueError(f"BCSR block_cols must be int32 ({nb},)")
    if nb and (bc.block_cols.min() < 0 or bc.block_cols.max() >= ncb):
        raise ValueError(f"BCSR block column out of range [0, {ncb})")
    if not 0 < m <= bc.nrb * bc.bm:
        raise ValueError(f"BCSR shape {bc.shape} does not fit {bc.nrb} "
                         "block rows")


def to_bcsr(A: SparseCSC, bm: int = 128, bk: int = 128) -> BCSR:
    """Host-side conversion (once per pattern+values)."""
    import scipy.sparse as sp
    m, n = A.shape
    S = A.to_scipy().tocsr()
    nrb = -(-m // bm)
    ncb = -(-n // bk)
    Sp = sp.csr_matrix((S.data, S.indices, S.indptr), shape=(m, n))
    # bucket entries by (row block, col block)
    coo = Sp.tocoo()
    rb = coo.row // bm
    cb = coo.col // bk
    bkey = rb.astype(np.int64) * ncb + cb
    order = np.argsort(bkey, kind="stable")
    bkey_s = bkey[order]
    uniq, start = np.unique(bkey_s, return_index=True)
    counts = np.diff(np.append(start, len(bkey_s)))
    # per block row: how many distinct blocks
    urb = (uniq // ncb).astype(np.int64)
    ucb = (uniq % ncb).astype(np.int32)
    per_row = np.bincount(urb, minlength=nrb)
    nslots = max(int(per_row.max()) if len(per_row) else 0, 1)
    blocks = np.zeros((nrb * nslots, bm, bk), dtype=np.float32)
    block_cols = np.zeros(nrb * nslots, dtype=np.int32)
    slot_of_row = np.zeros(nrb, dtype=np.int64)
    # the entries in block order, gathered once (not once per block)
    row_s, col_s, data_s = coo.row[order], coo.col[order], coo.data[order]
    for bi, key in enumerate(uniq):
        r, c = int(urb[bi]), int(ucb[bi])
        slot = int(slot_of_row[r])
        slot_of_row[r] += 1
        dst = r * nslots + slot
        block_cols[dst] = c
        sel = slice(start[bi], start[bi] + counts[bi])
        rr = row_s[sel] - r * bm
        cc = col_s[sel] - c * bk
        blocks[dst, rr, cc] = data_s[sel]
    return BCSR(blocks=blocks, block_cols=block_cols, nrb=nrb,
                nslots=nslots, bm=bm, bk=bk, shape=(m, n))


def bcsr_from_numpy(blocks, block_cols, nslots: int, shape,
                    bm: int = 128, bk: int = 128) -> BCSR:
    """Adopt the arrays of a uniform-slot BCSR built elsewhere (e.g. by the
    JAX package's ``to_bcsr``), checked as the kernel needs them."""
    blocks = np.ascontiguousarray(blocks)
    nslots = int(nslots)
    if nslots < 1 or blocks.ndim != 3 or blocks.shape[0] % nslots:
        raise ValueError(f"blocks {blocks.shape} do not split into "
                         f"{nslots} slots a row")
    bc = BCSR(blocks=blocks, block_cols=np.ascontiguousarray(block_cols),
              nrb=blocks.shape[0] // nslots, nslots=nslots, bm=int(bm),
              bk=int(bk), shape=tuple(int(s) for s in shape))
    _check_bcsr(bc)
    return bc


def bcsr_spmm_plain(blocks: torch.Tensor, block_cols: torch.Tensor,
                    X: torch.Tensor, nslots: int, shape) -> torch.Tensor:
    """Plain PyTorch BCSR product: for each slot one batched product of the
    row blocks with their gathered X blocks, summed over slots in slot
    order, in float32.  X is (n, k) float32; returns (m, k)."""
    nb, bm, bk = blocks.shape
    nrb = nb // nslots
    m, n = shape
    k = X.shape[1]
    ncb = -(-n // bk)
    Xp = X.new_zeros((ncb * bk, k))
    Xp[:n] = X
    Xb = Xp.view(ncb, bk, k)
    B = blocks.view(nrb, nslots, bm, bk)
    cols = block_cols.view(nrb, nslots).long()
    out = X.new_zeros((nrb, bm, k))
    for t in range(nslots):
        out += torch.bmm(B[:, t], Xb[cols[:, t]])
    return out.reshape(nrb * bm, k)[:m]


def bcsr_spmm(bc: BCSR, X, device=None) -> torch.Tensor:
    """Y = A @ X with A in uniform-slot BCSR, X dense (n, k), in float32.

    Runs where X lives when X is a tensor, else on ``device`` (None: the
    card).  A CPU tensor takes `bcsr_spmm_plain`; a CUDA tensor launches the
    kernel (128 x 128 blocks) or raises."""
    dev = device_of(X, device=device)
    blocks, cols = bc.device_arrays(dev)
    X = torch.as_tensor(X, device=dev).to(torch.float32).contiguous()
    m, n = bc.shape
    if X.dim() != 2 or X.shape[0] != n:
        raise ValueError(f"bcsr_spmm: X must be ({n}, k), got "
                         f"{tuple(X.shape)}")
    if dev.type == "cpu":
        return bcsr_spmm_plain(blocks, cols, X, bc.nslots, bc.shape)
    if dev.type != "cuda":
        raise ValueError(f"bcsr_spmm: unsupported device {dev}")
    if (bc.bm, bc.bk) != (128, 128):
        raise ValueError(f"bcsr_spmm: the kernel takes 128 x 128 blocks, "
                         f"got {bc.bm} x {bc.bk}")
    k = X.shape[1]
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    cuda_build.launch("sstpu_bcsr_spmm_f32", X, blocks.data_ptr(),
                      cols.data_ptr(), X.data_ptr(), out.data_ptr(), bc.nrb,
                      bc.nslots, m, n, k)
    bcsr_spmm.launches += 1
    return out


bcsr_spmm.launches = 0
