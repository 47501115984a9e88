"""Factor/matrix serialization (checkpoint-resume of factorizations).

Counterpart of suitesparse_tpu/utils/serialize.py for the matrices, the
Cholesky factors and the UMFPACK and KLU objects; the on-disk format is the reference's, so a file written
by either package loads in the other.  Reference equivalents:
umfpack_*_save_numeric / load_numeric (versioned opaque blobs,
umfpack_save_numeric.c:33,61) and GxB_Matrix_serialize/deserialize with
block compression (GB_serialize.c).  Archives are versioned .npz files
(zlib-compressed) keyed by a format tag.

A supernodal factor's panel buffer and a UMFPACK numeric's L/U buffers
are saved from wherever they live and loaded onto ``device``: the card
unless the caller asks for the CPU.  A KLU numeric lives on the host.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np

from ..core.sparse import SparseCSC
from ..core.status import SparseError, Status
from .device import resolve_device

# the reference package's archive tag, kept so files cross between the two
_MAGIC = "suitesparse_tpu"
_VERSION = 1


def _pack(kind: str, meta: dict, arrays: dict, path) -> None:
    header = dict(magic=_MAGIC, version=_VERSION, kind=kind, meta=meta)
    np.savez_compressed(path, __header__=np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8), **arrays)


def _unpack(path, kind: str):
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header.get("magic") != _MAGIC:
            raise SparseError(Status.INVALID, "not a suitesparse_tpu archive")
        if header.get("version") > _VERSION:
            raise SparseError(Status.INVALID,
                              f"archive version {header['version']} too new")
        if header.get("kind") != kind:
            raise SparseError(Status.INVALID,
                              f"archive holds {header['kind']!r}, wanted {kind!r}")
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    return header["meta"], arrays


# -- matrices ----------------------------------------------------------------

def save_sparse(path, A: SparseCSC) -> None:
    """GxB_Matrix_serialize analog."""
    _pack("sparse", dict(shape=list(A.shape), stype=int(A.stype),
                         has_values=A.data is not None),
          dict(indptr=A.indptr, indices=A.indices,
               **({"data": A.data} if A.data is not None else {})), path)


def load_sparse(path) -> SparseCSC:
    meta, arr = _unpack(path, "sparse")
    return SparseCSC(arr["indptr"], arr["indices"], arr.get("data"),
                     tuple(meta["shape"]), stype=meta["stype"])


# -- simplicial factors ------------------------------------------------------

def save_factor(path, f) -> None:
    """Simplicial Factor save (umfpack_save_numeric spirit)."""
    arrays = dict(perm=f.perm, Lp=f.Lp, Li=f.Li, Lx=f.Lx)
    if f.D is not None:
        arrays["D"] = f.D
    _pack("factor", dict(n=f.n, is_ll=bool(f.is_ll), minor=int(f.minor)),
          arrays, path)


def load_factor(path):
    from ..cholesky.simplicial import Factor
    meta, arr = _unpack(path, "factor")
    return Factor(n=meta["n"], perm=arr["perm"], Lp=arr["Lp"], Li=arr["Li"],
                  Lx=arr["Lx"], D=arr.get("D"), is_ll=meta["is_ll"],
                  minor=meta["minor"])


# -- supernodal factors ------------------------------------------------------

def _ss_pack(ss, arrays: dict, prefix: str = "") -> dict:
    """Flatten a SuperSymbolic into `arrays` (under `prefix`); returns the
    meta dict needed to rebuild it with `_ss_load`."""
    arrays.update({
        prefix + "super": ss.super,
        prefix + "col_to_super": ss.col_to_super,
        prefix + "sn_rowptr": ss.sn_rowptr,
        prefix + "sn_rows": ss.sn_rows,
        prefix + "sn_parent": ss.sn_parent,
        prefix + "level_sizes": np.array([len(l) for l in ss.levels]),
        prefix + "levels_flat": (np.concatenate(ss.levels) if ss.levels
                                 else np.empty(0, np.int64)),
        prefix + "a_dst": ss.a_scatter_dst,
        prefix + "a_src": ss.a_scatter_src,
    })
    return dict(n=ss.n, nsuper=ss.nsuper, total=int(ss.total),
                ladder=ss.layout_opts[0],
                bucket_merge=float(ss.layout_opts[1]))


def _ss_load(meta: dict, arr: dict, prefix: str = ""):
    """Rebuild a SuperSymbolic + NumericPlan from `_ss_pack` output.
    Layout assignment is deterministic given (levels, shapes), so only the
    structural arrays are stored and the derived tables are recomputed."""
    from ..cholesky.supernodal import SuperSymbolic, _assign_layout
    from ..cholesky.super_numeric import build_plan
    sizes = arr[prefix + "level_sizes"]
    flat = arr[prefix + "levels_flat"]
    levels, k = [], 0
    for s in sizes:
        levels.append(flat[k:k + int(s)])
        k += int(s)
    nsuper = meta["nsuper"]
    sn_rowptr = arr[prefix + "sn_rowptr"]
    super_ = arr[prefix + "super"]
    shapes = [(int(sn_rowptr[s + 1] - sn_rowptr[s]),
               int(super_[s + 1] - super_[s])) for s in range(nsuper)]
    panel_off, panel_Np, panel_Mp, total, level_buckets, wave_w = \
        _assign_layout(levels, shapes,
                       ladder=meta.get("ladder", "coarse"),
                       bucket_merge=float(meta.get("bucket_merge", 0.0)))
    if total != meta["total"]:
        raise SparseError(Status.INVALID, "layout mismatch on load")
    ss = SuperSymbolic(n=meta["n"], nsuper=nsuper, super=super_,
                       col_to_super=arr[prefix + "col_to_super"],
                       sn_rowptr=sn_rowptr, sn_rows=arr[prefix + "sn_rows"],
                       panel_off=panel_off, panel_Np=panel_Np,
                       panel_Mp=panel_Mp, total=total,
                       sn_parent=arr[prefix + "sn_parent"], levels=levels,
                       level_buckets=level_buckets,
                       lnz_dense=total, a_scatter_dst=arr[prefix + "a_dst"],
                       a_scatter_src=arr[prefix + "a_src"], wave_w=wave_w,
                       layout_opts=(meta.get("ladder", "coarse"),
                                    float(meta.get("bucket_merge", 0.0))))
    return ss, build_plan(ss)


def save_super_factor(path, f) -> None:
    """Checkpoint (perm, supernode partition, panel buffer)."""
    ss = f.plan.ss
    arrays = dict(Lx=f.Lx.detach().cpu().numpy(), perm=f.perm)
    meta = _ss_pack(ss, arrays)
    meta.update(minor=int(f.minor), dtype=np.dtype(f.dtype).name)
    _pack("super_factor", meta, arrays, path)


def load_super_factor(path, device=None):
    """The saved SuperFactor, its panel buffer on ``device`` (the card
    when None; raises without one)."""
    from ..cholesky.super_numeric import factor_from_numpy
    meta, arr = _unpack(path, "super_factor")
    ss, plan = _ss_load(meta, arr)
    return factor_from_numpy(plan, arr["Lx"].astype(meta["dtype"]),
                             arr["perm"], minor=meta["minor"], device=device)



# -- UMFPACK symbolic / numeric ----------------------------------------------
# (umfpack_save_symbolic.c / umfpack_save_numeric.c:33,61: versioned opaque
# blob; load reconstructs a standalone object usable for numeric/solve.)

def _csc_pack(A: SparseCSC, arrays: dict, prefix: str) -> dict:
    arrays[prefix + "indptr"] = np.asarray(A.indptr)
    arrays[prefix + "indices"] = np.asarray(A.indices)
    if A.data is not None:
        arrays[prefix + "data"] = np.asarray(A.data)
    return dict(shape=list(A.shape), stype=int(A.stype),
                has_values=A.data is not None)


def _csc_load(meta: dict, arr: dict, prefix: str) -> SparseCSC:
    return SparseCSC(arr[prefix + "indptr"], arr[prefix + "indices"],
                     arr.get(prefix + "data"), tuple(meta["shape"]),
                     stype=meta["stype"])


def _umf_sym_pack(S, arrays: dict, prefix: str) -> dict:
    meta = dict(n=S.n, strategy=S.strategy, sym_ratio=float(S.sym_ratio),
                nzdiag=int(S.nzdiag))
    if S.singles is not None:
        sg = S.singles
        arrays[prefix + "p"] = sg.p
        arrays[prefix + "q"] = sg.q
        arrays[prefix + "r"] = sg.r
        subs = []
        for k, sub in enumerate(sg.subs):
            if sub is None:
                subs.append(None)
            else:
                ssub, Ablk = sub
                subs.append(dict(
                    sym=_umf_sym_pack(ssub, arrays, f"{prefix}s{k}_"),
                    A=_csc_pack(Ablk, arrays, f"{prefix}A{k}_")))
        meta["subs"] = subs
        return meta
    for name in ("rowmatch", "a_scatter_L", "a_scatter_U",
                 "a_perm_rows", "a_perm_cols"):
        arrays[prefix + name] = getattr(S, name)
    for name in ("perm", "parent", "post", "colcount"):
        arrays[prefix + "sym_" + name] = getattr(S.sym, name)
    meta["sym"] = dict(n=S.sym.n, lnz=int(S.sym.lnz),
                       flops=float(S.sym.flops), anz=int(S.sym.anz),
                       method=S.sym.method, is_super=bool(S.sym.is_super))
    meta["ss"] = _ss_pack(S.ss, arrays, prefix + "ss_")
    return meta


def _umf_sym_load(meta: dict, arr: dict, prefix: str):
    from ..cholesky.symbolic import Symbolic
    from ..lu.multifrontal import UmfSingletons, UmfSymbolic
    if "subs" in meta:
        subs = []
        for k, sm in enumerate(meta["subs"]):
            if sm is None:
                subs.append(None)
            else:
                subs.append((_umf_sym_load(sm["sym"], arr, f"{prefix}s{k}_"),
                             _csc_load(sm["A"], arr, f"{prefix}A{k}_")))
        return UmfSymbolic(
            n=meta["n"], strategy=meta["strategy"], rowmatch=None, sym=None,
            ss=None, plan=None, a_scatter_L=None, a_scatter_U=None,
            a_perm_rows=arr[prefix + "p"], a_perm_cols=arr[prefix + "q"],
            sym_ratio=meta["sym_ratio"], nzdiag=meta["nzdiag"],
            singles=UmfSingletons(p=arr[prefix + "p"], q=arr[prefix + "q"],
                                  r=arr[prefix + "r"], subs=subs))
    ss, plan = _ss_load(meta["ss"], arr, prefix + "ss_")
    sm = meta["sym"]
    sym = Symbolic(n=sm["n"], perm=arr[prefix + "sym_perm"],
                   parent=arr[prefix + "sym_parent"],
                   post=arr[prefix + "sym_post"],
                   colcount=arr[prefix + "sym_colcount"], lnz=sm["lnz"],
                   flops=sm["flops"], anz=sm["anz"], method=sm["method"],
                   is_super=sm["is_super"], supernodes=ss)
    return UmfSymbolic(n=meta["n"], strategy=meta["strategy"],
                       rowmatch=arr[prefix + "rowmatch"], sym=sym, ss=ss,
                       plan=plan, a_scatter_L=arr[prefix + "a_scatter_L"],
                       a_scatter_U=arr[prefix + "a_scatter_U"],
                       a_perm_rows=arr[prefix + "a_perm_rows"],
                       a_perm_cols=arr[prefix + "a_perm_cols"],
                       sym_ratio=meta["sym_ratio"], nzdiag=meta["nzdiag"])


def save_umf_symbolic(path, S) -> None:
    """umfpack_save_symbolic analog (reusable across numeric calls)."""
    arrays: dict[str, Any] = {}
    meta = _umf_sym_pack(S, arrays, "")
    _pack("umf_symbolic", meta, arrays, path)


def load_umf_symbolic(path):
    meta, arr = _unpack(path, "umf_symbolic")
    return _umf_sym_load(meta, arr, "")


def _umf_num_pack(num, arrays: dict, prefix: str) -> dict:
    meta = dict(dtype=np.dtype(num.dtype).name, singular=bool(num.singular))
    arrays[prefix + "Rs"] = np.asarray(num.Rs)
    if num.Cs is not None:
        arrays[prefix + "Cs"] = np.asarray(num.Cs)
    if num.bnums is not None:
        meta["spq"] = _csc_pack(SparseCSC.from_scipy(num.Spq_csc.tocsc()),
                                arrays, prefix + "spq_")
        blocks = []
        for k, bn in enumerate(num.bnums):
            if bn is None:
                blocks.append(None)
            else:
                # inner symbolic comes from S.singles.subs[k] on load
                blocks.append(dict(
                    num=_umf_num_pack(bn, arrays, f"{prefix}n{k}_"),
                    A=_csc_pack(num.bAs[k], arrays, f"{prefix}nA{k}_")))
        meta["blocks"] = blocks
        return meta
    arrays[prefix + "Lb"] = num.Lb.cpu().numpy()
    arrays[prefix + "Ub"] = num.Ub.cpu().numpy()
    piv_counts = []
    for li, lp in enumerate(num.pivs):
        piv_counts.append(len(lp))
        for bi, pv in enumerate(lp):
            # int32, the dtype the reference writes them in
            arrays[f"{prefix}piv{li}_{bi}"] = pv.cpu().numpy().astype(
                np.int32)
    meta["piv_counts"] = piv_counts
    return meta


def _umf_num_load(meta: dict, arr: dict, prefix: str, S, dev):
    import torch
    from ..lu.multifrontal import UmfNumeric
    Rs = arr[prefix + "Rs"]
    dtype = np.dtype(meta["dtype"])
    if "blocks" in meta:
        spq = _csc_load(meta["spq"], arr, prefix + "spq_").to_scipy().tocsc()
        bnums, bAs = [], []
        for k, bm in enumerate(meta["blocks"]):
            if bm is None:
                bnums.append(None)
                bAs.append(None)
            else:
                bnums.append(_umf_num_load(bm["num"], arr, f"{prefix}n{k}_",
                                           S.singles.subs[k][0], dev))
                bAs.append(_csc_load(bm["A"], arr, f"{prefix}nA{k}_"))
        return UmfNumeric(symbolic=S, Lb=None, Ub=None, pivs=None, Rs=Rs,
                          dtype=dtype, singular=meta["singular"],
                          bnums=bnums, bAs=bAs, Spq_csc=spq,
                          Spq_csr=spq.tocsr())
    pivs = tuple(
        tuple(torch.as_tensor(arr[f"{prefix}piv{li}_{bi}"].astype(np.int64),
                              device=dev) for bi in range(cnt))
        for li, cnt in enumerate(meta["piv_counts"]))
    return UmfNumeric(symbolic=S,
                      Lb=torch.as_tensor(arr[prefix + "Lb"], device=dev),
                      Ub=torch.as_tensor(arr[prefix + "Ub"], device=dev),
                      pivs=pivs,
                      Rs=Rs, dtype=dtype, singular=meta["singular"],
                      Cs=arr.get(prefix + "Cs"))


def save_umf_numeric(path, num) -> None:
    """umfpack_save_numeric analog.  The blob embeds the symbolic so the
    loaded object is standalone for solve (umfpack_di_solve takes Numeric
    only)."""
    arrays: dict[str, Any] = {}
    meta = dict(num=_umf_num_pack(num, arrays, ""),
                sym=_umf_sym_pack(num.symbolic, arrays, "S_"))
    _pack("umf_numeric", meta, arrays, path)


def load_umf_numeric(path, device=None):
    """The saved UmfNumeric, its buffers and pivots on ``device`` (the
    card when None; raises without one)."""
    dev = resolve_device(device)
    meta, arr = _unpack(path, "umf_numeric")
    S = _umf_sym_load(meta["sym"], arr, "S_")
    return _umf_num_load(meta["num"], arr, "", S, dev)


# -- KLU ---------------------------------------------------------------------

def save_klu(path, num) -> None:
    sym = num.sym
    blocks_meta = []
    arrays: dict[str, Any] = dict(p=sym.p, q=sym.q, r=sym.r, pnum=num.pnum,
                                  Rs=num.Rs, p_final=num.p_final)
    off = num.offdiag.tocoo()
    arrays.update(off_row=off.row.astype(np.int64),
                  off_col=off.col.astype(np.int64), off_val=off.data)
    for i, blk in enumerate(num.blocks):
        blocks_meta.append(blk.n)
        for name in ("Lp", "Li", "Lx", "Up", "Ui", "Ux", "pivot_rows"):
            arrays[f"b{i}_{name}"] = getattr(blk, name)
    _pack("klu", dict(n=sym.n, nblocks=sym.nblocks, nmatch=int(sym.nmatch),
                      ordering=sym.ordering, blocks=blocks_meta,
                      singular_col=int(num.singular_col),
                      flops=float(num.flops)), arrays, path)


def load_klu(path):
    import scipy.sparse as sp
    from ..lu.klu import KLUNumeric, KLUSymbolic, _BlockLU
    meta, arr = _unpack(path, "klu")
    sym = KLUSymbolic(n=meta["n"], p=arr["p"], q=arr["q"], r=arr["r"],
                      nblocks=meta["nblocks"], nmatch=meta["nmatch"],
                      ordering=meta["ordering"])
    blocks = []
    for i, nb in enumerate(meta["blocks"]):
        blocks.append(_BlockLU(n=nb, Lp=arr[f"b{i}_Lp"], Li=arr[f"b{i}_Li"],
                               Lx=arr[f"b{i}_Lx"], Up=arr[f"b{i}_Up"],
                               Ui=arr[f"b{i}_Ui"], Ux=arr[f"b{i}_Ux"],
                               pivot_rows=arr[f"b{i}_pivot_rows"]))
    n = meta["n"]
    off = sp.coo_matrix((arr["off_val"], (arr["off_row"], arr["off_col"])),
                        shape=(n, n)).tocsc()
    return KLUNumeric(sym=sym, blocks=blocks, pnum=arr["pnum"], Rs=arr["Rs"],
                      offdiag=off, singular_col=meta["singular_col"],
                      flops=meta["flops"], p_final=arr["p_final"])


# -- GxB_Matrix_serialize / deserialize analog -------------------------------
# (GB_serialize.c: blob = header + per-block compressed streams; the
# reference offers LZ4/LZ4HC/ZSTD -- zstd is taken when the zstandard
# module is installed, zlib otherwise.)

_BLOCK = 1 << 22          # 4 MiB uncompressed blocks, like GB_serialize


def _codec(method: str):
    """Returns (actual_method, compress, decompress)."""
    if method == "zstd":
        try:
            import zstandard as zstd
            c = zstd.ZstdCompressor()
            d = zstd.ZstdDecompressor()
            return "zstd", (lambda b: c.compress(b)), \
                (lambda b: d.decompress(b))
        except ImportError:
            method = "zlib"
    if method == "zlib":
        import zlib
        return "zlib", zlib.compress, zlib.decompress
    if method == "none":
        return "none", (lambda b: b), (lambda b: b)
    raise SparseError(Status.INVALID, f"unknown serialize method {method!r}")


def matrix_serialize(A: SparseCSC, method: str = "zstd") -> bytes:
    """GxB_Matrix_serialize: matrix -> compressed blob (one buffer)."""
    method, comp, _ = _codec(method)
    data = A.data if A.data is not None else np.empty(0)
    streams = []
    for arr in (np.asarray(A.indptr, dtype=np.int64),
                np.asarray(A.indices, dtype=np.int64), np.asarray(data)):
        raw = arr.tobytes()
        blocks = [comp(raw[i:i + _BLOCK]) for i in range(0, len(raw), _BLOCK)]
        if not blocks:
            blocks = [comp(b"")]
        streams.append(blocks)
    header = dict(magic=_MAGIC, version=_VERSION, kind="grb_matrix",
                  method=method,
                  shape=list(A.shape), stype=int(A.stype),
                  has_values=A.data is not None,
                  dtype=str(np.asarray(data).dtype),
                  nblocks=[len(s) for s in streams],
                  sizes=[[len(b) for b in s] for s in streams])
    hb = json.dumps(header).encode()
    out = [len(hb).to_bytes(8, "little"), hb]
    for s in streams:
        out.extend(s)
    return b"".join(out)


def matrix_deserialize(blob: bytes) -> SparseCSC:
    """GxB_Matrix_deserialize: blob -> matrix."""
    hlen = int.from_bytes(blob[:8], "little")
    header = json.loads(blob[8:8 + hlen].decode())
    if header.get("magic") != _MAGIC or header.get("kind") != "grb_matrix":
        raise SparseError(Status.INVALID, "not a serialized matrix blob")
    _, _, decomp = _codec(header["method"])
    pos = 8 + hlen
    arrays = []
    for sizes in header["sizes"]:
        raw = b""
        for sz in sizes:
            raw += decomp(blob[pos:pos + sz])
            pos += sz
        arrays.append(raw)
    indptr = np.frombuffer(arrays[0], dtype=np.int64)
    indices = np.frombuffer(arrays[1], dtype=np.int64)
    data = (np.frombuffer(arrays[2], dtype=np.dtype(header["dtype"]))
            if header["has_values"] else None)
    return SparseCSC(indptr.copy(), indices.copy(),
                     None if data is None else data.copy(),
                     tuple(header["shape"]), stype=header["stype"])
