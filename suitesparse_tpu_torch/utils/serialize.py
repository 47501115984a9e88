"""Factor/matrix serialization (checkpoint-resume of factorizations).

Counterpart of suitesparse_tpu/utils/serialize.py for the matrices and the
Cholesky factors; the on-disk format is the reference's, so a file written
by either package loads in the other.  Reference equivalents:
umfpack_*_save_numeric / load_numeric (versioned opaque blobs,
umfpack_save_numeric.c:33,61) and GxB_Matrix_serialize/deserialize with
block compression (GB_serialize.c).  Archives are versioned .npz files
(zlib-compressed) keyed by a format tag.

A supernodal factor's panel buffer is saved from wherever it lives and
loaded onto ``device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import json

import numpy as np

from ..core.sparse import SparseCSC
from ..core.status import SparseError, Status

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
