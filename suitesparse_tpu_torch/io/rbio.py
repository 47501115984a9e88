"""Rutherford-Boeing file I/O (RBio equivalent).

Counterpart of suitesparse_tpu/io/rbio.py, copied (rbwrite keeps the
reference's default title and key, so both packages write the same bytes).

Reference: RBio/Include/RBio.h:102-217 — RBread, RBwrite, RBreadraw, RBkind.
The RB format is a Fortran fixed-format header followed by column pointers,
row indices (both 1-based) and values, each under a Fortran format spec such
as ``(16I5)`` or ``(3E26.18)``.  We parse the specs with a small regex
instead of a Fortran runtime; whitespace-separated parsing covers all files
written with separating blanks (which RBwrite and ssget files use).
"""
from __future__ import annotations

import re

import numpy as np

from ..core.sparse import SYM_LOWER, UNSYM, SparseCSC
from ..core.status import SparseError, Status

_FMT = re.compile(r"\(?\s*(\d*)\s*([IEDFG])\s*(\d+)(?:\.(\d+))?\s*\)?", re.I)


def _parse_fmt(spec: str):
    m = _FMT.search(spec)
    if not m:
        raise SparseError(Status.INVALID, f"bad RB format spec {spec!r}")
    per_line = int(m.group(1) or 1)
    kind = m.group(2).upper()
    width = int(m.group(3))
    return per_line, kind, width


def _read_fixed(f, fmt_spec: str, count: int, dtype):
    """Read `count` numbers laid out in Fortran fixed format."""
    per_line, kind, width = _parse_fmt(fmt_spec)
    out = np.empty(count, dtype=dtype)
    k = 0
    while k < count:
        line = f.readline()
        if not line:
            raise SparseError(Status.INVALID, "unexpected EOF in RB file")
        line = line.rstrip("\n")
        n_here = min(per_line, count - k)
        for i in range(n_here):
            tok = line[i * width:(i + 1) * width].strip()
            if not tok:
                break
            out[k] = (int(tok) if kind == "I"
                      else float(tok.replace("D", "E").replace("d", "e")))
            k += 1
    return out


def rbkind(path) -> str:
    """RBkind: return the 3-character matrix type (e.g. 'rsa', 'rua', 'pua')."""
    with open(path) as f:
        f.readline()
        f.readline()
        line3 = f.readline()
    return line3.split()[0].lower()


def rbread(path) -> SparseCSC:
    with open(path) as f:
        title = f.readline().rstrip()  # noqa: F841 — title line
        counts = f.readline().split()
        totcrd, ptrcrd, indcrd = int(counts[0]), int(counts[1]), int(counts[2])
        valcrd = int(counts[3]) if len(counts) > 3 else 0
        line3 = f.readline()
        mxtype = line3.split()[0].lower()
        nums = line3.split()[1:]
        nrow, ncol, nnz = int(nums[0]), int(nums[1]), int(nums[2])
        fmts = f.readline()
        # format line: ptrfmt indfmt [valfmt]
        fmt_toks = re.findall(r"\([^)]*\)", fmts)
        ptrfmt, indfmt = fmt_toks[0], fmt_toks[1]
        valfmt = fmt_toks[2] if len(fmt_toks) > 2 else "(3E26.18)"

        indptr = _read_fixed(f, ptrfmt, ncol + 1, np.int64) - 1
        indices = _read_fixed(f, indfmt, nnz, np.int64) - 1
        data = None
        vtype, symtype = mxtype[0], mxtype[1]
        if vtype in ("r", "i") and valcrd > 0:
            data = _read_fixed(f, valfmt, nnz, np.float64)
        elif vtype == "c" and valcrd > 0:
            raw = _read_fixed(f, valfmt, 2 * nnz, np.float64)
            data = raw[0::2] + 1j * raw[1::2]
        stype = SYM_LOWER if symtype in ("s", "h") else UNSYM
        A = SparseCSC(indptr, indices, data, (nrow, ncol), stype=stype)
        if symtype == "z" and data is not None:
            # skew-symmetric: expand to full storage with negated mirror
            t = A.to_triplet()
            off = t.row != t.col
            row2 = np.concatenate([t.row, t.col[off]])
            col2 = np.concatenate([t.col, t.row[off]])
            val2 = np.concatenate([t.data, -t.data[off]])
            from ..core.sparse import Triplet
            A = Triplet(row2, col2, val2, (nrow, ncol)).to_csc()
        return A.sort_indices()


def rbwrite(path, A: SparseCSC, title: str = "suitesparse_tpu", key: str = "sstpu") -> None:
    A = A.sort_indices()
    pattern = A.data is None
    complex_ = (not pattern) and np.iscomplexobj(A.data)
    if A.stype > 0:
        A = A.transpose()  # RB symmetric stores lower triangle
    vtype = "p" if pattern else ("c" if complex_ else "r")
    symtype = "s" if A.stype != UNSYM else ("r" if A.nrow == A.ncol else "u")
    mxtype = f"{vtype}{symtype}a"

    ptr = A.indptr + 1
    ind = A.indices + 1
    ptr_lines = _format_ints(ptr, 8, 10)
    ind_lines = _format_ints(ind, 8, 10)
    val_lines = []
    if not pattern:
        vals = A.data
        if complex_:
            inter = np.empty(2 * len(vals))
            inter[0::2], inter[1::2] = vals.real, vals.imag
            vals = inter
        val_lines = _format_floats(vals, 3, 26, 18)

    with open(path, "w") as f:
        f.write(f"{title[:72]:<72}{key[:8]:<8}\n")
        f.write(f"{len(ptr_lines) + len(ind_lines) + len(val_lines):14d}"
                f"{len(ptr_lines):14d}{len(ind_lines):14d}{len(val_lines):14d}\n")
        f.write(f"{mxtype:<3}{'':11}{A.nrow:14d}{A.ncol:14d}{A.nnz:14d}{0:14d}\n")
        f.write(f"{'(8I10)':<16}{'(8I10)':<16}{'(3E26.18)':<20}\n")
        f.writelines(ptr_lines)
        f.writelines(ind_lines)
        f.writelines(val_lines)


def _format_ints(a, per_line, width):
    lines = []
    for k in range(0, len(a), per_line):
        chunk = a[k:k + per_line]
        lines.append("".join(f"{int(v):{width}d}" for v in chunk) + "\n")
    return lines


def _format_floats(a, per_line, width, prec):
    lines = []
    for k in range(0, len(a), per_line):
        chunk = a[k:k + per_line]
        lines.append("".join(f"{float(v):{width}.{prec}E}" for v in chunk) + "\n")
    return lines
