"""SuiteSparse Matrix Collection client (ssget equivalent).

Counterpart of suitesparse_tpu/io/collection.py, copied.

Reference: ssget/README.txt + ssget.m — fetch matrices by id or
group/name, cache locally, expose the stats index (ssstats.csv, column
layout per ssgui.java load_ssstats: Group, Name, nrows, ncols, nnz,
isReal, isBinary, isND, posdef, psym, nsym, kind, nentries).

Resolution order for :func:`get` (no network egress in this environment):
  1. local cache directory (``SSTPU_COLLECTION`` or ``~/.sstpu_collection``)
     holding ``<group>/<name>.mtx[.gz]`` / ``.rb``/``.rua``/``.rsa``;
  2. matrices bundled with the repo under ``matrices/``;
  3. **genuine fixtures bundled with the reference checkout**
     (:mod:`.fixtures` — the same real matrices the
     reference's demos/Tcov run on);
  4. honest parametric synthetic names (``lap3d_28``, ``circuit_3000`` …,
     :mod:`generators`).  A synthetic matrix is never served under a real
     collection matrix's name: unknown real names raise.
When network is available, ``fetch=True`` downloads from sparse.tamu.edu
exactly like ssget does.
"""
from __future__ import annotations

import functools
import os
import pathlib
import tarfile
import urllib.request

from ..core.sparse import SparseCSC
from . import fixtures, generators
from .matrixmarket import mmread
from .rbio import rbread

_BASE_URL = "https://sparse.tamu.edu"


def cache_dir() -> pathlib.Path:
    d = pathlib.Path(os.environ.get("SSTPU_COLLECTION",
                                    os.path.expanduser("~/.sstpu_collection")))
    d.mkdir(parents=True, exist_ok=True)
    return d


def _repo_matrices_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2] / "matrices"


def get(name: str, fetch: bool = False) -> SparseCSC:
    """ssget(name): return the matrix as SparseCSC.

    ``name`` is ``group/name`` or bare ``name``.  Real names resolve only
    to genuine files (cache, bundled, reference fixtures, or download);
    synthetic generators are reachable only through their own honest
    parametric names (``lap3d_28`` etc.).
    """
    bare = name.split("/")[-1]
    for root in (cache_dir(), _repo_matrices_dir()):
        for ext in (".mtx", ".mtx.gz", ".rb", ".rua", ".rsa"):
            for cand in (root / (name + ext), root / (bare + ext)):
                if cand.exists():
                    if ext.startswith(".mtx"):
                        return mmread(str(cand))
                    return rbread(str(cand))
    try:
        return fixtures.load(bare)
    except (KeyError, FileNotFoundError):
        pass
    if fetch:
        return _download(name)
    gen = generators.synthetic_standin(bare)
    if gen is not None:
        return gen
    raise FileNotFoundError(
        f"matrix {name!r} not in cache, not bundled, not a reference "
        f"fixture ({', '.join(fixtures.available()) or 'none found'}); "
        f"re-run with fetch=True on a networked machine, or use an honest "
        f"synthetic name (lap3d_28, lap2d_100, randspd_5000, circuit_3000)")


def _download(name: str) -> SparseCSC:
    if "/" not in name:
        raise ValueError("fetch requires 'group/name'")
    group, bare = name.split("/")
    url = f"{_BASE_URL}/MM/{group}/{bare}.tar.gz"
    dest = cache_dir() / group
    dest.mkdir(parents=True, exist_ok=True)
    tar_path = dest / f"{bare}.tar.gz"
    urllib.request.urlretrieve(url, tar_path)
    with tarfile.open(tar_path) as tf:
        tf.extractall(dest)
    return mmread(str(dest / bare / f"{bare}.mtx"))


# -- stats index (ssget ssstats.csv) ------------------------------------------

def _stats_csv() -> pathlib.Path | None:
    for cand in (cache_dir() / "ssstats.csv",
                 (fixtures.reference_root() or pathlib.Path("/nonexistent"))
                 / "ssget/files/ssstats.csv"):
        if cand.exists():
            return cand
    return None


@functools.lru_cache(maxsize=1)
def stats_index() -> list[dict]:
    """The full collection stats index (2856 matrices in v5.13.0's csv):
    one dict per matrix with id/group/name/nrows/ncols/nnz/isReal/isBinary/
    isND/posdef/psym/nsym/kind (ssgui.java:1055-1105 column layout)."""
    path = _stats_csv()
    if path is None:
        return []
    out = []
    with open(path) as f:
        try:
            nmat = int(f.readline())
        except ValueError:
            return []
        f.readline()  # creation date
        for mid in range(1, nmat + 1):
            line = f.readline()
            if not line:
                break
            r = line.rstrip("\n").split(",")
            if len(r) < 13:
                continue
            out.append(dict(
                id=mid, group=r[0], name=r[1],
                nrows=int(r[2]), ncols=int(r[3]), nnz=int(r[12]),
                isReal=r[4 + 1] == "1", isBinary=r[6] == "1",
                isND=r[7] == "1", posdef=r[8] == "1",
                psym=float(r[9]), nsym=float(r[10]), kind=r[11]))
    return out


def lookup(name: str) -> dict | None:
    """Stats record for one matrix by bare or group/name."""
    bare = name.split("/")[-1]
    group = name.split("/")[0] if "/" in name else None
    for rec in stats_index():
        if rec["name"] == bare and (group is None or rec["group"] == group):
            return rec
    return None


def search(min_n: int = 0, max_n: int = 2**62, posdef: bool | None = None,
           kind: str | None = None, min_psym: float = 0.0,
           square: bool | None = None, max_nnz: int = 2**62) -> list[dict]:
    """Property-driven matrix selection (the ssgui filter panel as an API):
    pick benchmark matrices by size/symmetry/kind."""
    out = []
    for rec in stats_index():
        n = max(rec["nrows"], rec["ncols"])
        if not (min_n <= n <= max_n and rec["nnz"] <= max_nnz):
            continue
        if posdef is not None and rec["posdef"] != posdef:
            continue
        if square is not None and (rec["nrows"] == rec["ncols"]) != square:
            continue
        if rec["psym"] < min_psym:
            continue
        if kind is not None and kind not in rec["kind"]:
            continue
        out.append(rec)
    return out


def stats(name: str, fetch: bool = False) -> dict:
    """Per-matrix stats record: from the collection index when the matrix
    is catalogued, otherwise computed locally from the matrix itself."""
    rec = lookup(name)
    if rec is not None:
        return rec
    A = get(name, fetch=fetch)
    from ..core.sparse import symmetry as _symmetry
    sym, nzdiag = _symmetry(A) if A.stype == 0 else (1.0, min(A.shape))
    rec = {
        "name": name,
        "nrows": A.nrow,
        "ncols": A.ncol,
        "nnz": A.nnz,
        "stype": A.stype,
        "psym": sym,
        "nzdiag": nzdiag,
        "is_square": A.nrow == A.ncol,
    }
    if A.data is not None and A.nrow == A.ncol and sym == 1.0:
        d = A.diagonal()
        rec["posdef_candidate"] = bool((d > 0).all())
    return rec


def index(names=None) -> list:
    """Stats index over locally available genuine fixtures (by default)."""
    names = names or fixtures.available()
    return [stats(n) for n in names]
