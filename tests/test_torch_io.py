"""The port's host-only I/O and mesh modules against the JAX reference:
io/matrixmarket.py, io/rbio.py, io/fixtures.py, io/collection.py and
models/meshnd.py.  Files are crossed both ways between the packages and
the written bytes are identical; corrupted files raise the same error
(type and SparseError status) in both, each read under a time limit;
collection.get and fixtures.load resolve the same names the same way
with no network and no reference checkout (both are pointed at empty or
missing directories here); meshnd/meshsparse are identical."""
import contextlib
import importlib
import io as _io
import signal

import numpy as np
import pytest
import scipy.sparse as sp

from suitesparse_tpu import io as ref_io
from suitesparse_tpu.core import sparse as ref_sparse
from suitesparse_tpu.io import collection as ref_collection
from suitesparse_tpu.io import fixtures as ref_fixtures

from suitesparse_tpu_torch import io as port_io
from suitesparse_tpu_torch.core import sparse as port_sparse
from suitesparse_tpu_torch.io import collection as port_collection
from suitesparse_tpu_torch.io import fixtures as port_fixtures

# the packages' models/__init__ export the function meshnd over the module
ref_meshnd = importlib.import_module("suitesparse_tpu.models.meshnd")
port_meshnd = importlib.import_module("suitesparse_tpu_torch.models.meshnd")

READ_LIMIT_S = 10


def _rand(m, n, seed, d=0.4):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=d, random_state=rng, format="csc")


def _pair(S, stype=0, pattern=False):
    S = sp.csc_matrix(S)
    S.sort_indices()
    data = None if pattern else S.data
    return (ref_sparse.SparseCSC(S.indptr, S.indices, data, S.shape,
                                 stype=stype),
            port_sparse.SparseCSC(S.indptr, S.indices, data, S.shape,
                                  stype=stype))


def _sym_upper(seed):
    S = _rand(6, 6, seed)
    S = S + S.T + 6 * sp.identity(6)
    return sp.triu(S).tocsc()


def _herm_upper(seed):
    S = _rand(6, 6, seed).astype(complex)
    S = S + 1j * _rand(6, 6, seed + 1)
    S = S + S.conj().T + 6 * sp.identity(6)
    return sp.triu(S).tocsc()


MATRICES = {
    "general": lambda: _pair(_rand(7, 5, 13)),
    "square": lambda: _pair(_rand(8, 8, 18)),
    "symmetric": lambda: _pair(_sym_upper(14), stype=1),
    "pattern": lambda: _pair(_rand(5, 5, 15), pattern=True),
    "complex": lambda: _pair(_rand(6, 4, 19).astype(complex)
                             + 1j * _rand(6, 4, 20)),
    "hermitian": lambda: _pair(_herm_upper(21), stype=1),
}


def _same_csc(a, b):
    assert tuple(a.shape) == tuple(b.shape) and a.stype == b.stype
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    if a.data is None:
        assert b.data is None
    else:
        assert a.data.dtype == b.data.dtype
        assert np.array_equal(a.data, b.data)


@contextlib.contextmanager
def _time_limit(seconds=READ_LIMIT_S):
    """Raise TimeoutError in the main thread if the body runs too long
    (a reader that hangs on a corrupted file fails instead of stalling)."""
    def on_alarm(signum, frame):
        raise TimeoutError(f"read took more than {seconds} s")
    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_matrixmarket_crossed_both_ways(name, tmp_path):
    Ar, Ap = MATRICES[name]()
    pr, pp = tmp_path / "ref.mtx", tmp_path / "port.mtx"
    ref_io.mmwrite(pr, Ar, comment="crossed")
    port_io.mmwrite(pp, Ap, comment="crossed")
    assert pr.read_bytes() == pp.read_bytes()
    with _time_limit():
        _same_csc(ref_io.mmread(pp), port_io.mmread(pr))
        _same_csc(port_io.mmread(pp), ref_io.mmread(pr))


@pytest.mark.parametrize("complex_", [False, True])
def test_matrixmarket_dense_crossed(complex_, tmp_path):
    M = np.random.default_rng(1).standard_normal((4, 3))
    if complex_:
        M = M + 1j * np.random.default_rng(2).standard_normal((4, 3))
    pr, pp = tmp_path / "ref.mtx", tmp_path / "port.mtx"
    ref_io.mmwrite(pr, M)
    port_io.mmwrite(pp, M)
    assert pr.read_bytes() == pp.read_bytes()
    a, b = port_io.mmread_dense(pr), ref_io.mmread_dense(pp)
    assert np.array_equal(a, b) and np.array_equal(a, M)


def test_matrixmarket_gz_and_stream(tmp_path):
    Ar, Ap = MATRICES["general"]()
    p = tmp_path / "a.mtx.gz"
    ref_io.mmwrite(p, Ar)
    _same_csc(port_io.mmread(p), ref_io.mmread(p))
    text = """%%MatrixMarket matrix coordinate real skew-symmetric
% comment
3 3 2
2 1 2.5
3 2 -1
"""
    _same_csc(port_io.mmread(_io.StringIO(text)),
              ref_io.mmread(_io.StringIO(text)))
    sym = """%%MatrixMarket matrix array real symmetric
3 3
1
2
3
4
5
6
"""
    assert np.array_equal(port_io.mmread_dense(_io.StringIO(sym)),
                          ref_io.mmread_dense(_io.StringIO(sym)))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_rutherford_boeing_crossed_both_ways(name, tmp_path):
    Ar, Ap = MATRICES[name]()
    pr, pp = tmp_path / "ref.rb", tmp_path / "port.rb"
    ref_io.rbwrite(pr, Ar)
    port_io.rbwrite(pp, Ap)
    assert pr.read_bytes() == pp.read_bytes()
    assert port_io.rbkind(pr) == ref_io.rbkind(pp)
    with _time_limit():
        _same_csc(ref_io.rbread(pp), port_io.rbread(pr))
        _same_csc(port_io.rbread(pp), ref_io.rbread(pr))


def test_rutherford_boeing_title_and_key(tmp_path):
    Ar, Ap = MATRICES["square"]()
    pr, pp = tmp_path / "ref.rb", tmp_path / "port.rb"
    ref_io.rbwrite(pr, Ar, title="a title", key="KEY1")
    port_io.rbwrite(pp, Ap, title="a title", key="KEY1")
    assert pr.read_bytes() == pp.read_bytes()
    assert pr.read_text().splitlines()[0].endswith("KEY1    ")


def _skew_rb(tmp_path):
    """A skew-symmetric ('rza') file: rbread expands the mirror."""
    text = ("skew example" + " " * 60 + "key     \n"
            f"{3:14d}{1:14d}{1:14d}{1:14d}\n"
            f"rza{'':11}{3:14d}{3:14d}{2:14d}{0:14d}\n"
            "(8I10)          (8I10)          (3E26.18)           \n"
            f"{1:10d}{2:10d}{3:10d}{3:10d}\n"
            f"{2:10d}{3:10d}\n"
            f"{2.5:26.18E}{-1.0:26.18E}\n")
    p = tmp_path / "skew.rb"
    p.write_text(text)
    return p


def test_rutherford_boeing_skew(tmp_path):
    p = _skew_rb(tmp_path)
    with _time_limit():
        _same_csc(port_io.rbread(p), ref_io.rbread(p))
    assert port_io.rbkind(p) == ref_io.rbkind(p) == "rza"


MM_CORRUPT = {
    "bad_object": "%%MatrixMarket junk coordinate real general\n",
    "bad_format": "%%MatrixMarket matrix junk real general\n",
    "bad_field": "%%MatrixMarket matrix coordinate junk general\n",
    "bad_symmetry": "%%MatrixMarket matrix coordinate real junk\n",
    "comments_only": "%%MatrixMarket matrix coordinate real general\n"
                     "%only comments\n",
    "not_mm": "hello world\n",
    "empty": "",
    "short_header": "%%MatrixMarket matrix coordinate\n",
    "truncated_body": "%%MatrixMarket matrix coordinate real general\n"
                      "3 3 4\n1 1 2.5\n2 2\n",
    "bad_number": "%%MatrixMarket matrix coordinate real general\n"
                  "2 2 1\n1 1 x\n",
    "bad_size": "%%MatrixMarket matrix coordinate real general\n"
                "three 3 1\n1 1 1\n",
    "array_short": "%%MatrixMarket matrix array real general\n2 2\n1\n2\n",
}


def _outcome(fn, *args):
    """(exception type name, SparseError status or None) of fn(*args),
    or ("ok", None)."""
    try:
        with _time_limit():
            fn(*args)
    except TimeoutError:
        raise
    except Exception as e:     # noqa: BLE001 -- the outcome is compared
        return type(e).__name__, getattr(getattr(e, "status", None),
                                         "name", None)
    return "ok", None


@pytest.mark.parametrize("name", sorted(MM_CORRUPT))
def test_corrupted_matrixmarket_fails_like_the_reference(name, tmp_path):
    p = tmp_path / f"{name}.mtx"
    p.write_text(MM_CORRUPT[name])
    want = _outcome(ref_io.mmread, p)
    got = _outcome(port_io.mmread, p)
    assert got == want
    assert got[0] != "ok"


def _rb_lines(tmp_path):
    Ar, _ = MATRICES["square"]()
    p = tmp_path / "good.rb"
    ref_io.rbwrite(p, Ar)
    return p.read_text().splitlines(keepends=True)


RB_CORRUPT = {
    "truncated_values": lambda ls: ls[:-1],
    "truncated_indices": lambda ls: ls[:5],
    "headers_only": lambda ls: ls[:4],
    "bad_format_line": lambda ls: ls[:3] + ["no formats here\n"] + ls[4:],
    "bad_count": lambda ls: [ls[0], "x y z w\n"] + ls[2:],
    "bad_pointer": lambda ls: ls[:4] + ["       abc" + ls[4][10:]] + ls[5:],
    "empty": lambda ls: [],
}


@pytest.mark.parametrize("name", sorted(RB_CORRUPT))
def test_corrupted_rutherford_boeing_fails_like_the_reference(name,
                                                              tmp_path):
    p = tmp_path / f"{name}.rb"
    p.write_text("".join(RB_CORRUPT[name](_rb_lines(tmp_path))))
    want = _outcome(ref_io.rbread, p)
    got = _outcome(port_io.rbread, p)
    assert got == want
    assert got[0] != "ok"


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """An empty collection cache and no reference checkout, for both
    packages; the stats index caches are cleared before and after."""
    cache = tmp_path / "collection"
    monkeypatch.setenv("SSTPU_COLLECTION", str(cache))
    monkeypatch.setenv("SSTPU_REFERENCE", str(tmp_path / "no_reference"))
    for mod in (ref_collection, port_collection):
        mod.stats_index.cache_clear()
    yield cache
    for mod in (ref_collection, port_collection):
        mod.stats_index.cache_clear()


@pytest.mark.parametrize("name", ["lap3d_6", "lap2d_10", "randspd_60",
                                  "circuit_120", "randunsym_50"])
def test_collection_standin_names_equal(offline, name):
    try:
        want = ref_collection.get(name)
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            port_collection.get(name)
        return
    _same_csc(port_collection.get(name), want)
    assert port_collection.stats(name) == ref_collection.stats(name)


def test_collection_real_names_raise_offline(offline):
    for name in ("nd6k", "HB/bcsstk01", "Franz6_id1959_aug"):
        with pytest.raises(FileNotFoundError):
            ref_collection.get(name)
        with pytest.raises(FileNotFoundError):
            port_collection.get(name)
    # fetch=True with a bare name stops before any download is tried
    for mod in (ref_collection, port_collection):
        with pytest.raises(ValueError, match="group/name"):
            mod.get("nd6k", fetch=True)


def test_collection_cache_and_stats_index(offline):
    """A matrix in the cache directory resolves by group/name and bare
    name; an ssstats.csv there drives lookup/search/stats_index."""
    Ar, Ap = MATRICES["square"]()
    (offline / "HB").mkdir(parents=True)
    ref_io.mmwrite(offline / "HB" / "mine.mtx", Ar)
    _same_csc(port_collection.get("HB/mine"), ref_collection.get("HB/mine"))
    for mod in (ref_collection, port_collection):   # bare names: top level
        with pytest.raises(FileNotFoundError):
            mod.get("mine")
    rows = ["HB,mine,8,8,0,1,0,0,1,0.5,0.25,structural problem,20",
            "G,other,5000,5000,0,1,0,0,1,1.0,1.0,2D mesh,30000",
            "G,wide,10,20,0,1,0,0,0,0.0,0.0,lp,40"]
    (offline / "ssstats.csv").write_text(
        f"{len(rows)}\n31-Dec-2020\n" + "\n".join(rows) + "\n")
    assert port_collection.stats_index() == ref_collection.stats_index()
    assert len(port_collection.stats_index()) == 3
    assert port_collection.lookup("HB/mine") == ref_collection.lookup(
        "HB/mine")
    for kw in (dict(min_n=1000), dict(posdef=True), dict(square=False),
               dict(kind="mesh"), dict(min_psym=0.3)):
        assert port_collection.search(**kw) == ref_collection.search(**kw)
    assert port_collection.stats("HB/mine") == ref_collection.stats(
        "HB/mine")
    assert port_collection.index(["mine"]) == ref_collection.index(["mine"])


def test_fixtures_without_a_reference_checkout(offline):
    assert port_fixtures.reference_root() is None
    assert ref_fixtures.reference_root() is None
    assert port_fixtures.available() == ref_fixtures.available() == []
    for mod in (ref_fixtures, port_fixtures):
        with pytest.raises(FileNotFoundError):
            mod.load("bcsstk01")


def test_fixtures_from_a_checkout(tmp_path, monkeypatch):
    """A stand-in checkout with a triplet, a MatrixMarket and an RB file
    under the reference's paths: both packages load the same matrices."""
    root = tmp_path / "ref"
    monkeypatch.setenv("SSTPU_REFERENCE", str(root))
    (root / "CSparse" / "Matrix").mkdir(parents=True)
    (root / "KLU" / "Matrix").mkdir(parents=True)
    (root / "RBio" / "RBio" / "private").mkdir(parents=True)
    S = sp.tril(_sym_upper(30).T).tocoo()
    np.savetxt(root / "CSparse" / "Matrix" / "bcsstk16",
               np.column_stack([S.row, S.col, S.data]))
    U = sp.coo_matrix(_rand(8, 8, 31))
    np.savetxt(root / "CSparse" / "Matrix" / "t1",
               np.column_stack([U.row, U.col, U.data]))
    Ar, _ = MATRICES["square"]()
    ref_io.mmwrite(root / "KLU" / "Matrix" / "impcol_a.mtx", Ar)
    ref_io.rbwrite(root / "RBio" / "RBio" / "private" / "west0479.rua", Ar)
    assert port_fixtures.available() == ref_fixtures.available()
    assert len(port_fixtures.available()) == 4
    for name in ("bcsstk16", "t1", "impcol_a", "west0479"):
        _same_csc(port_fixtures.load(name), ref_fixtures.load(name))
    assert port_fixtures.load("bcsstk16").stype != 0      # detect_sym
    assert port_fixtures.load("t1").stype == 0
    for mod in (ref_fixtures, port_fixtures):
        with pytest.raises(KeyError):
            mod.load("not_a_fixture")
        with pytest.raises(FileNotFoundError):
            mod.load("arc130")


@pytest.mark.parametrize("shape", [(8, 8), (5, 7), (4, 4, 4), (3, 5, 2)])
def test_meshnd_identical(shape):
    got = port_meshnd.meshnd(*shape)
    want = ref_meshnd.meshnd(*shape)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shape,stencil", [((8, 8), 5), ((6, 5), 9),
                                           ((4, 4, 4), 7), ((3, 4, 3), 27)])
def test_meshsparse_identical(shape, stencil):
    G = port_meshnd.meshnd(*shape)[0]
    _same_csc(port_meshnd.meshsparse(G, stencil),
              ref_meshnd.meshsparse(G, stencil))
    for mod in (ref_meshnd, port_meshnd):
        with pytest.raises(ValueError):
            mod.meshsparse(G, 11)
