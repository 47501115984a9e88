"""The port's block-triangular form (graph/btf.py) and column orderings
(ordering/colamd.py) against the JAX reference: host code copied from it,
so every permutation, block boundary and count is identical."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from suitesparse_tpu import graph as ref_graph
from suitesparse_tpu import ordering as ref_ord
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC

from suitesparse_tpu_torch import graph as port_graph
from suitesparse_tpu_torch import ordering as port_ord
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.io import generators


def _mats():
    """(name, scipy CSC) with seeds: square unsymmetric, reducible,
    structurally singular, rectangular (dmperm and colamd only)."""
    rng = np.random.default_rng(3)
    sing = sp.random(30, 30, density=0.2, random_state=rng).tolil()
    sing[:, 4] = 0
    sing[7, :] = 0
    tri = sp.triu(sp.random(50, 50, density=0.1, random_state=rng), 1) \
        + sp.identity(50)
    tri = tri.tolil()
    tri[10, 3] = tri[20, 12] = tri[12, 10] = 1.0
    return [
        ("random_unsym", generators.random_unsym(120, 0.03, seed=1)
         .to_scipy()),
        ("circuit_like", generators.circuit_like(150, seed=2).to_scipy()),
        ("reducible", tri.tocsc()),
        ("singular", sing.tocsc()),
        ("rect", sp.random(25, 40, density=0.15, random_state=rng,
                           format="csc")),
        ("laplacian_2d", generators.laplacian_2d(9).to_scipy()),
    ]


MATS = _mats()


def _pair(S):
    S = sp.csc_matrix(S)
    S.sort_indices()
    return (RefCSC.from_scipy(S), PortCSC.from_scipy(S))


def _same(a, b):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("name,S", MATS)
def test_btf_functions_are_the_reference(name, S):
    Ar, Ap = _pair(S)
    _same(ref_graph.dmperm(Ar), port_graph.dmperm(Ap))
    if S.shape[0] != S.shape[1]:
        return
    _same(ref_graph.maxtrans(Ar), port_graph.maxtrans(Ap))
    _same(ref_graph.btf_order(Ar), port_graph.btf_order(Ap))
    assert port_graph.btf_order(Ap).nblocks == ref_graph.btf_order(Ar).nblocks
    _same(ref_graph.strongcomp(Ar.indptr, Ar.indices, Ar.ncol),
          port_graph.strongcomp(Ap.indptr, Ap.indices, Ap.ncol))


@pytest.mark.parametrize("name,S", MATS)
def test_column_orderings_are_the_reference(name, S):
    Ar, Ap = _pair(S)
    n = S.shape[1]
    _same(ref_ord.colamd(Ar), port_ord.colamd(Ap))
    _same(ref_ord.colamd(Ar, dense_row=0.5), port_ord.colamd(Ap,
                                                             dense_row=0.5))
    cmember = (np.arange(n) % 3).astype(np.int64)
    _same(ref_ord.ccolamd(Ar, cmember), port_ord.ccolamd(Ap, cmember))
    if S.shape[0] == S.shape[1]:
        Sym = sp.csc_matrix(S + S.T)
        Br, Bp = _pair(Sym)
        _same(ref_ord.symamd(Br), port_ord.symamd(Bp))
        _same(ref_ord.csymamd(Br, cmember), port_ord.csymamd(Bp, cmember))


def test_colamd_python_path_is_the_reference(monkeypatch):
    """Without the native library both packages fall back to AMD on the
    pattern of A'A."""
    from suitesparse_tpu.utils import native as ref_native
    from suitesparse_tpu_torch.utils import native as port_native
    monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    monkeypatch.setattr(port_native, "get_lib", lambda: None)
    for _, S in MATS:
        Ar, Ap = _pair(S)
        _same(ref_ord.colamd(Ar), port_ord.colamd(Ap))
