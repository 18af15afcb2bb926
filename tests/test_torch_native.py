"""The native COO->CSR converter and Matrix Market body parser.

``native/fast_csr.cpp`` (``CSRMatrix.from_coo``'s branch from 2,000,000
entries) must give the numpy path's arrays and the JAX ``from_coo``'s, array
equal; ``native/fast_mmio.cpp`` (the body parser from 16,384 entries) the
numpy parser's rows, columns and values, bit for bit, and the values
``write_matrix_market`` wrote. Both loaders raise where the JAX loaders fell
back to numpy. Matrices are made from seeds.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix as JCOO
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu_torch.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.io import mmio
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.native import build as nbuild


def _shuffled(coo, seed):
    """The entries of ``coo`` in a random order, so the converter sorts."""
    p = np.random.default_rng(seed).permutation(coo.nnz)
    return COOMatrix(coo.nrows, coo.ncols, coo.row[p], coo.col[p], coo.val[p])


MATRICES = {
    "banded": lambda: _shuffled(syn.banded(3000, 12, 200, seed=2), 1),
    "road": lambda: _shuffled(syn.road_network(4000, seed=5), 2),
    # rows of up to 170 entries: the converter's std::sort branch (> 32)
    "power_law": lambda: _shuffled(syn.power_law(3000, 3, seed=6), 3),
    "rectangular": lambda: _shuffled(
        syn.random_general(700, 1500, 0.01, seed=4), 4),
}


def _same_csr(a, b):
    assert (a.nrows, a.ncols) == (b.nrows, b.ncols)
    for f in ("row_ptr", "col_idx", "values"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_fast_csr_equals_numpy_and_jax(matrix):
    coo = MATRICES[matrix]()
    native = CSRMatrix.from_coo(coo, native=True)
    _same_csr(native, CSRMatrix.from_coo(coo, native=False))
    jcoo = JCOO(coo.nrows, coo.ncols, coo.row, coo.col, coo.val)
    _same_csr(native, JCSR.from_coo(jcoo, native=True))
    _same_csr(native, JCSR.from_coo(jcoo, native=False))


def test_fast_csr_is_the_default_from_the_threshold(monkeypatch):
    """From ``_NATIVE_MIN_NNZ`` f64 entries the converter runs, below it the
    numpy path; ``native=False`` forces numpy."""
    coo = MATRICES["banded"]()
    calls = []
    real = nbuild.coo_to_csr_native
    monkeypatch.setattr(nbuild, "coo_to_csr_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = CSRMatrix.from_coo(coo)
    assert not calls and coo.nnz < CSRMatrix._NATIVE_MIN_NNZ
    monkeypatch.setattr(CSRMatrix, "_NATIVE_MIN_NNZ", coo.nnz)
    _same_csr(CSRMatrix.from_coo(coo), want)
    assert calls == [1]
    CSRMatrix.from_coo(coo, native=False)
    assert calls == [1]


def test_fast_csr_raises_on_a_bad_row_and_when_it_cannot_build(
        monkeypatch, tmp_path):
    coo = MATRICES["banded"]()
    row = coo.row.copy()
    row[7] = coo.nrows + 3  # COOMatrix itself refuses it: a bare stand-in
    bad = SimpleNamespace(nrows=coo.nrows, ncols=coo.ncols, row=row,
                          col=coo.col, val=coo.val, nnz=coo.nnz)
    with pytest.raises(RuntimeError, match="fast_coo_to_csr failed"):
        CSRMatrix.from_coo(bad, native=True)
    monkeypatch.setattr(nbuild, "_BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", os.fspath(tmp_path / "no-such-compiler"))
    nbuild.load_fast_csr.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="converter cannot be built"):
            CSRMatrix.from_coo(coo, native=True)
    finally:
        nbuild.load_fast_csr.cache_clear()


def _write(path, coo, **kw):
    mmio.write_matrix_market(path, coo.nrows, coo.ncols, coo.row, coo.col,
                             coo.val, **kw)


@pytest.mark.parametrize("field", ["real", "integer", "pattern"])
def test_fast_mmio_equals_the_numpy_parser(field, tmp_path, monkeypatch):
    """A body past the native threshold (and past the parser's threading
    threshold, 65,536 entries) read natively and by numpy: the same
    arrays, and the values written, bit for bit (17 significant digits
    need a correctly rounded conversion)."""
    coo = syn.banded(9000, 9, 300, seed=7)
    assert coo.nnz > 1 << 16
    if field == "integer":
        coo = COOMatrix(coo.nrows, coo.ncols, coo.row, coo.col,
                        np.round(coo.val * 1000))
    path = os.fspath(tmp_path / "m.mtx")
    _write(path, coo, field=field)
    native = mmio.read_matrix_market(path)
    monkeypatch.setattr(mmio, "_NATIVE_MIN_NNZ", 1 << 40)
    plain = mmio.read_matrix_market(path)
    for a, b in zip(native[:5], plain[:5]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if field != "pattern":
        assert np.array_equal(np.asarray(native[4]), coo.val)


def test_fast_mmio_refuses_tokens_it_does_not_read(tmp_path):
    """A ``nan`` value sends the body to the numpy parser, which reads it;
    Fortran ``D`` exponents, which numpy does not read, are read natively."""
    n = 1 << 14
    rows = np.arange(1, n + 1)
    vals = ["1.5e+02"] * n
    vals[5] = "nan"
    path = tmp_path / "m.mtx"
    body = "".join(f"{r} {r} {v}\n" for r, v in zip(rows, vals))
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    f"{n} {n} {n}\n" + body)
    raw = path.read_bytes()
    offset = raw.index(b"\n", raw.index(b"\n") + 1) + 1
    assert nbuild.parse_body_native(raw, n, 3, offset=offset) is None
    got = mmio.read_matrix_market(os.fspath(path))
    vals = np.asarray(got[4])
    assert np.isnan(vals[5]) and np.all(np.delete(vals, 5) == 150.0)
    path.write_bytes(raw.replace(b"nan", b"2d0").replace(b"e+02", b"D+02"))
    r, c, v = nbuild.parse_body_native(path.read_bytes(), n, 3,
                                       offset=offset)
    assert v[5] == 2.0 and np.all(np.delete(v, 5) == 150.0)
    assert np.array_equal(r, rows) and np.array_equal(c, rows)


def test_fast_mmio_raises_when_it_cannot_build(monkeypatch, tmp_path):
    coo = syn.banded(3000, 9, 300, seed=7)
    path = os.fspath(tmp_path / "m.mtx")
    _write(path, coo)
    monkeypatch.setattr(nbuild, "_BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", os.fspath(tmp_path / "no-such-compiler"))
    nbuild.load_fast_mmio.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="parser cannot be built"):
            mmio.read_matrix_market(path)
    finally:
        nbuild.load_fast_mmio.cache_clear()
