"""The port's BSR layer against the JAX package: the host blocking
(formats/bsr.py, numpy and native/fast_bsr.cpp), the RHS padding, the CSR
twins of ops/xla.py and the plain BSR SpMM of ops/bsr.py.

On the CPU the wrappers run the plain PyTorch version of the CUDA kernel;
it is held against the JAX package's Pallas kernel in interpret mode at the
JAX tests' rtol=2e-5, atol=2e-5*max|Y| (both sum in f32, in another order),
and against the CSR twins. bf16 is held against the fp64 oracle of the
bf16-rounded operands at rtol=atol=1e-5 relative to max|Y| (f32 sums of
exact products).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.formats.bsr import BSRMatrix as JBSR
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops.pallas_bsr import (
    bsr_spmm_pallas,
    device_put_bsr as jax_device_put_bsr,
    pad_rhs as jax_pad_rhs,
)
from sparsematrixvectormultiplication_tpu.ops.xla import (
    csr_spmm as jax_csr_spmm,
    csr_spmv as jax_csr_spmv,
)
from sparsematrixvectormultiplication_tpu_torch import BSRMatrix, CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.bench.harness import quantize_bf16
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.native import build as nbuild
from sparsematrixvectormultiplication_tpu_torch.ops import bsr as BSR
from sparsematrixvectormultiplication_tpu_torch.ops.xla import (
    csr_spmm,
    csr_spmv,
)


def _dup_csr(pkg_csr):
    """Row 5 holds (5, 9) twice: duplicates must sum."""
    return pkg_csr(6, 12, np.array([0, 0, 0, 0, 0, 0, 2], np.int64),
                   np.array([9, 9], np.int32), np.array([1.0, 2.0]))


# case -> (matrix from a synthetic module or CSR class, from_csr keywords);
# the JAX tests/test_bsr.py shapes
CASES = {
    "banded": (lambda m, C: C.from_coo(m.banded(700, 9, 40, seed=3)), {}),
    "fem": (lambda m, C: C.from_coo(m.fem_3d(6, 6, 6, dof=3, seed=1)),
            {"value_dtype": np.float64}),
    "duplicates": (lambda m, C: _dup_csr(C), {}),
    "empty": (lambda m, C: C(5, 9, np.zeros(6, np.int64),
                             np.zeros(0, np.int32), np.zeros(0)), {}),
    "one": (lambda m, C: C(1, 1, np.array([0, 1], np.int64),
                           np.array([0], np.int32), np.array([2.5])), {}),
}


def _same(mine, theirs):
    for f in ("nrows", "ncols", "nnz", "kb", "n_block_rows", "n_real_blocks",
              "n_block_cols", "fill", "pad_ratio", "nbytes"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.blocks.dtype == theirs.blocks.dtype
    np.testing.assert_array_equal(mine.blocks, theirs.blocks)
    np.testing.assert_array_equal(mine.block_cols, theirs.block_cols)


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_csr_matches_jax(case):
    make, kw = CASES[case]
    mine = BSRMatrix.from_csr(make(syn, CSRMatrix), **kw)
    theirs = JBSR.from_csr(make(jsyn, JCSR), **kw)
    _same(mine, theirs)
    X = np.random.default_rng(1).standard_normal((mine.ncols, 3))
    np.testing.assert_array_equal(mine.spmm(X), theirs.spmm(X))
    np.testing.assert_array_equal(mine.spmm(X[:, 0]), theirs.spmm(X[:, 0]))


def test_duplicates_sum():
    bsr = BSRMatrix.from_csr(_dup_csr(CSRMatrix))
    x = np.zeros(12)
    x[9] = 1.0
    assert bsr.spmm(x[:, None])[5, 0] == 3.0


def _native_case():
    """The JAX test's native case: an adjacent duplicate in row 0 and 300
    empty tail rows (an empty block row)."""
    csr = CSRMatrix.from_coo(syn.banded(5000, 9, 40, seed=30))
    row_ptr = csr.row_ptr.copy()
    ci = np.concatenate([csr.col_idx[:1], csr.col_idx])
    va = np.concatenate([csr.values[:1], csr.values])
    row_ptr[1:] += 1
    return CSRMatrix(csr.nrows + 300, csr.ncols,
                     np.concatenate([row_ptr, np.full(300, row_ptr[-1])]),
                     ci, va)


@pytest.mark.parametrize("value_dtype", [np.float32, np.float64])
def test_native_matches_numpy_and_jax(value_dtype):
    csr = _native_case()
    native = BSRMatrix.from_csr(csr, native=True, value_dtype=value_dtype)
    assert nbuild.library_path("fastbsr").exists()
    _same(native, BSRMatrix.from_csr(csr, native=False,
                                     value_dtype=value_dtype))
    jcsr = JCSR(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx, csr.values)
    _same(native, JBSR.from_csr(jcsr, native=False, value_dtype=value_dtype))


@pytest.mark.parametrize("native", [False, True])
def test_budget_refusal(native):
    """Both blockers refuse a scattered matrix over the byte budget with the
    budget in the message, as the JAX blocker does."""
    coo = syn.random_general(4000, 4000, 0.001, seed=2)
    with pytest.raises(ValueError, match="budget"):
        BSRMatrix.from_csr(CSRMatrix.from_coo(coo), max_bytes=1 << 20,
                           native=native)
    with pytest.raises(ValueError, match="budget"):
        JBSR.from_csr(JCSR.from_coo(jsyn.random_general(4000, 4000, 0.001,
                                                        seed=2)),
                      max_bytes=1 << 20)


def test_native_raises_instead_of_falling_back(monkeypatch, tmp_path):
    csr = CSRMatrix.from_coo(syn.banded(700, 9, 40, seed=3))
    with pytest.raises(ValueError, match="float32 or float64"):
        BSRMatrix.from_csr(csr, native=True, value_dtype=np.float16)
    monkeypatch.setattr(nbuild, "_BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", os.fspath(tmp_path / "no-such-compiler"))
    nbuild.load_fast_bsr.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="BSR blocker cannot be built"):
            BSRMatrix.from_csr(csr, native=True)
    finally:
        nbuild.load_fast_bsr.cache_clear()


@pytest.mark.parametrize("width", [1, 9, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pad_rhs_matches_jax(dtype, width):
    X = np.random.default_rng(2).standard_normal((300, width))
    X[0, 0] = 1 + 2**-8 + 2**-30  # a bf16 tie broken only below f32
    if width == 1:
        X = X[:, 0]
    mine = BSR.pad_rhs(X, 300, getattr(torch, dtype), device="cpu")
    theirs = jax_pad_rhs(X, 300, dtype=getattr(jnp, dtype), to_device=False)
    assert mine.dtype == getattr(torch, dtype)
    assert tuple(mine.shape) == theirs.shape == (384, -(-width // 128) * 128)
    np.testing.assert_array_equal(mine.float().numpy(),
                                  theirs.astype(np.float32))


def _banded_case():
    csr = CSRMatrix.from_coo(syn.banded(500, 7, 30, seed=5))
    jcsr = JCSR.from_coo(jsyn.banded(500, 7, 30, seed=5))
    X = np.random.default_rng(3).standard_normal((csr.ncols, 9))
    return csr, jcsr, X


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("route", sorted(BSR.ROUTES))
def test_plain_matches_pallas_interpret(route):
    """The JAX test_bsr.py case: raw and padded X, both routes."""
    csr, jcsr, X = _banded_case()
    jd = jax_device_put_bsr(JBSR.from_csr(jcsr))
    d = BSR.device_put_bsr(BSRMatrix.from_csr(csr), device="cpu")
    want = np.asarray(bsr_spmm_pallas(jd, jax_pad_rhs(X, csr.ncols),
                                      interpret=True, route=route))
    xp = BSR.pad_rhs(X, csr.ncols, device="cpu")
    before = BSR.ROUTES[route].launches
    got = BSR.bsr_spmm(d, xp, route=route)
    assert BSR.ROUTES[route].launches == before  # CPU: the plain version
    assert tuple(got.shape) == want.shape == (csr.nrows, 128)
    _close(got, want, 2e-5)
    raw = BSR.bsr_spmm(d, torch.from_numpy(X).float(), route=route)
    assert tuple(raw.shape) == (csr.nrows, 9)
    _close(raw, want[:, :9], 2e-5)
    _close(BSR.bsr_spmm_plain(d, xp), want, 2e-5)


def test_plain_matches_csr_twins():
    """bsr_spmm_plain against the port's csr_spmm (f64, index_add_) and the
    JAX csr_spmm on the same arrays; the CSR twins against each other."""
    csr, jcsr, X = _banded_case()
    row_ids = csr.row_ids()
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    mine = csr_spmm(t(csr.values), t(csr.col_idx), t(row_ids), t(X),
                    nrows=csr.nrows)
    theirs = np.asarray(jax_csr_spmm(
        jnp.asarray(csr.values, jnp.float32), jnp.asarray(csr.col_idx),
        jnp.asarray(row_ids), jnp.asarray(X, jnp.float32), nrows=csr.nrows))
    ref = np.column_stack([csr.spmv(X[:, j]) for j in range(X.shape[1])])
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-12, atol=1e-12)
    _close(theirs, ref, 2e-5)
    d = BSR.device_put_bsr(BSRMatrix.from_csr(csr), device="cpu")
    _close(BSR.bsr_spmm_plain(d, torch.from_numpy(X)), mine.numpy(), 2e-5)
    y = csr_spmv(t(csr.values), t(csr.col_idx), t(row_ids), t(X[:, 0]),
                 nrows=csr.nrows)
    yj = np.asarray(jax_csr_spmv(
        jnp.asarray(csr.values, jnp.float32), jnp.asarray(csr.col_idx),
        jnp.asarray(row_ids), jnp.asarray(X[:, 0], jnp.float32),
        nrows=csr.nrows))
    np.testing.assert_allclose(y.numpy(), ref[:, 0], rtol=1e-12, atol=1e-12)
    _close(yj, ref[:, 0], 2e-5)


def test_bf16_against_quantized_oracle():
    """bf16 blocks and X, f32 sums: the oracle of the bf16-rounded operands
    (blocks rounded from their f32 storage, as the upload rounds them)."""
    csr = CSRMatrix.from_coo(syn.fem_3d(5, 5, 5, dof=3, seed=7))
    bsr = BSRMatrix.from_csr(csr)
    X = np.random.default_rng(4).standard_normal((csr.ncols, 4))
    d = BSR.device_put_bsr(bsr, torch.bfloat16, device="cpu")
    assert d.blocks.dtype == torch.bfloat16
    got = BSR.bsr_spmm(d, BSR.pad_rhs(X, csr.ncols, torch.bfloat16,
                                      device="cpu"))[:, :4]
    q = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                  quantize_bf16(csr.values.astype(np.float32)))
    Xq = quantize_bf16(X)
    ref = np.column_stack([q.spmv(Xq[:, j]) for j in range(4)])
    _close(got, ref, 1e-5)
    assert np.abs(got.numpy() - np.column_stack(
        [csr.spmv(X[:, j]) for j in range(4)])).max() > 1e-4  # bf16 shows


def test_vector_rhs_and_jax_host_blocks():
    """A 1-D X gives a 1-D y; the JAX package's host BSRMatrix uploads and
    runs as the port's own does."""
    csr, jcsr, X = _banded_case()
    mine = BSR.device_put_bsr(BSRMatrix.from_csr(csr), device="cpu")
    theirs = BSR.device_put_bsr(JBSR.from_csr(jcsr), device="cpu")
    x = torch.from_numpy(X[:, 0])
    y = BSR.bsr_spmm(mine, x)
    assert tuple(y.shape) == (csr.nrows,)
    assert torch.equal(y, BSR.bsr_spmm(theirs, x))
    _close(y, csr.spmv(X[:, 0]), 2e-5)


def test_route_and_dtype_refused():
    csr, _, X = _banded_case()
    bsr = BSRMatrix.from_csr(csr)
    d = BSR.device_put_bsr(bsr, device="cpu")
    with pytest.raises(ValueError, match="unknown route 'mxu'"):
        BSR.bsr_spmm(d, torch.from_numpy(X), route="mxu")
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        BSR.device_put_bsr(bsr, torch.float64, device="cpu")
    with pytest.raises(ValueError, match="N <= 512"):
        BSR.bsr_spmm(d, torch.zeros(600, 2))


@pytest.mark.parametrize("route", sorted(BSR.ROUTES))
def test_wrapper_raises_off_cpu_and_cuda(route):
    csr, _, _ = _banded_case()
    d = BSR.device_put_bsr(BSRMatrix.from_csr(csr), device="meta")
    xp = torch.zeros(d.n_block_cols * 128, 8, device="meta")
    y = torch.zeros(d.n_block_rows * 128, 8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        BSR.ROUTES[route](d, xp, y)


def _np_masks(blocks):
    """The upload's tile masks counted in numpy: bit 8a + b of slot i is
    set iff its 16x16 sub-tile (a, b) holds a nonzero (uint64 bits read as
    int64)."""
    n = blocks.shape[0]
    live = (np.asarray(blocks).reshape(n, 8, 16, 8, 16) != 0).any((2, 4))
    bits = live.reshape(n, 64).astype(np.uint64) << np.arange(
        64, dtype=np.uint64)
    return bits.sum(1, dtype=np.uint64).view(np.int64)


def _corner_case(pkg_csr):
    """Block row 0: a nonzero only at (127, 127), the corner sub-tile (bit
    63, int64's sign), and one at (3, 200); block row 1: one block, so a
    pad slot beside it; block row 2 (rows 256-299): empty, two pad slots."""
    rows = np.array([3, 127, 130])
    row_ptr = np.zeros(301, np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    return pkg_csr(300, 300, np.cumsum(row_ptr),
                   np.array([200, 127, 255], np.int32),
                   np.array([1.5, -2.0, 3.0]))


@pytest.mark.parametrize("case", [*sorted(CASES), "corner"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_mask_counts_nonzero_subtiles(case, dtype):
    """``tile_mask`` from either package's host BSRMatrix equals a numpy
    count of the nonzero 16x16 sub-tiles; pad slots have mask 0."""
    if case == "corner":
        mine = BSRMatrix.from_csr(_corner_case(CSRMatrix))
        theirs = JBSR.from_csr(_corner_case(JCSR))
    else:
        make, kw = CASES[case]
        mine = BSRMatrix.from_csr(make(syn, CSRMatrix), **kw)
        theirs = JBSR.from_csr(make(jsyn, JCSR), **kw)
    want = _np_masks(mine.blocks)
    for host in (mine, theirs):
        d = BSR.device_put_bsr(host, getattr(torch, dtype), device="cpu")
        assert d.tile_mask.dtype == torch.int64
        assert d.tile_mask.shape == (d.n_block_rows * d.kb,)
        np.testing.assert_array_equal(d.tile_mask.numpy(), want)
    pad = ~np.abs(mine.blocks).any((1, 2))
    assert (want[pad] == 0).all() and (want[~pad] != 0).all()
    if case == "corner":
        assert mine.kb == 2 and pad.sum() == 3
        assert np.int64(-2**63) in want[:2]
        assert sorted(bin(int(v)).count("1") for v in want.view(np.uint64)) \
            == [0, 0, 0, 1, 1, 1]
