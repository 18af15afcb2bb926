"""The port's locality split and ``auto`` on the CPU, against the JAX package.

* Host layer: ``split_stats``, ``split_csr`` and ``SplitMatrix`` give the JAX
  package's arrays (np.array_equal) on tests/test_split.py's shapes, and
  ``choose_format`` its kinds and stats on tests/test_auto.py's builders.
* SpMV: ``split_spmv_plain`` / ``split_spmv_dd_plain`` against
  ``split_spmv_pallas`` / ``split_spmv_pallas_dd`` in interpret mode on the
  same host product (tests/test_split.py:168-230 shapes), at the JAX tests'
  tolerances: f32 ``max|Δ| / max(1, |ref|) < 1e-5``, dd ``< 1e-11``.
* ``run_matrix``'s split stages and ``auto_device_op`` end to end.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_formats import _assert_same as _same

from sparsematrixvectormultiplication_tpu.formats import split as jsplit
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.ops.auto import (
    choose_format as jax_choose_format,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    device_put_x as jax_device_put_x,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_split import (
    device_put_split as jax_device_put_split,
    device_put_split_dd as jax_device_put_split_dd,
    split_spmv_pallas,
    split_spmv_pallas_dd,
)
from sparsematrixvectormultiplication_tpu_torch import (
    auto_device_op,
    choose_format,
    run_matrix,
)
from sparsematrixvectormultiplication_tpu_torch.bench.harness import BenchConfig
from sparsematrixvectormultiplication_tpu_torch.formats import split as psplit
from sparsematrixvectormultiplication_tpu_torch.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import split as SP
from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
    combine_f64,
)
from sparsematrixvectormultiplication_tpu_torch.ops.sell import device_put_x
from sparsematrixvectormultiplication_tpu_torch.ops.sell_dd import (
    device_put_x_dd,
)

F32_REL = 1e-5   # tests/test_split.py:186
DD_REL = 1e-11   # tests/test_split.py:234


def _band_plus_tail(n=3000, nnz_per_row=4, bandwidth=60, far_frac=0.05,
                    seed=0):
    """Banded matrix with a scattered far tail (tests/test_split.py:20-34)."""
    rng = np.random.default_rng(seed)
    coo = syn.banded(n, nnz_per_row, bandwidth, seed=seed)
    n_far = int(coo.row.size * far_frac)
    return CSRMatrix.from_coo(COOMatrix(
        n, n,
        np.concatenate([coo.row, rng.integers(0, n, n_far).astype(np.int32)]),
        np.concatenate([coo.col, rng.integers(0, n, n_far).astype(np.int32)]),
        np.concatenate([coo.val, rng.standard_normal(n_far)])))


def _multi_far():
    """50 rows with four far entries each (tests/test_split.py:83-99)."""
    n = 1500
    rng = np.random.default_rng(11)
    coo = syn.banded(n, 3, 40, seed=11)
    fr = np.repeat(rng.choice(n, 50, replace=False), 4).astype(np.int32)
    fc = rng.integers(0, n, fr.size).astype(np.int32)
    return CSRMatrix.from_coo(COOMatrix(
        n, n, np.concatenate([coo.row, fr]), np.concatenate([coo.col, fc]),
        np.concatenate([coo.val, rng.standard_normal(fr.size)])))


# name -> (CSR builder, SplitMatrix.from_csr keywords)
SHAPES = {
    "band_tail": (lambda: _band_plus_tail(), {}),
    "band_tail_seed3": (lambda: _band_plus_tail(seed=3), {}),
    "multi_far": (_multi_far, {"slab_dist": 1}),
    "far_panels": (lambda: _band_plus_tail(n=6000, seed=17),
                   {"far_target_rows": 32}),
    "band_tail_6000": (lambda: _band_plus_tail(n=6000, seed=9), {}),
    "band_tail_6000_dd": (lambda: _band_plus_tail(n=6000, seed=13), {}),
    "road": (lambda: CSRMatrix.from_coo(syn.road_network(6000, seed=1)), {}),
}


@functools.cache
def _csrs(name):
    csr = SHAPES[name][0]()
    return csr, JCSR(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                     csr.values)


@functools.cache
def _splits(name):
    csr, jcsr = _csrs(name)
    kw = SHAPES[name][1]
    return (psplit.SplitMatrix.from_csr(csr, **kw),
            jsplit.SplitMatrix.from_csr(jcsr, **kw))


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _rel(y, ref):
    return float((np.abs(y - ref) / np.maximum(1.0, np.abs(ref))).max())


# ---- host layer ----


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_split_matrix_matches_jax(name):
    mine, theirs = _splits(name)
    _same(mine, theirs)
    assert mine.far.row_perm.size == mine.nrows
    assert np.array_equal(mine.far.row_perm, np.arange(mine.nrows))


@pytest.mark.parametrize("name", ["band_tail", "multi_far", "road"])
def test_split_csr_and_stats_match_jax(name):
    csr, jcsr = _csrs(name)
    for d in (1, 4, 32):
        _same(psplit.split_stats(csr, d), jsplit.split_stats(jcsr, d))
    mine = psplit.split_csr(csr, slab_dist=1, max_far_frac=1.0)
    theirs = jsplit.split_csr(jcsr, slab_dist=1, max_far_frac=1.0)
    for a, b in zip(mine[:2], theirs[:2]):
        _same((a.row_ptr, a.col_idx, a.values), (b.row_ptr, b.col_idx,
                                                  b.values))
    assert mine[2:] == theirs[2:]


def test_split_refusals_match_jax():
    for make in (lambda: CSRMatrix.from_coo(syn.random_general(
            1500, 1500, 0.004, seed=2)),
                 lambda: CSRMatrix.from_coo(syn.banded(2000, 5, 30, seed=7))):
        csr = make()
        with pytest.raises(ValueError) as mine:
            psplit.SplitMatrix.from_csr(csr)
        with pytest.raises(ValueError) as theirs:
            jsplit.SplitMatrix.from_csr(JCSR(csr.nrows, csr.ncols,
                                             csr.row_ptr, csr.col_idx,
                                             csr.values))
        assert str(mine.value) == str(theirs.value)


# tests/test_auto.py's builders -> the kind both packages must pick
AUTO = {
    "banded": (lambda: CSRMatrix.from_coo(syn.banded(4000, 9, 60, seed=1)),
               "sell"),
    "banded_small": (lambda: CSRMatrix.from_coo(syn.banded(3000, 9, 60,
                                                           seed=3)), "sell"),
    "band_tail": (lambda: _band_plus_tail(n=6000, nnz_per_row=4,
                                          far_frac=0.05, seed=0), "split"),
    "uniform": (lambda: CSRMatrix.from_coo(syn.random_general(
        40000, 40000, 0.0002, seed=2)), "pr"),
}


@pytest.mark.parametrize("name", sorted(AUTO))
def test_choose_format_matches_jax(name):
    make, kind = AUTO[name]
    csr = make()
    got = choose_format(csr)
    assert got[0] == kind, got
    _same(got, jax_choose_format(JCSR(csr.nrows, csr.ncols, csr.row_ptr,
                                      csr.col_idx, csr.values)))


# ---- SpMV against the JAX composite in interpret mode ----


@pytest.mark.parametrize("name", ["band_tail_6000", "road"])
def test_split_spmv_plain_matches_jax_interpret(name):
    mine, theirs = _splits(name)
    csr = _csrs(name)[0]
    x = _x(csr.ncols, 4)
    y_jax = np.asarray(split_spmv_pallas(
        jax_device_put_split(theirs, dtype=jnp.float32),
        jax_device_put_x(x, csr.ncols), interpret=True), np.float64)
    xt = device_put_x(x, csr.ncols, device="cpu")
    d = SP.device_put_split(mine, device="cpu")
    y = SP.split_spmv_plain(d, xt).numpy().astype(np.float64)
    assert _rel(y, y_jax) < F32_REL
    assert _rel(y, csr.spmv(x)) < F32_REL
    assert torch.equal(SP.split_spmv(d, xt), torch.from_numpy(
        y.astype(np.float32)))


def test_split_spmv_dd_plain_matches_jax_interpret():
    mine, theirs = _splits("band_tail_6000_dd")
    csr = _csrs("band_tail_6000_dd")[0]
    x = _x(csr.ncols, 8)
    xh = np.asarray(x, np.float32)
    xl = np.asarray(x - xh.astype(np.float64), np.float32)
    yh, yl = split_spmv_pallas_dd(
        jax_device_put_split_dd(theirs), jax_device_put_x(xh, csr.ncols),
        jax_device_put_x(xl, csr.ncols), interpret=True)
    y_jax = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    d = SP.device_put_split_dd(mine, device="cpu")
    y = combine_f64(*SP.split_spmv_dd_plain(
        d, *device_put_x_dd(x, csr.ncols, device="cpu"))).numpy()
    ref = csr.spmv(x)
    assert _rel(y, y_jax) < DD_REL
    assert _rel(y, ref) < DD_REL
    assert np.abs(y - ref).max() < 1e-13 * np.abs(ref).max()


def test_split_with_paneled_far_side():
    """A far side of several problems: the f32 and dd uploads take it (the
    JAX dd guard is a TPU VMEM bound the port does not carry)."""
    mine, _ = _splits("far_panels")
    assert len(mine.far.panels) >= 2
    csr = _csrs("far_panels")[0]
    x = _x(csr.ncols, 5)
    y32 = SP.split_spmv(SP.device_put_split(mine, device="cpu"),
                        device_put_x(x, csr.ncols, device="cpu")).numpy()
    assert _rel(y32.astype(np.float64), csr.spmv(x)) < F32_REL
    y = combine_f64(*SP.split_spmv_dd(
        SP.device_put_split_dd(mine, device="cpu"),
        *device_put_x_dd(x, csr.ncols, device="cpu"))).numpy()
    ref = csr.spmv(x)
    assert np.abs(y - ref).max() < 1e-13 * np.abs(ref).max()


def test_split_upload_refuses_a_sigma_sorted_near_side():
    mine, _ = _splits("band_tail")
    near = psplit.SellMatrix.from_csr(_csrs("band_tail")[0], sigma_sort=True)
    with pytest.raises(ValueError, match="natural row order"):
        SP.device_put_split(dataclasses.replace(mine, near=near),
                            device="cpu")


# ---- run_matrix and auto end to end ----


def test_run_matrix_split_stages_on_cpu():
    coo = syn.road_network(20_000, seed=1)
    res = run_matrix("road", coo, BenchConfig(iterations=1, skip=0,
                                              stages=("split", "split_dd")),
                     x=_x(coo.ncols, 6), log=lambda m: None, device="cpu")
    assert tuple(res.stages) == ("serial_csr", "split", "split_dd")
    assert res.split.slab_dist == 1 and res.skipped == {}
    assert {b.layout for b in res.split.near.bins} == {"k-major"}
    for stage in ("split", "split_dd"):
        assert res.stages[stage].diff.significant_diffs == 0, stage
    assert res.stages["split_dd"].norm_err < 1e-13


def test_run_matrix_records_a_skipped_split():
    logs = []
    res = run_matrix("banded", syn.banded(2000, 5, 30, seed=7),
                     BenchConfig(iterations=1, skip=0,
                                 stages=("sell", "split", "split_dd")),
                     log=logs.append, device="cpu")
    assert tuple(res.stages) == ("serial_csr", "sell")
    assert set(res.skipped) == {"split", "split_dd"}
    assert "no profitable near threshold" in res.skipped["split"]
    assert any("split skipped" in m for m in logs)


@pytest.mark.parametrize("name", sorted(AUTO))
def test_auto_device_op_validates(name):
    make, kind = AUTO[name]
    csr = make()
    op = auto_device_op(csr, device="cpu")
    assert op.kind == kind
    x = _x(csr.ncols, 5)
    ref = csr.spmv(x)
    assert _rel(op.matvec(x), ref) < 1e-5
    if kind == "pr":
        assert op.row_perm is not None


def test_auto_device_op_heavy_rows_reduce_on_the_host():
    """A row too long for one PR problem goes through the strided heavy-row
    split, and matvec reduces the segments with an fp64 bincount
    (tests/test_auto.py:67-91, cut to 2 dense rows)."""
    rng = np.random.default_rng(7)
    n = 30000
    coo = syn.random_general(n, n, 0.0002, seed=7)
    fr = np.repeat(rng.choice(n, 2, replace=False), 12000).astype(np.int32)
    fc = rng.integers(0, n, fr.size).astype(np.int32)
    csr = CSRMatrix.from_coo(COOMatrix(
        n, n, np.concatenate([coo.row, fr]), np.concatenate([coo.col, fc]),
        np.concatenate([coo.val, rng.standard_normal(fr.size)]))
        .sum_duplicates())
    op = auto_device_op(csr, device="cpu")
    assert op.kind == "pr" and op.seg_ids is not None
    x = rng.standard_normal(n)
    assert _rel(op.matvec(x), csr.spmv(x)) < 1e-5
