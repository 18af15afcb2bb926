"""The compacted k-major double-double bins, on the CPU.

A k-major dd bin whose rows run one lane each (``_k_major_lanes == 1``, a
function of its groups and K) is uploaded without its pad slots
(``ops/sell.py:_compact_km``): each group's rows sorted by their real
length, a row's real slots in k order, one plane per 32 sorted rows, (hi,
lo) value planes. The JAX test shapes are 2 groups, whose rows split over
lanes, so these tests reach the compacted path by setting
``ops.sell._KM_SPLIT_BELOW`` to 0 (every bin one lane a row).

Tolerances: against the JAX ``_kernel_k_major_dd`` in interpret mode
``1e-9 * max|y|`` on the fp64-combined result (the JAX dd tests' own,
tests/test_doubledouble.py:115-117), against the fp64 oracle norm-scaled
``1e-13``; the compacted plain version against the padded layout's
(``k_major_padded_plain_dd``) bit for bit: the compaction drops only slots
of value (0, 0), whose product (0, 0) leaves a normalised pair as it was.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix as JSell
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops import doubledouble as jdd
from sparsematrixvectormultiplication_tpu.ops.pallas_sell_dd import (
    device_put_sell_dd as jax_device_put_sell_dd,
    sell_spmv_pallas_dd,
)
from sparsematrixvectormultiplication_tpu_torch import CSRMatrix, SellMatrix
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
    combine_f64,
    dd_add_dd,
)
from test_torch_dd import _by_row_km, _kept_rows, _sl_rows

JAX_REL = 1e-9      # port vs JAX interpret, times max|y|
ORACLE_REL = 1e-13  # port vs the fp64 oracle, times max|y_ref|


@pytest.fixture
def one_lane(monkeypatch):
    """Every k-major bin runs one lane a row, so its dd upload compacts."""
    monkeypatch.setattr(S, "_KM_SPLIT_BELOW", 0)


def _jax_sell():
    sell = JSell.from_csr(JCSR.from_coo(jsyn.banded(2048, 12, 200, seed=1)),
                          layout="k-major")
    assert [b.layout for b in sell.bins] == ["k-major"]
    return sell


def test_upload_keeps_the_jax_splits_real_slots(one_lane):
    """The compacted planes, row by row, hold the real slots of the JAX
    upload's hi and lo planes and its columns, in k order."""
    sell = _jax_sell()
    (h,) = sell.bins
    (jb,) = jax_device_put_sell_dd(sell).bins
    (b,) = D.device_put_sell_dd(sell, device="cpu").bins
    assert S._k_major_lanes(b) == 1 and D._km_compacts(b)
    assert b.row_table is not None and b.as_pair is None
    n = np.asarray(h.as_).shape[0]
    jhi, jlo = np.asarray(jb.as_hi)[:n], np.asarray(jb.as_lo)[:n]
    keep = (jhi != 0) | (jlo != 0)
    for got, want in ((b.as_hi, jhi), (b.as_lo, jlo),
                      (b.ja, np.asarray(jb.ja)[:n])):
        assert np.array_equal(_sl_rows(b, got),
                              _kept_rows(h, want, keep, _by_row_km))
    # one plane per 32 sorted rows, as wide as the longest of them; each
    # 128-row block's rows sorted by length, longest first, within the block
    assert b.ja.numel() < np.size(h.ja) and b.ja.shape[1] == 32
    t = b.row_table.numpy()
    assert np.array_equal((t & 1023) // 128, np.arange(t.size) % 1024 // 128)
    assert (np.diff((t >> 10).reshape(-1, 128), axis=1) <= 0).all()
    assert int(keep.sum()) == int((b.row_table >> 10).sum())


def test_spmv_matches_pallas_interpret(one_lane):
    """The port's dd SpMV over the compacted bin against the JAX k-major dd
    kernel in interpret mode on the padded bin, and the fp64 oracle."""
    sell = _jax_sell()
    x = np.random.default_rng(7).standard_normal(sell.ncols)
    xh, xl = jdd.split_f64(x)
    y_jax = np.asarray(jdd.combine_f64(*sell_spmv_pallas_dd(
        jax_device_put_sell_dd(sell), jnp.asarray(xh), jnp.asarray(xl),
        interpret=True)))[: sell.nrows]
    d = D.device_put_sell_dd(sell, device="cpu")
    assert all(b.row_table is not None for b in d.bins)
    # a launch a joint bin, no zero fill of y (the bins write every group)
    # and no interleaved x table
    assert D.sell_spmv_dd_launches(d) == len(d.plan.launches) == 1
    y = combine_f64(*D.sell_spmv_dd(
        d, *D.device_put_x_dd(x, sell.ncols, device="cpu"))).numpy()
    assert np.abs(y - y_jax).max() <= JAX_REL * np.abs(y_jax).max()
    y_ref = JCSR.from_coo(jsyn.banded(2048, 12, 200, seed=1)).spmv(x)
    assert np.abs(y - y_ref).max() < ORACLE_REL * np.abs(y_ref).max()


def _edge_case_bin():
    """banded(2048, 12, 200) with one entry stored as zero and one row
    emptied, as a k-major host SELL whose empty row's pad slots all name
    the spare x entry past the last column; returns the SELL, the CSR, the
    stored zero's (row, column) and the empty row."""
    csr = CSRMatrix.from_coo(syn.banded(2048, 12, 200, seed=1))
    empty, zero_row = 700, 1500
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
    vals = csr.values.copy()
    zero_at = int(csr.row_ptr[zero_row]) + 3
    vals[zero_at] = 0.0
    zero_col = int(csr.col_idx[zero_at])
    live = rows != empty
    row_ptr = np.zeros(csr.nrows + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(rows[live], minlength=csr.nrows))
    csr = type(csr)(csr.nrows, csr.ncols, row_ptr, csr.col_idx[live],
                    vals[live])
    sell = SellMatrix.from_csr(csr, layout="k-major")
    (h,) = sell.bins
    gi = int(np.flatnonzero(np.asarray(h.group_ids) == empty // 1024)[0])
    i, j = empty % 1024 // 128, empty % 128
    k = np.arange(h.k)
    assert not np.asarray(h.as_)[(gi * h.k + k) * 8 + i, j].any()
    h.ja[(gi * h.k + k) * 8 + i, j] = csr.ncols
    return sell, csr, (zero_row, zero_col), empty


@pytest.mark.parametrize("accumulate", [False, True])
def test_compacted_plain_equals_the_padded_plain(accumulate, one_lane):
    """A bin with a stored zero, an empty row and x = inf at its pads'
    column: the compacted bin through its wrapper (the plain version on the
    CPU), storing or dd-adding onto a y pair that holds values, equals the
    padded layout's ``k_major_padded_plain_dd`` bit for bit, every row
    finite."""
    sell, csr, _, empty = _edge_case_bin()
    (h,) = sell.bins
    d = D.device_put_sell_dd(sell, device="cpu")
    (b,) = d.bins
    # the stored zero and the pads are dropped; the empty row keeps none
    assert int((b.row_table >> 10).sum()) == csr.nnz - 1
    rank = (b.row_table & 1023).numpy()
    assert int(b.row_table[empty // 1024 * 1024 + np.flatnonzero(
        rank[empty // 1024 * 1024:][:1024] == empty % 1024)[0]] >> 10) == 0
    xh, xl = D.device_put_x_dd(
        np.random.default_rng(3).standard_normal(csr.ncols), csr.ncols,
        device="cpu")
    xh[csr.ncols] = torch.inf
    n = d.num_groups * 1024
    y0h = torch.from_numpy(np.random.default_rng(5).standard_normal(
        n).astype(np.float32))
    y0l = y0h * 2.0**-30
    yh, yl = y0h.clone(), y0l.clone()
    D.k_major_bin_dd(b, xh, xl, yh, yl, accumulate=accumulate)
    want = D.k_major_padded_plain_dd(h, xh, xl)
    rows = b.group_ids.long()
    if accumulate:
        want = dd_add_dd(y0h.view(-1, 8, 128)[rows],
                         y0l.view(-1, 8, 128)[rows], *want)
    for got, exp in zip((yh, yl), want):
        got = got.view(-1, 8, 128)[rows]
        assert torch.isfinite(got).all()
        assert torch.equal(got, exp)
    assert torch.equal(D.k_major_bin_plain_dd(b, xh, xl)[0],
                       D.k_major_padded_plain_dd(h, xh, xl)[0])


def test_padded_plain_skips_a_stored_zero_at_an_infinite_x():
    """The padded plain version follows the kernels' stored-zero rule: a
    stored zero whose column holds x = inf adds nothing."""
    sell, csr, (zero_row, col), _ = _edge_case_bin()
    (h,) = sell.bins
    xh, xl = D.device_put_x_dd(np.ones(csr.ncols), csr.ncols, device="cpu")
    xh[csr.ncols] = torch.inf
    base = combine_f64(*D.k_major_padded_plain_dd(h, xh, xl))
    assert torch.isfinite(base).all()
    # x = inf at the stored zero's column as well: only the rows with an
    # entry that is not zero there stop being finite; the stored zero's row
    # stays as it was
    xh[col] = torch.inf
    hot = combine_f64(*D.k_major_padded_plain_dd(h, xh, xl)).view(-1)
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
    lit = np.zeros(hot.numel(), bool)
    lit[rows[(csr.col_idx == col) & (csr.values != 0)]] = True
    lit = torch.from_numpy(lit)
    assert not lit[zero_row] and lit.any()
    assert torch.equal(hot[~lit], base.view(-1)[~lit])
    assert not torch.isfinite(hot[lit]).any()


# (groups, K): whether the dd upload compacts the bin
SHAPES = {(245, 64): True,   # band64_250k's bin
          (49, 47): True,    # the demo's banded(50_000, 24, 500)
          (33, 64): True, (32, 64): False, (16, 16): False, (1, 96): False,
          (1, 4): True}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_compaction_follows_the_lanes(shape):
    """A k-major bin is compacted in dd exactly when its rows run one lane
    each, a function of its groups and K."""
    ng, k = shape
    b = SimpleNamespace(layout="k-major", n_groups=ng, k=k)
    assert D._km_compacts(b) == SHAPES[shape] == (S._k_major_lanes(b) == 1)


def test_lane_split_bins_stay_padded():
    """Bins whose rows split over lanes keep their hi and lo planes and no
    row table, and the f32 upload never compacts a k-major bin."""
    sell = _jax_sell()
    (b,) = D.device_put_sell_dd(sell, device="cpu").bins
    assert S._k_major_lanes(b) > 1
    assert b.as_pair is None and b.row_table is None
    assert b.as_hi.shape == np.asarray(sell.bins[0].as_).shape
    csr = CSRMatrix.from_coo(syn.banded(40 * 1024, 12, 200, seed=1))
    (f,) = S.device_put_sell(SellMatrix.from_csr(csr, layout="k-major"),
                             device="cpu").bins
    assert S._k_major_lanes(f) == 1 and f.row_table is None


def test_f32_decode_of_a_compacted_bin(one_lane):
    """The f32 slot decode and plain version read a compacted bin's index
    as the row-list layout's (the smoke counts a dd bin's real entries
    through them)."""
    sell = _jax_sell()
    (b,) = D.device_put_sell_dd(sell, device="cpu").bins
    index = {f.name: getattr(b, f.name)
             for f in dataclasses.fields(S.DeviceBinIndex)}
    ones = (b.as_hi != 0).float()
    f = S.DeviceSellBin(**index, as_=ones)
    shape, cols, keep, _ = S._SLOTS["k-major"](f)
    real = (ones.view(shape) != 0) & keep
    assert int(real.sum()) == int((np.asarray(sell.bins[0].as_) != 0).sum())
    x = torch.ones(int(cols.max()) + 1)
    row_nnz = np.diff(JCSR.from_coo(jsyn.banded(2048, 12, 200, seed=1))
                      .row_ptr)
    got = S.k_major_bin_plain(f, x).view(-1)[: sell.nrows]
    assert np.array_equal(got.numpy(), row_nnz.astype(np.float32))


# what is broken -> the compacted bin's fields it replaces
BROKEN = {
    "no plane offsets": lambda b: {"plane_off": None},
    "short row table": lambda b: {"row_table": b.row_table[:-1]},
    "plane offsets of another bin": lambda b: {"plane_off": b.plane_off[:-2]},
    "int64 row table": lambda b: {"row_table": b.row_table.long()},
    "short lo plane": lambda b: {"as_lo": b.as_lo[:-1]},
    "ragged planes": lambda b: {
        f: getattr(b, f).view(-1)[:-1].contiguous()
        for f in ("ja", "as_hi", "as_lo")},
}


@pytest.mark.parametrize("broken", sorted(BROKEN))
def test_check_bin_refuses_a_broken_compacted_bin(broken, one_lane):
    """``_check_bin`` takes the compacted bin as a row-list layout and
    refuses it when a table or plane does not match."""
    (b,) = D.device_put_sell_dd(_jax_sell(), device="cpu").bins

    def check(bin_):
        S._check_bin(bin_, {"as_hi": bin_.as_hi, "as_lo": bin_.as_lo},
                     torch.device("cpu"), (torch.float32,))

    check(b)
    with pytest.raises(ValueError):
        check(dataclasses.replace(b, **BROKEN[broken](b)))


def test_a_device_launch_needs_the_layout_of_the_lanes(monkeypatch):
    """Off the CPU the dd wrapper raises, before any launch, on a k-major
    bin whose layout is not the one its lanes give: a padded bin of one
    lane a row, or a compacted bin whose rows would split."""
    sell = _jax_sell()
    xh, xl = D.device_put_x_dd(np.ones(sell.ncols), sell.ncols, device="meta")
    yh, yl = (torch.zeros(sell.num_groups * 1024, device="meta")
              for _ in range(2))
    (split,) = D.device_put_sell_dd(sell, device="meta").bins
    monkeypatch.setattr(S, "_KM_SPLIT_BELOW", 0)
    (compact,) = D.device_put_sell_dd(sell, device="meta").bins
    before = D.k_major_bin_dd.launches
    with pytest.raises(ValueError, match="compacted"):
        D.k_major_bin_dd(split, xh, xl, yh, yl)  # now one lane a row
    monkeypatch.undo()
    with pytest.raises(ValueError, match="compacted"):
        D.k_major_bin_dd(compact, xh, xl, yh, yl)
    assert D.k_major_bin_dd.launches == before
