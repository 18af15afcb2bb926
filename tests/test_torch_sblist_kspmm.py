"""The compacted sb-list upload and the k-major SpMM's sums and window table,
on the CPU.

The sb-list upload of a bin with int32 planes sorts each 1024-row group's
rows by their real length (longest first, ties in row order), keeps each
row's real slots in entry order and gives each 32 sorted rows a plane as wide
as the longest of them; a row table says where each sorted row's y goes. Its
plain versions add each row's slots in entry order with the kernel's rounding
(one fmaf a slot: ``fma_f32``; dd: ``dd_add_dd`` of ``dd_mul_dd``), so they
must equal the padded layout's function (``sb_list_padded_plain``: every
slot, pads included) bit for bit on finite x: a pad only added an exact zero.
The padded int16 planes' plain versions skip the pads in the same order, so
they equal it too. Against the JAX package's ``_kernel_sb_list`` and
``_kernel_sb_list_dd`` in interpret mode the tolerances are the JAX tests'
own: rtol=1e-5, atol=1e-5*max|y| in f32, 1e-9*max|y| in dd (and 1e-13 of
the fp64 oracle).

The k-major SpMM plain version adds each row's entries in k order with one
fmaf a column, so column j equals the k-major SpMV plain version on X[:, j]
bit for bit; its window table (first column and span of each (group,
row-block)'s slots) must equal a numpy count of the host planes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix as JSell
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops import doubledouble as jdd
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    device_put_sell as jax_device_put_sell,
    sell_spmv_pallas,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_sell_dd import (
    device_put_sell_dd as jax_device_put_sell_dd,
    sell_spmv_pallas_dd,
)
from sparsematrixvectormultiplication_tpu_torch import (
    CSRMatrix,
    PanelSellMatrix,
    SellMatrix,
)
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
from sparsematrixvectormultiplication_tpu_torch.ops import sell_spmm as SM
from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
    combine_f64,
    dd_add_dd,
)

# matrix -> generator; each is converted with layout="sb-list"
SB = {"road": lambda m: m.road_network(20_000, seed=5),
      "banded": lambda m: m.banded(4096, 18, 40, seed=2)}
PRECISIONS = ("f32", "bf16", "dd")


def _sell(matrix):
    csr = CSRMatrix.from_coo(SB[matrix](syn))
    sell = SellMatrix.from_csr(csr, layout="sb-list")
    assert {b.layout for b in sell.bins} == {"sb-list"}
    return csr, sell


def _x(n, seed=5):
    return np.random.default_rng(seed).standard_normal(n)


def _upload(sell, precision, x, ncols, sb_i16=False):
    if precision == "dd":
        return (D.device_put_sell_dd(sell, device="cpu", sb_i16=sb_i16),
                D.device_put_x_dd(x, ncols, device="cpu"))
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return (S.device_put_sell(sell, dtype, device="cpu", sb_i16=sb_i16),
            (S.device_put_x(x, ncols, device="cpu"),))


def _plain(b, precision, x):
    if precision == "dd":
        return D.sb_list_bin_plain_dd(b, *x)
    return (S.sb_list_bin_plain(b, *x),)


def _padded(h, precision, x):
    if precision == "dd":
        return D.sb_list_padded_plain_dd(h, *x)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return (S.sb_list_padded_plain(h, x[0], dtype),)


def _by_row(h, plane):
    """A host sb plane as (rows, k): each row's entries in order."""
    return np.asarray(plane).reshape(h.n_groups, 8, h.k, 128).transpose(
        0, 1, 3, 2).reshape(h.n_groups * 1024, h.k)


def _sl_rows(b, plane):
    """A compacted sb-list plane as (rows, k) in row order, each row's slots
    in order, 0 past its length."""
    t = b.row_table.numpy()
    s = np.arange(b.n_groups * 1024)
    pos = (b.plane_off.numpy()[s // 32].astype(np.int64)[:, None] * 32
           + (s % 32)[:, None] + np.arange(b.k)[None, :] * 32)
    live = np.arange(b.k)[None, :] < (t >> 10)[:, None]
    flat = plane.reshape(-1).numpy()
    out = np.empty((s.size, b.k), flat.dtype)
    out[s // 1024 * 1024 + (t & 1023)] = np.where(
        live, flat[np.where(live, pos, 0)], 0)
    return out


# ---- the compacted sb-list upload ----


@pytest.mark.parametrize("planes", ["i32", "i16"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("matrix", sorted(SB))
def test_sb_list_plain_equals_padded_plain(matrix, precision, planes):
    """The compacted bins (int32) and the padded int16 ones, whose plain
    versions skip the pads: both return the padded layout's result."""
    csr, sell = _sell(matrix)
    d, x = _upload(sell, precision, _x(csr.ncols), csr.ncols,
                   sb_i16=planes == "i16")
    for h, b in zip(sell.bins, d.bins):
        if planes == "i32":
            assert b.row_table is not None
            assert b.ja.dtype == torch.int32 and b.ja.shape[1] == 32
            assert b.ja.numel() < np.asarray(h.ja).size
        else:
            assert b.row_table is None and b.ja.dtype == torch.int16
        for got, want in zip(_plain(b, precision, x),
                             _padded(h, precision, x)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_compacted_sb_list_accumulates_on_panels(precision):
    """Column panels of road forced to sb-list: every bin adds onto y what
    the padded layout adds, bit for bit; the whole panel SpMV holds the
    oracle."""
    csr = CSRMatrix.from_coo(syn.road_network(20_000, seed=5))
    psell = PanelSellMatrix.from_csr(csr, max_panel_cols=8192,
                                     layout="sb-list")
    assert len(psell.panels) >= 3
    x = _x(csr.ncols, seed=3)
    seen = 0
    for p, panel in enumerate(psell.panels):
        c0, c1 = psell.bounds[p], psell.bounds[p + 1]
        d, xs = _upload(panel, precision, x[c0:c1], c1 - c0)
        y0 = [torch.randn(d.num_groups * 1024) for _ in xs]
        if precision == "dd":
            y0[1] = y0[0] * 2.0**-30
        for h, b in zip(panel.bins, d.bins):
            assert b.row_table is not None
            seen += 1
            y = [t.clone() for t in y0]
            kernel = D.sb_list_bin_dd if precision == "dd" else S.sb_list_bin
            kernel(b, *xs, *y, accumulate=True)
            rows = b.group_ids.long()
            base = [t.view(-1, 8, 128)[rows] for t in y0]
            add = _padded(h, precision, xs)
            want = dd_add_dd(*base, *add) if precision == "dd" \
                else (base[0] + add[0],)
            for got, w in zip(y, want):
                assert torch.equal(got.view(-1, 8, 128)[rows], w)
    assert seen
    if precision == "dd":
        y = D.sell_spmv_dd_f64(D.device_put_sell_dd(psell, device="cpu"),
                               torch.from_numpy(x)).numpy()
        ref, tol = csr.spmv(x), 1e-13
    else:
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        y = S.panel_sell_spmv(S.device_put_sell(psell, dtype, device="cpu"),
                              torch.from_numpy(x).float()).double().numpy()
        vals = csr.values if precision == "f32" else torch.from_numpy(
            csr.values).to(torch.bfloat16).double().numpy()
        ref = type(csr)(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                        vals).spmv(x.astype(np.float32).astype(np.float64))
        tol = 1e-5
    assert np.abs(y - ref).max() < tol * np.abs(ref).max()


def _jax_sb_list(matrix):
    """The JAX host SELL of ``matrix`` forced to sb-list, at sizes where
    interpret mode takes seconds (road split as tests/test_sg.py splits
    it, the band of the JAX dd tests)."""
    if matrix == "road":
        csr = JCSR.from_coo(jsyn.road_network(3000, seed=5)).split_heavy_rows(
            256)[0]
    else:
        csr = JCSR.from_coo(jsyn.banded(2048, 12, 200, seed=0))
    sell = JSell.from_csr(csr, layout="sb-list")
    assert {b.layout for b in sell.bins} == {"sb-list"}
    return csr, sell


@pytest.mark.parametrize("matrix", ["road", "banded"])
def test_compacted_sb_list_matches_pallas_interpret(matrix, monkeypatch):
    """The port's compacted upload against the JAX ``_kernel_sb_list`` in
    interpret mode on the same host SELL (int32 planes)."""
    _, sell = _jax_sb_list(matrix)
    x = _x(sell.ncols, seed=11).astype(np.float32)
    monkeypatch.setenv("SPMV_SB_I16", "0")
    want = np.asarray(sell_spmv_pallas(jax_device_put_sell(sell, jnp.float32),
                                       jnp.asarray(x), interpret=True))
    d = S.device_put_sell(sell, device="cpu")
    assert all(b.row_table is not None for b in d.bins)
    got = S.sell_spmv(d, S.device_put_x(x, sell.ncols, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("matrix", ["road", "banded"])
def test_compacted_sb_list_dd_matches_pallas_interpret(matrix, monkeypatch):
    """The dd twin against ``_kernel_sb_list_dd`` in interpret mode, and
    against the fp64 oracle."""
    csr, sell = _jax_sb_list(matrix)
    x = _x(sell.ncols, seed=7)
    xh, xl = jdd.split_f64(x)
    monkeypatch.setenv("SPMV_SB_I16", "0")
    want = np.asarray(jdd.combine_f64(*sell_spmv_pallas_dd(
        jax_device_put_sell_dd(sell), jnp.asarray(xh), jnp.asarray(xl),
        interpret=True)))
    d = D.device_put_sell_dd(sell, device="cpu")
    assert all(b.as_pair is not None for b in d.bins)
    th, tl = D.device_put_x_dd(x, sell.ncols, device="cpu")
    y = combine_f64(*D.sell_spmv_dd(d, th, tl)).numpy()
    assert np.abs(y - want).max() <= 1e-9 * np.abs(want).max()
    ref = csr.spmv(x)
    assert np.abs(y - ref).max() < 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize("matrix", sorted(SB))
def test_sorted_warp_widths_and_row_table(matrix):
    """The compacted slots equal a numpy count: each group's rows sorted by
    their real length, longest first and stable, each 32 of them a plane as
    wide as the longest; the row table is a permutation of each group's
    rows; the real slots are the host bin's entries, columns in order."""
    csr, sell = _sell(matrix)
    d = S.device_put_sell(sell, device="cpu")
    for h, b in zip(sell.bins, d.bins):
        keep = _by_row(h, h.as_) != 0
        length = keep.sum(1).reshape(h.n_groups, 1024)
        order = np.argsort(-length, axis=1, kind="stable")
        lens = np.take_along_axis(length, order, 1)
        widths = lens.reshape(-1, 32).max(1)
        assert b.ja.numel() == 32 * int(widths.sum())
        assert np.array_equal(np.diff(b.plane_off.numpy()), widths)
        t = b.row_table.numpy().reshape(h.n_groups, 1024)
        assert np.array_equal(t & 1023, order)
        assert np.array_equal(t >> 10, lens)
        assert all(np.array_equal(np.sort(r), np.arange(1024))
                   for r in t & 1023)
        shape, cols, real, _ = S._SLOTS["sb-list"](b)
        assert int(real.sum()) == int(keep.sum()) == h.real_nnz
        want = np.take_along_axis(_by_row(h, h.ja), np.argsort(
            ~keep, axis=1, kind="stable"), 1)
        live = np.arange(h.k)[None, :] < keep.sum(1)[:, None]
        assert np.array_equal(_sl_rows(b, b.ja)[live], want[live])


@pytest.mark.parametrize("precision", ["f32", "dd"])
def test_sb_list_stored_zero_is_dropped(precision):
    """A stored explicit zero is dropped with the pads: one slot fewer, and
    y unchanged bit for bit on finite x. Where x is infinite at its column
    the padded layout's 0 * inf made NaN; the compacted one does not."""
    csr, sell = _sell("banded")
    (h,) = sell.bins
    v = np.array(h.as_)
    i = np.flatnonzero(v.reshape(-1))[321]
    v.reshape(-1)[i] = 0.0
    h0 = dataclasses.replace(h, as_=v)
    sell0 = dataclasses.replace(sell, bins=[h0])
    x = _x(csr.ncols)
    (b,), xs = (lambda r: (r[0].bins, r[1]))(
        _upload(sell, precision, x, csr.ncols))
    (b0,), _ = (lambda r: (r[0].bins, r[1]))(
        _upload(sell0, precision, x, csr.ncols))
    assert int((b0.row_table >> 10).sum()) == int((b.row_table >> 10).sum()) - 1
    for got, want in zip(_plain(b0, precision, xs),
                         _padded(h0, precision, xs)):
        assert torch.equal(got, want)
    g, rest = divmod(i, h.k * 8 * 128)
    t, lane = divmod(rest, 128)
    sb = t // h.k
    col = int(np.asarray(h.ja).reshape(-1)[i])
    x_inf = x.copy()
    x_inf[col] = np.inf
    _, xs_inf = _upload(sell0, precision, x_inf, csr.ncols)
    assert torch.isnan(_padded(h0, precision, xs_inf)[0][g, sb, lane])
    assert torch.isfinite(_plain(b0, precision, xs_inf)[0][g, sb, lane])


def test_check_bin_refuses_broken_compacted_sb_list():
    """The launch checks refuse a compacted bin without its row table, or
    with a row table or plane offsets of the wrong size."""
    _, sell = _sell("road")
    (b,) = S.device_put_sell(sell, device="cpu").bins
    dev = torch.device("cpu")
    S._check_bin(b, {"as_": b.as_}, dev, (torch.float32,))
    for bad, what in ((dataclasses.replace(b, row_table=None), "row_table"),
                      (dataclasses.replace(b, row_table=b.row_table[:-1]),
                       "do not match"),
                      (dataclasses.replace(b, plane_off=b.plane_off[:-1]),
                       "do not match")):
        with pytest.raises(ValueError, match=what):
            S._check_bin(bad, {"as_": bad.as_}, dev, (torch.float32,))


# ---- the k-major SpMM ----


# matrix -> generator: windows that fit _STAGE_ROWS (a narrow band) and
# ones that do not (a wide one)
KM = {"narrow": lambda m: m.banded(2048, 24, 40, seed=0),
      "wide": lambda m: m.banded(2048, 24, 512, seed=0)}


def _k_major(matrix):
    csr = CSRMatrix.from_coo(KM[matrix](syn))
    sell = SellMatrix.from_csr(csr, layout="k-major")
    return csr, sell, S.device_put_sell(sell, device="cpu")


@pytest.mark.parametrize("matrix", sorted(KM))
def test_k_major_window_table_matches_numpy(matrix):
    """``x_window[g*8 + i]`` is the first column and the span of block (g,
    i)'s slots, pads included; ``window_rows`` the widest span of at most
    ``_STAGE_ROWS``; the narrow band stages every block, the wide one
    none."""
    _, sell, d = _k_major(matrix)
    for h, b in zip(sell.bins, d.bins):
        ja = np.asarray(h.ja).reshape(h.n_groups, h.k, 8, 128)
        lo, hi = ja.min(axis=(1, 3)), ja.max(axis=(1, 3))
        want = np.stack([lo, hi - lo + 1], -1).reshape(-1, 2)
        assert b.x_window.dtype == torch.int32
        assert np.array_equal(b.x_window.numpy(), want)
        span = want[:, 1]
        fits = span[span <= S._STAGE_ROWS]
        assert b.window_rows == (int(fits.max()) if fits.size else 0)
        assert SM.staged_blocks(b) == fits.size
        assert fits.size == (span.size if matrix == "narrow" else 0)


@pytest.mark.parametrize("rhs", [1, 4, 16, 32])
def test_k_major_spmm_columns_equal_spmv_plain(rhs, monkeypatch):
    """Column j of the k-major SpMM plain version is the SpMV plain version
    on X[:, j], bit for bit: the same entries in the same order, each added
    with one fmaf; stored through ``sell_spmm`` too. The SpMV runs one lane
    a row here (its 2-group bin would split its rows over lanes, which sums
    in another order)."""
    monkeypatch.setattr(S, "_KM_SPLIT_BELOW", 0)
    csr, _, d = _k_major("wide")
    X = np.random.default_rng(rhs).standard_normal((csr.ncols, rhs),
                                                   dtype=np.float32)
    x_tab = SM.device_put_x_multi(X, csr.ncols, device="cpu")
    Y = SM.sell_spmm(d, x_tab)
    for b in d.bins:
        want = SM.k_major_spmm_bin_plain(b, x_tab)
        for j in range(rhs):
            y = S.k_major_bin_plain(b, S.device_put_x(X[:, j], csr.ncols,
                                                      device="cpu"))
            assert torch.equal(want[..., j], y), j
    for j in range(rhs):
        y = S.sell_spmv(d, S.device_put_x(X[:, j], csr.ncols, device="cpu"))
        assert torch.equal(Y[:, j], y), j
    ref = np.column_stack([csr.spmv(X[:, j].astype(np.float64))
                           for j in range(rhs)])
    assert np.abs(Y.numpy() - ref).max() < 1e-5 * np.abs(ref).max()
