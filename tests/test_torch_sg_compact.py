"""The compacted sg upload, the k-major lane split and the stored-zero rule,
on the CPU.

The f32 and bf16 sg upload keeps only the real slots of the real tiles (a
tile below its group's ``slab_count``, a value that is not zero), decodes
each to its row (``sigma*128 + j`` in slots mode, ``p*128 + j`` in rows
mode) and its absolute column, keeps each row's slots in (tile, p) order and
lays the rows out as the compacted sb-list bin does. Its plain version adds
each row's slots in that order with one fmaf each, so it differs from the
padded layout's sums (``sg_padded_plain``: per position, then over
positions and chunks) only in the order of f32 additions: rtol=1e-5,
atol=1e-5*max|y|, the JAX f32 tests' tolerance, also against the JAX
``_kernel_sg`` in interpret mode.

A k-major bin of few groups splits each row's slots over G lanes (a
function of the bin's shape only), lane p taking slots p, p + G, ... and
the lanes joined pairwise. Against the JAX ``_kernel_k_major`` and
``_kernel_k_major_dd`` in interpret mode the tolerances are the JAX tests':
rtol=1e-5, atol=1e-5*max|y| in f32 and 1e-9*max|y| in dd.

The stored-zero rule: a slot whose value is zero adds nothing to its row, in
every layout and precision. A matrix whose one entry in some column
is stored as an explicit zero, with x infinite at that column, must give
finite rows equal to the fp64 oracle of the matrix without that entry
(f32: rtol=1e-5, atol=1e-5*max|y|; dd: 1e-12*max|y|, the dd tests' own).
"""

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
from sparsematrixvectormultiplication_tpu_torch import CSRMatrix, SellMatrix
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
    combine_f64,
    dd_add_dd,
    dd_mul_dd,
)

RTOL = 1e-5
ATOL_REL = 1e-5

# matrix -> (generator, SellMatrix.from_csr keywords): both sg modes on
# road (as tests/test_torch_sell.py converts it) and the suite's uniform
SG = {"road_slots": (lambda m: m.road_network(8000, seed=5),
                     {"layout": "sg"}),
      "road_rows": (lambda m: m.road_network(8000, seed=5),
                    {"layout": "sg", "sg_slots": False}),
      "uniform": (lambda m: m.random_general(20000, 20000, 2.5e-4, seed=8),
                  {})}


def _x(n, seed=5):
    return np.random.default_rng(seed).standard_normal(n)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


def _sg_pairs(matrix):
    make, kw = SG[matrix]
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(make(syn)), **kw)
    d = S.device_put_sell(sell, device="cpu")
    pairs = [(h, b) for h, b in zip(sell.bins, d.bins) if h.layout == "sg"]
    assert pairs and all(b.row_table is not None for _, b in pairs)
    return sell, pairs


def _padded_rows(h):
    """Host sg bin ``h``'s real slots row by row: for each row ``g*1024 +
    row`` the columns of its real slots (a value that is not zero in a real
    tile) in (tile, p) order, decoded as the padded layout decodes them."""
    ng, T = h.n_groups, h.k
    stride = 2 if h.span == 0 else 1
    md = np.asarray(h.ja, np.int64).reshape(ng, T, 8, 128)
    v = np.asarray(h.as_).reshape(ng, T, 8, 128)
    w0 = np.asarray(h.slab_list, np.int64).reshape(ng, T, stride)[:, :, 0]
    count = np.asarray(h.slab_count).reshape(-1)
    rows = {}
    for g, t, p, j in zip(*np.nonzero(v)):
        if t >= count[g]:
            continue
        m = md[g, t, p, j]
        row = ((m >> 7) & 7 if h.sg_slots else p) * 128 + j
        rows.setdefault(g * 1024 + row, []).append(
            (t, p, (w0[g, t] + (m >> 10)) * 128 + (m & 127)))
    return {r: [c for _, _, c in sorted(s)] for r, s in rows.items()}


@pytest.mark.parametrize("matrix", sorted(SG))
def test_compacted_sg_slots_are_the_entries(matrix):
    """The compacted slots are the host bin's real entries, ``real_nnz`` of
    them, each row's columns the padded layout's decode in (tile, p) order;
    each 32 sorted rows' plane is as wide as the longest of them."""
    _, pairs = _sg_pairs(matrix)
    for h, b in pairs:
        lens = (b.row_table >> 10).long()
        assert int(lens.sum()) == h.real_nnz
        widths = b.plane_off[1:] - b.plane_off[:-1]
        assert torch.equal(widths, lens.view(-1, 32).amax(1).int())
        assert b.ja.numel() == 32 * int(b.plane_off[-1])
        want = _padded_rows(h)
        t = b.row_table.numpy()
        s = np.arange(t.size)
        row = s // 1024 * 1024 + (t & 1023)
        pos = b.plane_off.numpy()[s // 32].astype(np.int64) * 32 + s % 32
        cols = b.ja.view(-1).numpy()
        got = {int(r): [int(cols[q + 32 * i]) for i in range(n)]
               for r, q, n in zip(row, pos, t >> 10) if n}
        assert got == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("matrix", sorted(SG))
def test_compacted_sg_equals_padded_plain(matrix, dtype):
    """The compacted bin's plain version (the row-list kernel's order)
    against the padded layout's sums in the tile kernel's order, within
    f32 rounding."""
    make, kw = SG[matrix]
    csr = CSRMatrix.from_coo(make(syn))
    sell = SellMatrix.from_csr(csr, **kw)
    d = S.device_put_sell(sell, dtype, device="cpu")
    x_tab = S.device_put_x(_x(csr.ncols), csr.ncols, device="cpu")
    for h, b in zip(sell.bins, d.bins):
        if h.layout == "sg":
            assert b.as_.dtype == dtype
            _close(S.sg_bin_plain(b, x_tab), S.sg_padded_plain(h, x_tab,
                                                               dtype))


def test_compacted_sg_matches_pallas_interpret():
    """Road's slot-packed sg conversion, as tests/test_sg.py runs it: the
    port's compacted upload against the JAX sg kernel in interpret mode on
    the same host SELL."""
    sell = JSell.from_csr(JCSR.from_coo(jsyn.road_network(
        8000, seed=5)).split_heavy_rows(256)[0], layout="sg")
    assert {b.layout for b in sell.bins} == {"sg", "k-major"}
    x = _x(sell.ncols, seed=11).astype(np.float32)
    want = np.asarray(sell_spmv_pallas(jax_device_put_sell(sell, jnp.float32),
                                       jnp.asarray(x), interpret=True))
    d = S.device_put_sell(sell, device="cpu")
    assert all(b.row_table is not None for b in d.bins if b.layout == "sg")
    _close(S.sell_spmv(d, S.device_put_x(x, sell.ncols, device="cpu")), want)


def test_dd_sg_bins_stay_padded():
    """The dd upload keeps its sg bins padded, with no row table, so the dd
    path never takes them for compacted sb-list pairs."""
    sell, _ = _sg_pairs("road_slots")
    d = D.device_put_sell_dd(sell, device="cpu")
    for h, b in zip(sell.bins, d.bins):
        if h.layout == "sg":
            assert b.row_table is None and b.plane_off is None
            assert b.as_pair.shape == (h.n_groups * h.k * 8, 128, 2)


# ---- the k-major lane split ----


def _k_major_bin(ng, k):
    return S.DeviceBinIndex(layout="k-major", k=k, n_groups=ng,
                            group_ids=torch.zeros(ng), ja=torch.zeros(0),
                            slab_list=torch.zeros(0),
                            slab_count=torch.zeros(ng))


def test_k_major_lanes_follow_the_bin_shape():
    """Bins of fewer than 2 x 132 blocks split their rows over up to 32
    lanes, each at least four slots, at most four blocks an SM in all; the
    lanes follow n_groups and K alone, whatever the bin holds."""
    assert S._k_major_lanes(_k_major_bin(245, 64)) == 1   # band64's bin
    assert S._k_major_lanes(_k_major_bin(33, 64)) == 1
    assert S._k_major_lanes(_k_major_bin(32, 64)) == 2
    assert S._k_major_lanes(_k_major_bin(17, 81)) == 2
    assert S._k_major_lanes(_k_major_bin(16, 16)) == 4    # entry's bin
    assert S._k_major_lanes(_k_major_bin(6, 16)) == 4
    assert S._k_major_lanes(_k_major_bin(1, 96)) == 16
    assert S._k_major_lanes(_k_major_bin(1, 128)) == 32
    assert S._k_major_lanes(_k_major_bin(1, 4)) == 1
    assert S._k_major_lanes(_k_major_bin(1, 8)) == 2
    assert S._k_major_lanes(_k_major_bin(0, 64)) == 1
    csr = CSRMatrix.from_coo(syn.banded(4096, 24, 512, seed=0))
    (b,) = S.device_put_sell(SellMatrix.from_csr(csr), device="cpu").bins
    assert S._k_major_lanes(b) == S._k_major_lanes(
        _k_major_bin(b.n_groups, b.k)) > 1


@pytest.mark.parametrize("precision", ["f32", "dd"])
def test_split_k_major_matches_pallas_interpret(precision):
    """A k-major band of 4 groups (split over lanes) against the JAX
    k-major kernel in interpret mode, f32 and dd."""
    sell = JSell.from_csr(JCSR.from_coo(jsyn.banded(4096, 24, 512, seed=0)))
    assert [b.layout for b in sell.bins] == ["k-major"]
    x = _x(sell.ncols, seed=3)
    if precision == "f32":
        x = x.astype(np.float32)
        want = np.asarray(sell_spmv_pallas(
            jax_device_put_sell(sell, jnp.float32), jnp.asarray(x),
            interpret=True))
        d = S.device_put_sell(sell, device="cpu")
        assert S._k_major_lanes(d.bins[0]) > 1
        _close(S.sell_spmv(d, S.device_put_x(x, sell.ncols, device="cpu")),
               want)
        return
    xh, xl = jdd.split_f64(x)
    want = np.asarray(jdd.combine_f64(*sell_spmv_pallas_dd(
        jax_device_put_sell_dd(sell), jnp.asarray(xh), jnp.asarray(xl),
        interpret=True)))[: sell.nrows]
    d = D.device_put_sell_dd(sell, device="cpu")
    got = combine_f64(*D.sell_spmv_dd(
        d, *D.device_put_x_dd(x, sell.ncols, device="cpu"))).numpy()
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("precision", ["f32", "dd"])
def test_split_k_major_sums_lanes_in_a_tree(precision):
    """Each lane's slots in order, the lanes joined pairwise, neighbours
    first: the plain version equals that sum written out for one row."""
    csr = CSRMatrix.from_coo(syn.banded(2048, 24, 512, seed=4))
    sell = SellMatrix.from_csr(csr)
    x = _x(csr.ncols, seed=9)
    if precision == "f32":
        (b,) = S.device_put_sell(sell, device="cpu").bins
        xs = (S.device_put_x(x, csr.ncols, device="cpu"),)
        out = (S.k_major_bin_plain(b, *xs),)
        vals = (b.as_.view(b.n_groups, b.k, 8, 128),)
    else:
        (b,) = D.device_put_sell_dd(sell, device="cpu").bins
        xs = D.device_put_x_dd(x, csr.ncols, device="cpu")
        out = D.k_major_bin_plain_dd(b, *xs)
        vals = tuple(v.view(b.n_groups, b.k, 8, 128)
                     for v in (b.as_hi, b.as_lo))
    lanes = S._k_major_lanes(b)
    assert lanes == 4
    cols = b.ja.view(b.n_groups, b.k, 8, 128).long()
    g, i, j = 1, 3, 77

    def add(acc, k):
        c = cols[g, k, i, j]
        v = tuple(t[g, k, i, j] for t in vals)
        if precision == "f32":
            return (S.fma_f32(v[0].double() * xs[0][c].double(), acc[0]),)
        return dd_add_dd(*acc, *dd_mul_dd(*v, xs[0][c], xs[1][c]))

    def join(a, c):
        return (a[0] + c[0],) if precision == "f32" else dd_add_dd(*a, *c)

    zero = tuple(torch.zeros(()) for _ in vals)
    sums = []
    for p in range(lanes):
        acc = zero
        for k in range(p, b.k, lanes):
            acc = add(acc, k)
        sums.append(acc)
    while len(sums) > 1:
        sums = [join(sums[q], sums[q + 1]) for q in range(0, len(sums), 2)]
    for o, w in zip(out, sums[0]):
        assert torch.equal(o[g, i, j], w)


# ---- the stored-zero rule ----


# layout -> (generator, SellMatrix.from_csr keywords, sb_i16)
ZERO_CASES = {
    "k-major": (lambda: syn.banded(4096, 24, 512, seed=0),
                {"layout": "k-major"}, False),
    "sb-major": (lambda: syn.banded(4096, 24, 512, seed=0),
                 {"layout": "sb-major"}, False),
    "sb-list": (lambda: syn.banded(4096, 24, 512, seed=0),
                {"layout": "sb-list"}, False),
    "sb-list-i16": (lambda: syn.banded(4096, 24, 512, seed=0),
                    {"layout": "sb-list"}, True),
    "wl": (lambda: syn.banded(4096, 18, 40, seed=2), {"layout": "wl"}, False),
    "sg-slots": (lambda: syn.road_network(8000, seed=5), {"layout": "sg"},
                 False),
    "sg-rows": (lambda: syn.road_network(8000, seed=5),
                {"layout": "sg", "sg_slots": False}, False),
}


def _column_once(csr, keep, value):
    """``csr`` with every entry of entry ``keep``'s column removed but that
    one, which holds ``value`` (None: removed too); and the column."""
    c = int(csr.col_idx[keep])
    e = np.arange(csr.nnz)
    mask = (csr.col_idx != c) | ((e == keep) & (value is not None))
    vals = np.where(e == keep, 0.0 if value is None else value, csr.values)
    row_ids = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(
        row_ids[mask], minlength=csr.nrows))]).astype(csr.row_ptr.dtype)
    return CSRMatrix(csr.nrows, csr.ncols, ptr, csr.col_idx[mask],
                     vals[mask]), c


def _bins_holding(csr, keep, kw, i16):
    """The layouts of the bins that hold entry ``keep`` once its column is
    its own: with a 1 there, a one-hot x at that column lights only them."""
    one, c = _column_once(csr, keep, 1.0)
    d = S.device_put_sell(SellMatrix.from_csr(one, **kw), device="cpu",
                          sb_i16=i16)
    onehot = np.zeros(csr.ncols)
    onehot[c] = 1.0
    x = S.device_put_x(onehot, csr.ncols, device="cpu")
    lit = set()
    for b in d.bins:
        y = torch.zeros(d.num_groups * 1024)
        S._KERNEL[b.layout](b, x, y)
        if y.abs().max() > 0:
            lit.add(b.layout)
    return lit


@pytest.mark.parametrize("precision", ["f32", "dd"])
@pytest.mark.parametrize("layout", sorted(ZERO_CASES))
def test_stored_zero_adds_nothing(layout, precision):
    """One entry of a column, stored as 0, with x = inf at that column:
    every row is finite and equals the fp64 oracle of the matrix without
    the entry. The entry is the first of the middle rows' that lies in a
    bin of the layout under test (sg conversions put far entries in
    add_into k-major bins)."""
    make, kw, i16 = ZERO_CASES[layout]
    want = layout.removesuffix("-i16").removesuffix("-slots").removesuffix(
        "-rows")
    full = CSRMatrix.from_coo(make())
    start = int(full.row_ptr[full.nrows // 2])
    keep = next(e for e in range(start, start + 40)
                if _bins_holding(full, e, kw, i16) == {want})
    csr, c = _column_once(full, keep, 0.0)
    ref_csr, _ = _column_once(full, keep, None)
    sell = SellMatrix.from_csr(csr, **kw)
    x = _x(csr.ncols, seed=2)
    x[c] = np.inf
    ref = ref_csr.spmv(x if precision == "dd" else
                       x.astype(np.float32).astype(np.float64))
    assert np.isfinite(ref).all()
    if precision == "dd":
        d = D.device_put_sell_dd(sell, device="cpu", sb_i16=i16)
        y = D.sell_spmv_dd_f64(d, torch.from_numpy(x)).numpy()
        assert np.isfinite(y).all()
        assert np.abs(y - ref).max() <= 1e-12 * np.abs(ref).max()
    else:
        d = S.device_put_sell(sell, device="cpu", sb_i16=i16)
        assert any(b.ja.dtype == torch.int16 for b in d.bins
                   if b.layout == "sb-list") == i16
        y = S.sell_spmv(d, S.device_put_x(x, csr.ncols, device="cpu"))
        assert torch.isfinite(y).all()
        _close(y.double(), ref)
