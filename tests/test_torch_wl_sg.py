"""The compacted wl upload and the sg sums in the kernels' order, on the CPU.

The wl upload keeps only the slots whose value is not zero, row by row in
the order (w, l, s), each with a 2-byte column code. Its plain versions add
each row's slots in that order with the kernels' rounding (one fmaf a slot:
``fma_f32``; dd: ``dd_add_dd`` of ``dd_mul_dd``), so they must equal the
padded layout's function (``wl_padded_plain``: every slot, pads included)
bit for bit on finite x, up to the sign of a zero sum: a pad only added an
exact zero. Against the JAX package's wl kernel in interpret mode the
tolerances are its tests' own: rtol=1e-5, atol=1e-5*max|y| in f32.

The sg plain versions sum in the kernel's order too: per (group, chunk of
tiles, slot position) onto 8 sigma sums (slots mode) or one (rows mode),
then over the positions and the chunks in order. Slots mode in dd has no
TPU counterpart (the JAX dd kernel takes rows mode only), so it is held to
the fp64 oracle at 1e-12 * max|y| and to the JAX rows-mode dd kernel in
interpret mode at the JAX dd tests' 1e-9 * max|y|; the chunked sums to the
unchunked ones at 1e-13 * max|y| (f32: 1e-6, the f32 sums' own order).
"""

import dataclasses
from fractions import Fraction

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
from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
    combine_f64,
    dd_add_dd,
)

# matrix -> (generator, SellMatrix.from_csr keywords): fem's own wl bins and
# a band forced to wl
WL = {"fem": (lambda m: m.fem_3d(20, 20, 20, dof=3, seed=1), {}),
      "banded": (lambda m: m.banded(4096, 18, 40, seed=2), {"layout": "wl"})}
PRECISIONS = ("f32", "bf16", "dd")


def _sell(matrix, kw_extra=None):
    make, kw = WL[matrix]
    csr = CSRMatrix.from_coo(make(syn))
    return csr, SellMatrix.from_csr(csr, **kw, **(kw_extra or {}))


def _x(n, seed=5):
    return np.random.default_rng(seed).standard_normal(n)


def _wl_pairs(sell, d):
    pairs = [(h, b) for h, b in zip(sell.bins, d.bins) if h.layout == "wl"]
    assert pairs
    return pairs


def _by_row(h, plane):
    """A host wl plane as (rows, k): each row's slots in the order (w, l,
    s)."""
    ng, nw, L = h.n_groups, h.chunk_k, h.span
    return np.asarray(plane).reshape(ng, 8, nw, L, 8, 128).transpose(
        0, 1, 5, 2, 3, 4).reshape(ng * 1024, h.k)


def _plain(b, precision, x):
    if precision == "dd":
        return D.wl_bin_plain_dd(b, *x)
    return (S.wl_bin_plain(b, *x),)


def _padded(h, precision, x):
    if precision == "dd":
        return D.wl_padded_plain_dd(h, *x)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return (S.wl_padded_plain(h, x[0], dtype),)


def _upload(sell, precision, x, ncols):
    if precision == "dd":
        return (D.device_put_sell_dd(sell, device="cpu"),
                D.device_put_x_dd(x, ncols, device="cpu"))
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return (S.device_put_sell(sell, dtype, device="cpu"),
            (S.device_put_x(x, ncols, device="cpu"),))


# ---- the fma the f32 plain versions emulate ----


def _fma_exact(a, b, c):
    """fmaf(a, b, c) by exact rational arithmetic: a*b + c rounded once to
    the nearest f32, ties to even."""
    q = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    mid = np.float32(float(q))
    cands = [np.nextafter(mid, np.float32(-np.inf)), mid,
             np.nextafter(mid, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - q) for v in cands]
    best = min(dist)
    ties = [v for v, dv in zip(cands, dist) if dv == best]
    return min(ties, key=lambda v: int(v.view(np.uint32)) & 1)


def test_fma_f32_rounds_once():
    """``fma_f32`` of the exact product equals the one-rounding result,
    also where rounding a*b + c to f64 first lands on an f32 midpoint (the
    double rounding it must avoid)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = (rng.standard_normal(4000) * np.exp(rng.uniform(-20, 20, 4000))
         ).astype(np.float32)
    c = (rng.standard_normal(4000) * np.exp(rng.uniform(-30, 30, 4000))
         ).astype(np.float32)
    # a*b = 1 + 2^-11 + 2^-24, a midpoint of f32; c tips it either way
    a[:4] = b[:4] = np.float32(1 + 2**-12)
    c[:4] = [2.0**-60, -2.0**-60, 0.0, 2.0**-30]
    p = torch.from_numpy(a).double() * torch.from_numpy(b).double()
    got = S.fma_f32(p, torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert not np.array_equal(naive[:2], want[:2])  # the trap is real


# ---- the compacted wl upload ----


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("matrix", sorted(WL))
def test_compacted_wl_equals_padded_plain(matrix, precision):
    csr, sell = _sell(matrix)
    d, x = _upload(sell, precision, _x(csr.ncols), csr.ncols)
    for h, b in _wl_pairs(sell, d):
        assert b.ja.numel() < np.asarray(h.ja).size
        for got, want in zip(_plain(b, precision, x),
                             _padded(h, precision, x)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ["f32", "dd"])
def test_compacted_wl_accumulates_on_panels(precision):
    """Column panels: every wl bin adds onto y, and adds what the padded
    layout adds, bit for bit; the whole panel SpMV holds the oracle."""
    csr = CSRMatrix.from_coo(syn.fem_3d(10, 10, 10, dof=3, seed=0))
    psell = PanelSellMatrix.from_csr(csr, max_panel_cols=1024)
    x = _x(csr.ncols, seed=3)
    seen = 0
    for p, panel in enumerate(psell.panels):
        c0, c1 = psell.bounds[p], psell.bounds[p + 1]
        d, xs = _upload(panel, precision, x[c0:c1], c1 - c0)
        y0 = [torch.randn(d.num_groups * 1024) for _ in xs]
        for h, b in ((h, b) for h, b in zip(panel.bins, d.bins)
                     if h.layout == "wl"):
            seen += 1
            y = [t.clone() for t in y0]
            kernel = D.wl_bin_dd if precision == "dd" else S.wl_bin
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
        tol = 1e-13
    else:
        y = S.panel_sell_spmv(S.device_put_sell(psell, device="cpu"),
                              torch.from_numpy(x).float()).double().numpy()
        tol = 1e-5
    ref = csr.spmv(x.astype(np.float32).astype(np.float64)
                   if precision == "f32" else x)
    assert np.abs(y - ref).max() < tol * np.abs(ref).max()


def test_compacted_wl_matches_pallas_interpret():
    """A band forced to wl, as tests/test_sell_spmm.py builds it: the
    port's compacted upload against the JAX wl kernel in interpret mode on
    the same host SELL, at the JAX tests' f32 tolerance."""
    sell = JSell.from_csr(JCSR.from_coo(jsyn.banded(1024, 18, 40, seed=2)),
                          layout="wl")
    assert [(b.layout, b.k) for b in sell.bins] == [("wl", 48)]
    x = _x(sell.ncols, seed=11).astype(np.float32)
    want = np.asarray(sell_spmv_pallas(jax_device_put_sell(sell, jnp.float32),
                                       jnp.asarray(x), interpret=True))
    d = S.device_put_sell(sell, device="cpu")
    got = S.sell_spmv(d, S.device_put_x(x, sell.ncols, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("matrix", sorted(WL))
def test_compacted_slots_are_the_entries(matrix):
    """The compacted slots are the host bin's nonzero values, one a row's
    real entry; each (group, row-block) plane is as wide as its longest
    row; codes decode (``_wl_slots``) to the padded layout's columns,
    128*slab + m, in the order (w, l, s)."""
    csr, sell = _sell(matrix)
    d = S.device_put_sell(sell, device="cpu")
    for h, b in _wl_pairs(sell, d):
        v = _by_row(h, h.as_)
        keep = v != 0
        n = b.row_len.numpy()
        assert np.array_equal(n, keep.sum(1))
        assert b.ja.numel() == 128 * int(b.plane_off[-1])
        widths = (b.plane_off[1:] - b.plane_off[:-1]).numpy()
        assert np.array_equal(widths, n.reshape(-1, 128).max(1))
        shape, cols, real, _ = S._wl_slots(b)
        assert int(real.sum()) == int(keep.sum()) == h.real_nnz
        slab = np.asarray(h.slab_list).reshape(h.n_groups, 8, h.chunk_k, 1,
                                               8, 1).astype(np.int64)
        padded = _by_row(h, np.broadcast_to(
            slab * 128, (h.n_groups, 8, h.chunk_k, h.span, 8, 128))
            + np.asarray(h.ja).reshape(h.n_groups, 8, h.chunk_k, h.span, 8,
                                       128))
        r = np.arange(h.n_groups * 1024)
        pos = (b.plane_off.numpy()[r // 128].astype(np.int64)[:, None] * 128
               + (r % 128)[:, None] + np.arange(h.k)[None, :] * 128)
        live = np.arange(h.k)[None, :] < n[:, None]
        got = cols.reshape(-1).numpy()[np.where(live, pos, 0)]
        order = np.argsort(~keep, axis=1, kind="stable")
        want = np.take_along_axis(padded, order, 1)
        assert np.array_equal(got[live], want[live])


@pytest.mark.parametrize("precision", ["f32", "dd"])
def test_stored_zero_is_dropped(precision):
    """A stored explicit zero is dropped with the pads: one slot fewer, and
    y unchanged bit for bit on finite x. Where x is infinite at its column
    the padded layout's 0 * inf made NaN; the compacted one does not."""
    csr, sell = _sell("banded")
    h = next(b for b in sell.bins if b.layout == "wl")
    v = np.array(h.as_)
    i = np.flatnonzero(v.reshape(-1))[123]
    v.reshape(-1)[i] = 0.0
    h0 = dataclasses.replace(h, as_=v)
    sell0 = dataclasses.replace(sell, bins=[h0 if b is h else b
                                            for b in sell.bins])
    x = _x(csr.ncols)
    d, xs = _upload(sell, precision, x, csr.ncols)
    d0, _ = _upload(sell0, precision, x, csr.ncols)
    b = next(b for b in d.bins if b.layout == "wl")
    b0 = next(b for b in d0.bins if b.layout == "wl")
    assert b0.ja.numel() <= b.ja.numel()
    assert int(b0.row_len.sum()) == int(b.row_len.sum()) - 1
    for got, want in zip(_plain(b0, precision, xs), _padded(h0, precision,
                                                            xs)):
        assert torch.equal(got, want)
    # the zeroed entry's column, as the padded layout decodes it
    g, rest = divmod(i, h.k * 8 * 128)
    t, lane = divmod(rest, 128)
    t, s = divmod(t, 8)
    w = t // h.span % h.chunk_k
    rb = t // (h.span * h.chunk_k)
    col = int(np.asarray(h.slab_list).reshape(h.n_groups, 8, h.chunk_k, 8)[
        g, rb, w, s]) * 128 + int(np.asarray(h.ja).reshape(-1)[i])
    x_inf = x.copy()
    x_inf[col] = np.inf
    _, xs_inf = _upload(sell0, precision, x_inf, csr.ncols)
    padded = _padded(h0, precision, xs_inf)[0]
    row = int(h.group_ids[g]) * 1024 + rb * 128 + lane
    assert torch.isnan(padded.reshape(-1)[g * 1024 + rb * 128 + lane])
    compact = _plain(b0, precision, xs_inf)[0].reshape(-1)
    assert torch.isfinite(compact[g * 1024 + rb * 128 + lane]), row


# ---- the sg sums in the kernel's order ----


def _uniform():
    return JCSR.from_coo(jsyn.random_general(20000, 20000, 2.5e-4, seed=8))


def _road():
    return JCSR.from_coo(jsyn.road_network(8000, seed=5)).split_heavy_rows(
        256)[0]


SG = {"uniform": _uniform, "road": _road}


@pytest.mark.parametrize("matrix", sorted(SG))
def test_sg_slots_dd_against_oracle_and_jax_rows_mode(matrix):
    """Slots-mode sg bins in dd: the plain versions' y within 1e-12 of the
    fp64 oracle, and of the JAX rows-mode dd kernel (interpret mode) on the
    rows-mode conversion of the same matrix within its tests' 1e-9."""
    csr = SG[matrix]()
    slots = JSell.from_csr(csr, layout="sg")
    assert any(b.sg_slots for b in slots.bins)
    x = _x(csr.ncols, seed=7)
    y_ref = csr.spmv(x)
    y = D.sell_spmv_dd_f64(D.device_put_sell_dd(slots, device="cpu"),
                           torch.from_numpy(x)).numpy()
    assert np.abs(y - y_ref).max() < 1e-12 * np.abs(y_ref).max()
    rows = JSell.from_csr(csr, layout="sg", sg_slots=False)
    xh, xl = jdd.split_f64(x)
    y_jax = np.asarray(jdd.combine_f64(*sell_spmv_pallas_dd(
        jax_device_put_sell_dd(rows), jnp.asarray(xh), jnp.asarray(xl),
        interpret=True)))[: csr.nrows]
    assert np.abs(y - y_jax).max() <= 1e-9 * np.abs(y_jax).max()


@pytest.mark.parametrize("chunks", [2, 5])
@pytest.mark.parametrize("mode", ["slots", "rows"])
@pytest.mark.parametrize("precision", ["f32", "dd"])
def test_sg_chunked_sums_equal_unchunked(precision, mode, chunks):
    """A group's tiles split into chunks, their partial sums joined in
    order, give the one-chunk sums (dd: within 1e-13 * max|y|; f32 within
    1e-6, the f32 sums' own order). f32 bins are compacted at upload, so
    their padded tile sums are the host bins' (``sg_padded_plain``)."""
    csr = CSRMatrix.from_coo(syn.random_general(20000, 20000, 2.5e-4,
                                                seed=8))
    sell = SellMatrix.from_csr(csr, layout="sg", sg_slots=mode == "slots")
    x = _x(csr.ncols, seed=2)
    if precision == "dd":
        d = D.device_put_sell_dd(sell, device="cpu")
        xs = D.device_put_x_dd(x, csr.ncols, device="cpu")
        plain = lambda b, c: combine_f64(*D.sg_bin_plain_dd(  # noqa: E731
            b, *xs, chunks=c))
        tol = 1e-13
    else:
        d = sell
        xs = (S.device_put_x(x, csr.ncols, device="cpu"),)
        plain = lambda h, c: S.sg_padded_plain(  # noqa: E731
            h, *xs, chunks=c)
        tol = 1e-6
    bins = [b for b in d.bins if b.layout == "sg"]
    assert bins and all(b.sg_slots == (mode == "slots") for b in bins)
    for b in bins:
        one, split = plain(b, 1), plain(b, chunks)
        assert (split - one).abs().max() <= tol * one.abs().max()
        assert not torch.equal(split, torch.zeros_like(split))


def test_sg_chunks_follow_the_bin_shape():
    """Bins of fewer groups than two blocks an SM are split, into enough
    chunks for about 8 x 132 blocks of at least 16 tiles; others are not."""
    def bin_of(ng, k):
        return S.DeviceBinIndex(layout="sg", k=k, n_groups=ng,
                                group_ids=torch.zeros(ng), ja=torch.zeros(0),
                                slab_list=torch.zeros(0),
                                slab_count=torch.zeros(ng))
    assert S._sg_chunks(bin_of(264, 512)) == 1
    assert S._sg_chunks(bin_of(137, 256)) == 8
    assert S._sg_chunks(bin_of(84, 512)) == 13
    assert S._sg_chunks(bin_of(5, 512)) == 32  # 16 tiles a chunk
    assert S._sg_chunks(bin_of(5, 8)) == 1
    assert S._sg_chunks(bin_of(0, 64)) == 1
