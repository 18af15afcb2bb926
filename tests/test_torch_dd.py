"""The port's double-double SELL path on the CPU, against the JAX package.

The JAX side runs ``sell_spmv_pallas_dd(..., interpret=True)`` on its own
host ``SellMatrix``; the port uploads that same host object with
``device_put_sell_dd`` and runs it on the CPU, where every dd wrapper takes
its plain PyTorch version. Tolerances:

* port vs JAX interpret: 1e-9 * max|y| on the fp64-combined result, the JAX
  dd tests' own bound (tests/test_doubledouble.py:115-117): interpret mode
  partly folds the error-free transforms;
* port vs the fp64 oracle: norm-scaled ``max|y - y_ref| / max|y_ref| <
  1e-13`` (tests/test_doubledouble.py:96).

The shapes are the JAX dd tests', cut where interpret mode would take
minutes: banded(2048, 12, 200) for k-major and the sb layouts, fem_3d(8, 8,
8) for wl.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.formats.sell import (
    PanelSellMatrix as JPanel,
    SellMatrix as JSell,
)
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops import doubledouble as jdd
from sparsematrixvectormultiplication_tpu.ops.pallas_sell_dd import (
    device_put_sell_dd as jax_device_put_sell_dd,
    sell_spmv_pallas_dd,
)
from sparsematrixvectormultiplication_tpu_torch import (
    CSRMatrix,
    PanelSellMatrix,
    SellMatrix,
    run_matrix,
)
from sparsematrixvectormultiplication_tpu_torch.bench.harness import BenchConfig
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import doubledouble as dd
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D

JAX_REL = 1e-9      # port vs JAX interpret, times max|y|
ORACLE_REL = 1e-13  # port vs the fp64 oracle, times max|y_ref|


def _x(n, seed=7):
    return np.random.default_rng(seed).standard_normal(n)


def _norm_err(y, y_ref):
    return np.abs(y - y_ref).max() / np.abs(y_ref).max()


# ---- arithmetic ----


def test_split_f64_bit_identical_to_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096) * np.exp(rng.uniform(-40, 40, 4096))
    x[:4] = [0.0, -0.0, 1.0, -3.5]
    for mine, theirs in zip(dd.split_f64(x), jdd.split_f64(x)):
        assert mine.dtype == np.float32
        assert np.array_equal(mine.view(np.uint32), theirs.view(np.uint32))


EFTS = {
    # op -> (function, scale of b): p + e == a op b exactly
    "two_sum": (dd.two_sum, 1e-6, np.add),
    "fast_two_sum": (dd.fast_two_sum, 1e-3, np.add),  # needs |a| >= |b|
    "two_prod": (dd.two_prod, 1.0, np.multiply),
}


@pytest.mark.parametrize("op", sorted(EFTS))
def test_error_free_transforms_exact(op):
    """Mirrors tests/test_doubledouble.py:37-53 on the torch versions."""
    fn, scale, exact_op = EFTS[op]
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(4096) * scale).astype(
        np.float32))
    if op == "fast_two_sum":
        a = torch.where(a.abs() >= b.abs(), a, b * 2.0**20)
    s, e = fn(a, b)
    assert s.dtype == e.dtype == torch.float32
    exact = exact_op(a.double().numpy(), b.double().numpy())
    assert np.array_equal(s.double().numpy() + e.double().numpy(), exact)


def test_dd_ops_match_jax_bit_for_bit():
    """dd_add_dd and dd_mul_dd give the JAX package's pairs exactly: both
    run the same sequence of separately rounded f32 ops."""
    rng = np.random.default_rng(2)
    xh, xl = jdd.split_f64(rng.standard_normal(2048))
    yh, yl = jdd.split_f64(rng.standard_normal(2048) * 1e3)
    args = [torch.from_numpy(v) for v in (xh, xl, yh, yl)]
    jargs = [jnp.asarray(v) for v in (xh, xl, yh, yl)]
    for mine, theirs in ((dd.dd_add_dd, jdd.dd_add_dd),
                         (dd.dd_mul_dd, jdd.dd_mul_dd)):
        for m, t in zip(mine(*args), theirs(*jargs)):
            assert np.array_equal(m.numpy(), np.asarray(t))


def test_dd_dot_product_accuracy():
    """The plain versions' pairwise dd reduction of an ill-conditioned dot
    product holds 1e-12 relative (tests/test_doubledouble.py:55-75)."""
    rng = np.random.default_rng(3)
    a64, b64 = rng.standard_normal(4096), rng.standard_normal(4096)
    ah, al = (torch.from_numpy(v) for v in dd.split_f64(a64))
    bh, bl = (torch.from_numpy(v) for v in dd.split_f64(b64))
    h, l = D._dd_sum(*dd.dd_mul_dd(ah, al, bh, bl))
    got = float(dd.combine_f64(h, l))
    assert abs(got - a64 @ b64) / abs(a64 @ b64) < 1e-12


# ---- every layout against the JAX dd kernels in interpret mode ----


def _banded():
    return JCSR.from_coo(jsyn.banded(2048, 12, 200, seed=1))


def _fem():
    return JCSR.from_coo(jsyn.fem_3d(8, 8, 8, dof=3, seed=0))


def _road():
    # as tests/test_sg.py runs it: split heavy rows, sg rows mode
    return JCSR.from_coo(jsyn.road_network(8000, seed=5)).split_heavy_rows(
        256)[0]


# case -> (JAX CSR, SellMatrix.from_csr keywords, int16 sb planes, layouts)
CASES = {
    "k-major": (_banded, dict(layout="k-major"), False, {"k-major"}),
    "wl": (_fem, {}, False, {"k-major", "wl"}),
    "sb-major": (_banded, dict(layout="sb-major"), False, {"sb-major"}),
    "sb-list": (_banded, dict(layout="sb-list"), False, {"sb-list"}),
    "sb-major-i16": (_banded, dict(layout="sb-major"), True, {"sb-major"}),
    "sb-list-i16": (_banded, dict(layout="sb-list"), True, {"sb-list"}),
    "sg-rows": (_road, dict(layout="sg", sg_slots=False), False,
                {"sg", "k-major"}),
}


def _by_row(h, plane):
    """A host wl plane as (rows, k): each row's slots in the order (w, l,
    s)."""
    ng, nw, L = h.n_groups, h.chunk_k, h.span
    return np.asarray(plane).reshape(ng, 8, nw, L, 8, 128).transpose(
        0, 1, 5, 2, 3, 4).reshape(ng * 1024, h.k)


def _by_row_sb(h, plane):
    """A host sb plane as (rows, k): each row's entries in order."""
    return np.asarray(plane).reshape(h.n_groups, 8, h.k, 128).transpose(
        0, 1, 3, 2).reshape(h.n_groups * 1024, h.k)


def _by_row_km(h, plane):
    """A host k-major plane as (rows, k): each row's k slots in k order."""
    return np.asarray(plane).reshape(h.n_groups, h.k, 8, 128).transpose(
        0, 2, 3, 1).reshape(h.n_groups * 1024, h.k)


def _kept_rows(h, plane, keep, by_row=_by_row):
    """Each row's kept slots of a host wl (or sb) plane first, in order,
    then 0s."""
    v, k = by_row(h, plane), by_row(h, keep)
    order = np.argsort(~k, axis=1, kind="stable")
    return np.where(np.take_along_axis(k, order, 1),
                    np.take_along_axis(v, order, 1), 0)


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


def _wl_rows(b, plane):
    """A compacted wl plane as (rows, k) in each row's slot order, 0 past the
    row's length."""
    rows, k = b.n_groups * 1024, b.k
    n = b.row_len.numpy()
    r = np.arange(rows)
    pos = (b.plane_off.numpy()[r // 128].astype(np.int64)[:, None] * 128
           + (r % 128)[:, None] + np.arange(k)[None, :] * 128)
    live = np.arange(k)[None, :] < n[:, None]
    flat = plane.reshape(-1).numpy()
    return np.where(live, flat[np.where(live, pos, 0)], 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dd_layout_matches_pallas_interpret(case, monkeypatch):
    make, kw, i16, layouts = CASES[case]
    csr = make()
    sell = JSell.from_csr(csr, **kw)
    assert {b.layout for b in sell.bins} == layouts
    if case == "sg-rows":  # far bins and both window tables
        assert any(b.add_into for b in sell.bins)
        assert {b.span > 0 for b in sell.bins if b.layout == "sg"} == {
            True, False}
    x = _x(sell.ncols)
    xh, xl = jdd.split_f64(x)
    monkeypatch.setenv("SPMV_SB_I16", "1" if i16 else "0")
    jd = jax_device_put_sell_dd(sell)
    y_jax = np.asarray(jdd.combine_f64(*sell_spmv_pallas_dd(
        jd, jnp.asarray(xh), jnp.asarray(xl), interpret=True)))

    d = D.device_put_sell_dd(sell, device="cpu", sb_i16=i16)
    assert len(d.bins) == len(jd.bins) == len(sell.bins)
    for b, jb, h in zip(d.bins, jd.bins, sell.bins):
        # the hi/lo planes are the JAX split of the same bin (wl, int32
        # sb-list and k-major of one lane a row: its real slots, row by row;
        # wl, sb-list and sg: as (hi, lo) pairs), and the index planes the
        # JAX upload's (which may append padding groups)
        hi, lo = jdd.split_f64(np.asarray(h.as_, np.float64))
        n = hi.shape[0]
        jhi, jlo = np.asarray(jb.as_hi)[:n], np.asarray(jb.as_lo)[:n]
        assert np.array_equal(jhi, hi) and np.array_equal(jlo, lo)
        if b.layout == "wl":
            for half, want in ((0, jhi), (1, jlo)):
                assert np.array_equal(
                    _wl_rows(b, b.as_pair[..., half]),
                    _kept_rows(h, want, (jhi != 0) | (jlo != 0)))
            continue
        if (b.layout == "sb-list" and not i16) or D._km_compacts(b):
            # compacted: each row's real slots, values and columns in order
            assert b.row_table is not None
            keep = (jhi != 0) | (jlo != 0)
            halves = ((b.as_pair[..., 0], b.as_pair[..., 1])
                      if b.layout == "sb-list" else (b.as_hi, b.as_lo))
            for got, want in ((halves[0], jhi), (halves[1], jlo),
                              (b.ja, np.asarray(jb.ja)[:n])):
                assert np.array_equal(_sl_rows(b, got), _kept_rows(
                    h, want, keep, _by_row_sb if b.layout == "sb-list"
                    else _by_row_km))
            continue
        got = (b.as_pair[..., 0], b.as_pair[..., 1]) if b.layout == "sg" \
            else (b.as_hi, b.as_lo)
        assert np.array_equal(got[0].numpy(), jhi)
        assert np.array_equal(got[1].numpy(), jlo)
        assert np.array_equal(b.ja.numpy(),
                              np.asarray(jb.ja)[:b.ja.shape[0]])
        if b.layout in ("sb-major", "sb-list"):
            assert b.ja.dtype == (torch.int16 if i16 else torch.int32)
    th, tl = D.device_put_x_dd(x, sell.ncols, device="cpu")
    yh, yl = D.sell_spmv_dd(d, th, tl)
    assert yh.dtype == yl.dtype == torch.float32
    y = dd.combine_f64(yh, yl).numpy()
    assert np.abs(y - y_jax).max() <= JAX_REL * np.abs(y_jax).max()
    assert _norm_err(y, csr.spmv(x)) < ORACLE_REL
    assert torch.equal(yh, D.sell_spmv_dd_plain(d, th, tl)[0])
    # the fp64 entry, x split into the tables this plan's bins read
    assert np.array_equal(D.sell_spmv_dd_f64(d, torch.from_numpy(x)).numpy(),
                          y)


def test_dd_panels_match_pallas_interpret():
    """Column panels (tests/test_panels.py's 3000 x 9000 at 0.2%, 2048-column
    panels): every bin dd-adds onto one y pair."""
    csr = JCSR.from_coo(jsyn.random_general(3000, 9000, 0.002, seed=3))
    psell = JPanel.from_csr(csr, max_panel_cols=2048)
    assert len(psell.panels) >= 3
    x = _x(psell.ncols, seed=5)
    xh, xl = jdd.split_f64(x)
    y_jax = np.asarray(jdd.combine_f64(*sell_spmv_pallas_dd(
        jax_device_put_sell_dd(psell), jnp.asarray(xh), jnp.asarray(xl),
        interpret=True)))
    dps = D.device_put_sell_dd(psell, device="cpu")
    assert isinstance(dps, D.DevicePanelSellDD)
    y = dd.combine_f64(*D.panel_sell_spmv_dd(
        dps, torch.from_numpy(xh), torch.from_numpy(xl))).numpy()
    assert np.abs(y - y_jax).max() <= JAX_REL * np.abs(y_jax).max()
    assert _norm_err(y, csr.spmv(x)) < ORACLE_REL
    assert np.array_equal(
        D.sell_spmv_dd_f64(dps, torch.from_numpy(x)).numpy(), y)


# ---- the port's own: oracle, f32, slot-packed sg, f64 entry point ----


def test_dd_panels_with_wl_against_fp64_oracle():
    csr = CSRMatrix.from_coo(syn.fem_3d(10, 10, 10, dof=3, seed=0))
    psell = PanelSellMatrix.from_csr(csr, max_panel_cols=1024)
    assert {b.layout for p in psell.panels for b in p.bins} == {
        "k-major", "wl"}
    x = _x(csr.ncols, seed=4)
    dps = D.device_put_sell_dd(psell, device="cpu")
    y = D.sell_spmv_dd_f64(dps, torch.from_numpy(x)).numpy()
    assert _norm_err(y, csr.spmv(x)) < ORACLE_REL
    assert np.array_equal(y, dd.combine_f64(*D.panel_sell_spmv_dd_plain(
        dps, *(torch.from_numpy(h) for h in dd.split_f64(x)))).numpy())


def test_dd_beats_f32():
    """Mirrors tests/test_doubledouble.py:85-139 on a random 3000 x 2500
    matrix at 1%: the dd result is fp64-class and 1e3 closer to the oracle
    than the f32 SpMV of the same SELL."""
    csr = CSRMatrix.from_coo(syn.random_general(3000, 2500, 0.01, seed=7))
    sell = SellMatrix.from_csr(csr)
    x = _x(csr.ncols)
    y_ref = csr.spmv(x)
    nz = y_ref != 0
    y_dd = D.sell_spmv_dd_f64(D.device_put_sell_dd(sell, device="cpu"),
                              torch.from_numpy(x)).numpy()
    y32 = S.sell_spmv(S.device_put_sell(sell, device="cpu"),
                      S.device_put_x(x, csr.ncols, device="cpu")).numpy()
    rel = lambda y: np.abs(y - y_ref)[nz] / np.abs(y_ref[nz])  # noqa: E731
    assert rel(y_dd).max() < 1e-10
    assert _norm_err(y_dd, y_ref) < ORACLE_REL
    assert rel(y_dd).max() < 1e-3 * rel(y32).max()


@pytest.mark.parametrize("layout", ["k-major", "wl", "sb-major", "sb-list",
                                    "sg"])
def test_dd_exact_on_cancelling_rows(layout):
    """Rows whose products cancel to about 1e-7 of their terms, on values
    where every product and partial sum is exact in dd: the plain dd
    versions return the fp64 oracle exactly, f32 misses by about |y|."""
    coo, x = syn.cancelling_pairs(5 * 1024, seed=0)
    csr = CSRMatrix.from_coo(coo)
    sell = SellMatrix.from_csr(csr, layout=layout, sg_slots=False)
    assert {b.layout for b in sell.bins} == {layout}
    y_ref = csr.spmv(x)
    y_dd = D.sell_spmv_dd_f64(D.device_put_sell_dd(sell, device="cpu"),
                              torch.from_numpy(x)).numpy()
    y32 = S.sell_spmv(S.device_put_sell(sell, device="cpu"),
                      S.device_put_x(x, csr.ncols, device="cpu")).numpy()
    assert np.array_equal(y_dd, y_ref)
    assert np.abs(y32 - y_ref).max() >= 1e-6 * np.abs(y_ref).max()


def test_sg_slots_bin_is_accepted():
    """A slot-packed sg bin uploads in dd (one plane of (hi, lo) pairs) and
    its plain version, which sums each sigma row's slots in dd, returns the
    fp64 oracle's y."""
    csr = CSRMatrix.from_coo(syn.road_network(8000, seed=5)).split_heavy_rows(
        256)[0]
    sell = SellMatrix.from_csr(csr, layout="sg")
    assert any(b.sg_slots for b in sell.bins)
    d = D.device_put_sell_dd(sell, device="cpu")
    for b in d.bins:
        assert (b.as_pair is None) == (b.layout == "k-major")
    x = _x(csr.ncols, seed=9)
    y = D.sell_spmv_dd_f64(d, torch.from_numpy(x)).numpy()
    assert _norm_err(y, csr.spmv(x)) < ORACLE_REL


def test_dd_wrappers_on_cpu_count_nothing_and_check_inputs():
    csr = CSRMatrix.from_coo(syn.banded(2048, 8, 64))
    sell = SellMatrix.from_csr(csr)
    d = D.device_put_sell_dd(sell, device="cpu")
    dps = D.device_put_sell_dd(PanelSellMatrix.from_csr(
        csr, max_panel_cols=1024), device="cpu")
    th, tl = D.device_put_x_dd(np.ones(2048), 2048, device="cpu")
    before = {k: (w.launches, w.accumulating)
              for k, w in D._KERNEL_DD.items()}
    D.sell_spmv_dd(d, th, tl)
    assert before == {k: (w.launches, w.accumulating)
                      for k, w in D._KERNEL_DD.items()}
    with pytest.raises(TypeError, match="panel_sell_spmv_dd"):
        D.sell_spmv_dd(dps, th, tl)
    with pytest.raises(TypeError, match="DevicePanelSellDD"):
        D.panel_sell_spmv_dd(d, torch.ones(2048), torch.ones(2048))
    with pytest.raises(ValueError, match="padded f32 table"):
        D.sell_spmv_dd(d, th.double(), tl)
    with pytest.raises(ValueError, match="f32 vector of 2048"):
        D.panel_sell_spmv_dd(dps, torch.ones(2048), torch.ones(7))


# ---- the fp64 entry's x split and y join ----

F32_MAX = float(np.finfo(np.float32).max)
# signed zeros, subnormals of both widths, values that round to f32's
# largest and past it, infinities, and halves that do not fit one f32
SPECIAL = np.array([0.0, -0.0, 5e-324, -1e-310, 1e-45, -3e-39, F32_MAX,
                    F32_MAX * (1 + 2.0**-26), 3.5e38, -1e300, np.inf,
                    -np.inf, 1 / 3, -2 / 3, 1 + 2.0**-30])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int64)


def _x64(n: int, seed: int = 3) -> torch.Tensor:
    x = _x(n, seed)
    x[: min(n, SPECIAL.size)] = SPECIAL[:n]
    return torch.from_numpy(x)


@pytest.mark.parametrize("ncols", [1, 300, 1000])
def test_prepare_x_plain_is_the_split_it_replaces(ncols):
    """dd_prepare_x_plain (and dd_prepare_x on CPU tensors) gives the bits
    of the ops it replaces, ``x.float()``, ``(x - hi.double()).float()``,
    ``pack_x_table`` of each half and ``pack_x_pair``, for each choice of
    outputs, pad slots +0; the halves are the JAX package's split."""
    x = _x64(ncols)
    rows = S.slab_table_rows(ncols) * 128
    xh = x.float()
    xl = (x - xh.double()).float()
    th, tl = S.pack_x_table(xh, ncols), S.pack_x_table(xl, ncols)
    want = (D.pack_x_pair(th, tl), th, tl)
    with np.errstate(over="ignore", invalid="ignore"):  # inf halves
        jh, jl = jdd.split_f64(x.numpy())
    assert np.array_equal(_bits(th[:ncols]).numpy(), jh.view(np.int32))
    assert np.array_equal(_bits(tl[:ncols]).numpy(), jl.view(np.int32))
    assert not _bits(th[ncols:]).any() and not _bits(tl[ncols:]).any()
    before = D.dd_prepare_x.launches
    for pair in (True, False):
        for halves in (True, False):
            for got in (D.dd_prepare_x_plain(x, rows, pair, halves),
                        D.dd_prepare_x(x, rows, pair=pair, halves=halves)):
                for g, w, asked in zip(got, want, (pair, halves, halves)):
                    assert (g is None) != asked
                    assert g is None or torch.equal(_bits(g), _bits(w))
    assert D.dd_prepare_x.launches == before


def test_join_y_plain_is_combine_f64():
    rng = np.random.default_rng(5)
    with np.errstate(over="ignore"):
        yh = torch.from_numpy(np.concatenate([
            SPECIAL, rng.standard_normal(2000)]).astype(np.float32))
        yl = torch.from_numpy((np.concatenate([
            -SPECIAL[::-1], rng.standard_normal(2000)]) * 2.0**-30)
            .astype(np.float32))
    want = dd.combine_f64(yh, yl)
    before = D.dd_join_y.launches
    for got in (D.dd_join_y_plain(yh, yl), D.dd_join_y(yh, yl)):
        assert got.dtype == torch.float64
        assert torch.equal(_bits(got), _bits(want))
    assert D.dd_join_y.launches == before


# plan kind -> (CSR, its host SELL, what the split writes: pair table,
# halves)
SPLITS = {
    "pairs": (lambda: syn.banded(2048, 12, 200, seed=1),
              lambda c: SellMatrix.from_csr(c, layout="sb-list"),
              (True, False)),
    "k-major": (lambda: syn.banded(2048, 12, 200, seed=1),
                lambda c: SellMatrix.from_csr(c, layout="k-major"),
                (False, True)),
    "mixed": (lambda: syn.fem_3d(8, 8, 8, dof=3, seed=0),
              SellMatrix.from_csr, (True, True)),
    "panels": (lambda: syn.random_general(3000, 5000, 0.002, seed=3),
               lambda c: PanelSellMatrix.from_csr(c, max_panel_cols=2048),
               (False, True)),
}


@pytest.mark.parametrize("kind", sorted(SPLITS))
def test_f64_entry_splits_x_as_its_plan_reads(kind):
    """sell_spmv_dd_f64 writes the x tables its plan's bins read (pair
    bins: the pair table, whose columns stand in for the halves; other
    bins: the padded halves; column panels: the unpadded halves) and
    returns the plain assembly's y on the usual split, bit for bit, with
    no launch counted on CPU tensors."""
    coo, to_sell, (pair, halves) = SPLITS[kind]
    csr = CSRMatrix.from_coo(coo())
    d = D.device_put_sell_dd(to_sell(csr), device="cpu")
    x = _x64(csr.ncols, seed=6)
    x[: SPECIAL.size][~(np.abs(SPECIAL) < 1e30)] = 0.0  # a finite y
    plan = None if kind == "panels" else D._plan_of(d)
    x_pair, xh, xl = D._split_x(d, x, plan)
    assert (x_pair is not None) == pair
    if kind == "panels":
        want = dd.combine_f64(*D.panel_sell_spmv_dd_plain(
            d, *(torch.from_numpy(h) for h in dd.split_f64(x.numpy()))))
        assert xh.shape == xl.shape == (csr.ncols,)
    else:
        want = dd.combine_f64(*D.sell_spmv_dd_plain(
            d, *D.device_put_x_dd(x.numpy(), csr.ncols, device="cpu")))
        assert xh.is_contiguous() == halves
        if not halves:  # the pair table's columns
            assert xh.data_ptr() == x_pair.data_ptr()
    before = (D.dd_prepare_x.launches, D.dd_join_y.launches)
    y = D.sell_spmv_dd_f64(d, x)
    assert (D.dd_prepare_x.launches, D.dd_join_y.launches) == before
    assert torch.equal(_bits(y), _bits(want))
    assert _norm_err(y.numpy(), csr.spmv(x.numpy())) < ORACLE_REL
    if plan is not None:  # the choice is kept on the plan it was read from
        assert D._plan_of(d) is plan and plan.dd_x == (pair, halves)


@functools.lru_cache(maxsize=None)
def _split_container(kind):
    coo, to_sell, _ = SPLITS[kind]
    return D.device_put_sell_dd(to_sell(CSRMatrix.from_coo(coo())),
                                device="cpu")


@pytest.mark.parametrize("kind", ["mixed", "panels"])
@pytest.mark.parametrize("bad", ["short", "long", "f32", "strided"])
def test_f64_entry_refuses_another_x(kind, bad):
    """sell_spmv_dd_f64 takes ``d.ncols`` contiguous fp64 entries, flat or
    in column panels, on every device: a short x is refused, not padded
    with zeros into a wrong y."""
    d = _split_container(kind)
    n = d.ncols
    x = {"short": lambda: torch.ones(n - 1, dtype=torch.float64),
         "long": lambda: torch.ones(n + 1, dtype=torch.float64),
         "f32": lambda: torch.ones(n),
         "strided": lambda: torch.ones(2 * n, dtype=torch.float64)[::2]}[
             bad]()
    with pytest.raises(ValueError, match=f"contiguous fp64 vector of {n} "):
        D.sell_spmv_dd_f64(d, x)
    y = D.sell_spmv_dd_f64(d, torch.ones(n, dtype=torch.float64))
    assert y.shape == (d.nrows,)


# ---- run_matrix's sell_dd stage ----

RUN_MATRIX = {
    # short rows: 16-entry segments reduced back in f64 on the host
    "entry_banded": lambda: syn.banded(8192, 24, 512, seed=0),
    # slot-packed sg bins: the dd stage runs the same SELL
    "uniform_sg_slots": lambda: syn.random_general(20000, 20000, 2.5e-4,
                                                   seed=8),
    # SELL-sigma fallback: kernel rows map back through row_perm
    "power_law_sigma": lambda: syn.power_law(4000, 2, seed=6),
}


@pytest.mark.parametrize("matrix", sorted(RUN_MATRIX))
def test_run_matrix_sell_dd_stage(matrix):
    coo = RUN_MATRIX[matrix]()
    logs = []
    res = run_matrix(matrix, coo, BenchConfig(iterations=1, skip=0),
                     x=_x(coo.ncols, seed=3), log=logs.append, device="cpu")
    st = res.stages["sell_dd"]
    assert st.diff.significant_diffs == 0
    # an f32 segment sum or f32 join would leave ~1e-7
    assert st.norm_err < ORACLE_REL
    assert st.seconds > 0 and st.gflops > 0
    assert res.sell_dd is res.sell
    assert not any("rows-mode" in m for m in logs)
    assert "convert_sell_dd_s" not in res.format_stats
    if matrix == "entry_banded":
        assert res.format_stats["heavy_row_segments"] > 0
    if matrix == "uniform_sg_slots":
        assert any(b.sg_slots for b in res.sell.bins)
        assert {b.layout for b in res.sell_dd.bins} >= {"sg"}
    if matrix == "power_law_sigma":
        assert res.sell_dd.row_perm is not None
