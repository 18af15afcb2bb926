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
        # the hi/lo planes are the JAX split of the same bin, and the index
        # planes the JAX upload's (which may append padding groups)
        hi, lo = jdd.split_f64(np.asarray(h.as_, np.float64))
        assert np.array_equal(b.as_hi.numpy(), hi)
        assert np.array_equal(b.as_lo.numpy(), lo)
        n = b.as_hi.shape[0]
        assert np.array_equal(b.as_hi.numpy(), np.asarray(jb.as_hi)[:n])
        assert np.array_equal(b.as_lo.numpy(), np.asarray(jb.as_lo)[:n])
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


# ---- the port's own: oracle, f32, refusals, f64 entry point ----


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


def test_sg_slots_bin_is_refused():
    csr = CSRMatrix.from_coo(syn.road_network(8000, seed=5))
    sell = SellMatrix.from_csr(csr.split_heavy_rows(256)[0], layout="sg")
    assert any(b.sg_slots for b in sell.bins)
    with pytest.raises(ValueError, match="row-unique sg positions"):
        D.device_put_sell_dd(sell, device="cpu")


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


# ---- run_matrix's sell_dd stage ----

RUN_MATRIX = {
    # short rows: 16-entry segments reduced back in f64 on the host
    "entry_banded": lambda: syn.banded(8192, 24, 512, seed=0),
    # slot-packed sg bins: rebuilt in rows mode for the stage
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
    assert not any(b.sg_slots for b in res.sell_dd.bins)
    if matrix == "entry_banded":
        assert res.format_stats["heavy_row_segments"] > 0
    if matrix == "uniform_sg_slots":
        assert any(b.sg_slots for b in res.sell.bins)
        assert {b.layout for b in res.sell_dd.bins} >= {"sg"}
        assert res.format_stats["convert_sell_dd_s"] > 0
        assert any("rows-mode SELL for sell_dd" in m for m in logs)
    else:
        assert res.sell_dd is res.sell
    if matrix == "power_law_sigma":
        assert res.sell_dd.row_perm is not None
