"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false. Run on a GPU machine with ``python -m pytest tests/test_torch_cuda.py``.
Tolerance: rtol=1e-5, atol=1e-5*max|y| (f32 sums in another order); the
double-double kernels 1e-12*max|y| on the fp64-combined result (dd sums in
another order), and exact on rows whose terms cancel; the k-major (split
over lanes or not), k-major SpMM, wl, sb-list and sg kernels bit for bit
against their plain versions, which add in the kernels' order, the
compacted dd k-major kernel also against the padded layout's result
(``k_major_padded_plain_dd``), and the compacted sg kernel within f32
rounding of the padded layout's sums. Every
SELL kernel follows the stored-zero rule: a stored zero with x infinite at
its column leaves every row finite and equal to the fp64 oracle without it
(f32: rtol=1e-5, atol=1e-5*max|y|; dd: 1e-12*max|y|). The PR kernels are
also held to the fp64 oracle at the JAX tests' ``max|Δ| / max(1, |ref|) <
5e-6`` (f32) and 1e-12*max|y| (dd). The SpMM kernels: rtol=1e-5,
atol=1e-5*max|Y| against their plain versions in both value types (the
plain versions widen bf16 exactly as the kernels do, so only the order of
the f32 sums differs), the SELL SpMM columns equal to the SpMV kernel bit
for bit, and f32 BSR within 1e-5*max|Y| of the fp64 oracle; the wl SpMM
kernel bit for bit against its plain version also on the raw X, and with x
infinite or NaN where the planes' tail slots point. The solvers
over the kernels: CG and multi-RHS CG on the card in as many iterations as
the same solve on the CPU's plain versions and at the f32 tolerance above of
it, each launching the kernels of its container and never a plain version;
CG over the dd kernels within 1e-10*max|x| of CG over the fp64 CSR
container, in as many iterations. CG's fused kernels (``ops/cg_step.py``)
against the eager loop on the card: the same iteration count, x within the
f32 tolerance above (f64: 1e-12*max|x|), the residual norm within 1e-2
(f64: 1e-6) relative (its sums run in another order), and a repeated solve
bit for bit the same; a solve right after one that left with its last flag
unread (at ``maxiter``, or on a matvec's exception) reads its own flag. The
multi-device layer: 4 gloo ranks
sharing the card launch the kernels of every sharded path and equal 4 CPU
ranks' plain versions at the f32 tolerance; one NCCL rank per card and
``shard_sell_rows`` on ``[cuda:0] * 4`` within it of the oracle. The dd
entry's x split and y join kernels (``dd_prepare_x``, ``dd_join_y``) bit
for bit against their plain versions (NaN payloads aside), and
``sell_spmv_dd_f64`` bit for bit against the PyTorch ops they replaced.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu_torch import (
    BSRMatrix,
    COOMatrix,
    CSRMatrix,
    PanelPRMatrix,
    PanelSellMatrix,
    PRMatrix,
    SellMatrix,
    SplitMatrix,
    pr_from_csr,
    run_matrix,
)
from sparsematrixvectormultiplication_tpu_torch import solvers as SV
from sparsematrixvectormultiplication_tpu_torch.bench import bw_probe as BW
from sparsematrixvectormultiplication_tpu_torch.bench.harness import (
    BenchConfig,
    flush_hbm,
    quantize_bf16,
)
from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
    banded,
    cancelling_pairs,
    fem_3d,
    power_law,
    random_general,
    road_network,
)
from sparsematrixvectormultiplication_tpu_torch.ops import _build
from sparsematrixvectormultiplication_tpu_torch.ops import bsr as BSR
from sparsematrixvectormultiplication_tpu_torch.ops import pr as PRo
from sparsematrixvectormultiplication_tpu_torch.ops import pr_dd as PRD
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
from sparsematrixvectormultiplication_tpu_torch.ops import sell_spmm as SM
from sparsematrixvectormultiplication_tpu_torch.ops import split as SPL
from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
    combine_f64,
    dd_add_dd,
)
from sparsematrixvectormultiplication_tpu_torch.ops.xla import device_put_csr
from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
    device_time_fn,
    time_fn,
)

pytestmark = pytest.mark.cuda

WRAPPERS = {"k-major": (S.k_major_bin, S.k_major_bin_plain),
            "wl": (S.wl_bin, S.wl_bin_plain),
            "sb-major": (S.sb_major_bin, S.sb_major_bin_plain),
            "sb-list": (S.sb_list_bin, S.sb_list_bin_plain),
            "sg": (S.sg_bin, S.sg_bin_plain)}
# 5 k-major / sb groups and 17 + 6 wl groups: odd group counts
MATRICES = {"k-major": lambda: banded(5 * 1024, 24, 512, seed=0),
            "wl": lambda: fem_3d(20, 20, 20, dof=3, seed=1),
            "sb-major": lambda: banded(5 * 1024, 24, 512, seed=0),
            "sb-list": lambda: banded(5 * 1024, 24, 512, seed=0),
            "sg": lambda: road_network(20_000, seed=5)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", sorted(WRAPPERS))
def test_kernel_matches_plain(layout, dtype, dev):
    csr = CSRMatrix.from_coo(MATRICES[layout]())
    sell = SellMatrix.from_csr(csr, layout=layout)
    d = S.device_put_sell(sell, dtype, device=dev)
    x = np.random.default_rng(1).standard_normal(csr.ncols)
    x_tab = S.device_put_x(x, csr.ncols, device=dev)
    kernel, plain = WRAPPERS[layout]
    bins = [b for b in d.bins if b.layout == layout]
    assert bins and (layout == "sg" or any(b.n_groups % 2 for b in bins))
    for b in bins:
        y = torch.full((d.num_groups * 1024,), float("nan"), device=dev)
        before = kernel.launches
        kernel(b, x_tab, y)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        got = y.view(-1, 8, 128)[b.group_ids.long()]
        _close(got, plain(b, x_tab))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_matches_plain_and_oracle(dtype, dev):
    csr = CSRMatrix.from_coo(fem_3d(20, 20, 20, dof=3, seed=1))
    sell = SellMatrix.from_csr(csr)
    assert {b.layout for b in sell.bins} == {"k-major", "wl"}
    x = np.random.default_rng(2).standard_normal(csr.ncols)
    d = S.device_put_sell(sell, dtype, device=dev)
    x_tab = S.device_put_x(x, csr.ncols, device=dev)
    y = S.sell_spmv(d, x_tab)
    _close(y, S.sell_spmv_plain(d, x_tab))


# variant -> (matrix, SellMatrix.from_csr keywords, device_put_sell keywords)
VARIANTS = {
    "sb-major-i16": (lambda: banded(5 * 1024, 24, 512, seed=0),
                     {"layout": "sb-major"}, {"sb_i16": True}),
    "sb-list-i16": (lambda: banded(5 * 1024, 24, 512, seed=0),
                    {"layout": "sb-list"}, {"sb_i16": True}),
    "sg-rows": (lambda: road_network(20_000, seed=5),
                {"layout": "sg", "sg_slots": False}, {}),
    "road-auto": (lambda: road_network(20_000, seed=5), {}, {}),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kernel_variant_matches_plain(variant, dtype, dev):
    """int16 sb planes, sg rows mode, and every bin of a mixed conversion
    both storing and accumulating onto a y that already holds values."""
    make, sell_kw, put_kw = VARIANTS[variant]
    csr = CSRMatrix.from_coo(make())
    d = S.device_put_sell(SellMatrix.from_csr(csr, **sell_kw), dtype,
                          device=dev, **put_kw)
    if put_kw:
        assert all(b.ja.dtype == torch.int16 for b in d.bins)
    x_tab = S.device_put_x(np.random.default_rng(4).standard_normal(
        csr.ncols), csr.ncols, device=dev)
    y0 = torch.randn(d.num_groups * 1024, device=dev)
    for b in d.bins:
        kernel, plain = WRAPPERS[b.layout]
        want = plain(b, x_tab)
        for accumulate in (False, True):
            y = y0.clone()
            before = (kernel.launches, kernel.accumulating)
            kernel(b, x_tab, y, accumulate=accumulate)
            torch.cuda.synchronize()
            assert (kernel.launches, kernel.accumulating) == (
                before[0] + 1, before[1] + accumulate)
            got = y.view(-1, 8, 128)[b.group_ids.long()]
            base = y0.view(-1, 8, 128)[b.group_ids.long()]
            _close(got - base if accumulate else got, want)
    _close(S.sell_spmv(d, x_tab), S.sell_spmv_plain(d, x_tab))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_panel_spmv_matches_plain(dtype, dev):
    csr = CSRMatrix.from_coo(fem_3d(10, 10, 10, dof=3, seed=0))
    dps = S.device_put_sell(PanelSellMatrix.from_csr(csr, max_panel_cols=1024),
                            dtype, device=dev)
    x = torch.randn(csr.ncols, device=dev)
    before = (S.wl_bin.launches, S.panel_reduce.launches)
    # the joint k-major and wl launches and panel_reduce, bit for bit
    assert torch.equal(S.panel_sell_spmv(dps, x),
                       S.panel_sell_spmv_plain(dps, x))
    assert S.wl_bin.launches > before[0]
    assert S.panel_reduce.launches == before[1] + 1


def test_run_matrix_on_cuda(dev):
    coo = fem_3d(20, 20, 20, dof=3, seed=1)
    before = (S.k_major_bin.launches, S.wl_bin.launches)
    res = run_matrix("fem20", coo, BenchConfig(iterations=3, skip=1),
                     x=np.random.default_rng(3).standard_normal(coo.ncols),
                     log=lambda m: None, device=dev)
    for name in ("sell", "sell_bf16", "sell_dd"):
        assert res.stages[name].diff.significant_diffs == 0, name
    assert res.stages["sell_dd"].norm_err < 1e-12
    assert S.k_major_bin.launches > before[0]
    assert S.wl_bin.launches > before[1]


def test_kernel_rejects_mixed_devices(dev):
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(banded(2048, 8, 64)))
    b = S.device_put_sell(sell, device="cpu").bins[0]
    x_tab = S.device_put_x(np.ones(sell.ncols), sell.ncols, device=dev)
    y = torch.zeros(sell.num_groups * 1024, device=dev)
    with pytest.raises(ValueError, match="is on cpu"):
        S.k_major_bin(b, x_tab, y)


def test_device_time_is_the_kernels_own(dev):
    """A short kernel's back-to-back device time is positive and below its
    call time, which includes the wrapper's host work."""
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(banded(8192, 16, 512)))
    d = S.device_put_sell(sell, device=dev)
    (b,) = d.bins
    x_tab = S.device_put_x(np.ones(sell.ncols), sell.ncols, device=dev)
    y = torch.zeros(d.num_groups * 1024, device=dev)
    before = S.k_major_bin.launches
    dev_s = device_time_fn(S.k_major_bin, b, x_tab, y, device=dev, reps=10,
                           skip=2)
    timed = S.k_major_bin.launches - before - 2  # 10 per try of the spin
    assert timed > 0 and timed % 10 == 0
    assert 0 < dev_s < time_fn(S.k_major_bin, b, x_tab, y, device=dev)


DD_WRAPPERS = {"k-major": (D.k_major_bin_dd, D.k_major_bin_plain_dd),
               "wl": (D.wl_bin_dd, D.wl_bin_plain_dd),
               "sb-major": (D.sb_major_bin_dd, D.sb_major_bin_plain_dd),
               "sb-list": (D.sb_list_bin_dd, D.sb_list_bin_plain_dd),
               "sg": (D.sg_bin_dd, D.sg_bin_plain_dd)}
# variant -> (matrix, SellMatrix.from_csr keywords, device_put_sell_dd
# keywords)
DD_VARIANTS = {
    "k-major": (lambda: banded(5 * 1024, 24, 512, seed=0),
                {"layout": "k-major"}, {}),
    "wl": (lambda: fem_3d(20, 20, 20, dof=3, seed=1), {}, {}),
    "sb-major": (lambda: banded(5 * 1024, 24, 512, seed=0),
                 {"layout": "sb-major"}, {}),
    "sb-list": (lambda: banded(5 * 1024, 24, 512, seed=0),
                {"layout": "sb-list"}, {}),
    "sb-major-i16": (lambda: banded(5 * 1024, 24, 512, seed=0),
                     {"layout": "sb-major"}, {"sb_i16": True}),
    "sb-list-i16": (lambda: banded(5 * 1024, 24, 512, seed=0),
                    {"layout": "sb-list"}, {"sb_i16": True}),
    "sg-rows": (lambda: road_network(20_000, seed=5),
                {"layout": "sg", "sg_slots": False}, {}),
}


def _dd_close(got, want):
    got, want = combine_f64(*got), combine_f64(*want)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("variant", sorted(DD_VARIANTS))
def test_dd_kernel_matches_plain(variant, dev):
    """Every bin through its dd kernel, storing and dd-adding onto a y pair
    that already holds values, against its plain dd version; then the whole
    dd SpMV against its plain assembly."""
    make, sell_kw, put_kw = DD_VARIANTS[variant]
    csr = CSRMatrix.from_coo(make())
    d = D.device_put_sell_dd(SellMatrix.from_csr(csr, **sell_kw), device=dev,
                             **put_kw)
    if put_kw:
        assert all(b.ja.dtype == torch.int16 for b in d.bins)
    xh, xl = D.device_put_x_dd(np.random.default_rng(4).standard_normal(
        csr.ncols), csr.ncols, device=dev)
    n = d.num_groups * 1024
    y0h = torch.randn(n, device=dev)
    y0l = y0h * 2.0**-30
    for b in d.bins:
        kernel, plain = DD_WRAPPERS[b.layout]
        want = plain(b, xh, xl)
        rows = b.group_ids.long()
        for accumulate in (False, True):
            yh, yl = y0h.clone(), y0l.clone()
            before = (kernel.launches, kernel.accumulating)
            kernel(b, xh, xl, yh, yl, accumulate=accumulate)
            torch.cuda.synchronize()
            assert (kernel.launches, kernel.accumulating) == (
                before[0] + 1, before[1] + accumulate)
            got = (yh.view(-1, 8, 128)[rows], yl.view(-1, 8, 128)[rows])
            if accumulate:
                _dd_close(got, dd_add_dd(y0h.view(-1, 8, 128)[rows],
                                         y0l.view(-1, 8, 128)[rows], *want))
            else:
                _dd_close(got, want)
    _dd_close(D.sell_spmv_dd(d, xh, xl), D.sell_spmv_dd_plain(d, xh, xl))


def test_dd_panel_spmv_matches_plain(dev):
    csr = CSRMatrix.from_coo(fem_3d(10, 10, 10, dof=3, seed=0))
    dps = D.device_put_sell_dd(
        PanelSellMatrix.from_csr(csr, max_panel_cols=1024), device=dev)
    x = torch.randn(csr.ncols, dtype=torch.float64, device=dev)
    xh = x.float()
    xl = (x - xh.double()).float()
    before = (D.wl_bin_dd.launches, D.panel_reduce_dd.launches)
    for got, want in zip(D.panel_sell_spmv_dd(dps, xh, xl),
                         D.panel_sell_spmv_dd_plain(dps, xh, xl)):
        assert torch.equal(got, want)
    assert D.wl_bin_dd.launches > before[0]
    assert D.panel_reduce_dd.launches == before[1] + 1
    y = D.sell_spmv_dd_f64(dps, x).cpu().numpy()
    y_ref = csr.spmv(x.cpu().numpy())
    assert np.abs(y - y_ref).max() < 1e-12 * np.abs(y_ref).max()


@pytest.mark.parametrize("layout", sorted(DD_WRAPPERS))
def test_dd_kernel_exact_where_f32_cancels(layout, dev):
    """Rows whose products cancel to about 1e-7 of their terms, on values
    and x where every product and sum is exact in dd and in fp64: the dd
    kernel must return the fp64 oracle to 1e-12*max|y|, while the f32 kernel
    misses by at least 1e-6*max|y|. A multiply-add that nvcc contracted
    inside an error-free transform, or a transform folded away, fails it."""
    coo, x = cancelling_pairs(5 * 1024, seed=0)
    csr = CSRMatrix.from_coo(coo)
    sell = SellMatrix.from_csr(csr, layout=layout, sg_slots=False)
    assert {b.layout for b in sell.bins} == {layout}
    y_ref = csr.spmv(x)
    scale = np.abs(y_ref).max()
    before = DD_WRAPPERS[layout][0].launches
    y_dd = D.sell_spmv_dd_f64(D.device_put_sell_dd(sell, device=dev),
                              torch.from_numpy(x).to(dev)).cpu().numpy()
    assert DD_WRAPPERS[layout][0].launches > before
    y32 = S.sell_spmv(S.device_put_sell(sell, device=dev),
                      S.device_put_x(x, csr.ncols, device=dev)).cpu().numpy()
    assert np.abs(y_dd - y_ref).max() < 1e-12 * scale
    assert np.abs(y32 - y_ref).max() >= 1e-6 * scale


# ---- the compacted wl kernels and the split sg kernels, bit for bit ----

# matrix -> (generator, SellMatrix.from_csr keywords); each has wl bins
WL_MATRICES = {"fem": (lambda: fem_3d(20, 20, 20, dof=3, seed=1), {}),
               "banded": (lambda: banded(5 * 1024, 18, 40, seed=2),
                          {"layout": "wl"})}
PRECISIONS = ("f32", "bf16", "dd")


def _upload(sell, precision, dev, sb_i16=False):
    if precision == "dd":
        return D.device_put_sell_dd(sell, device=dev, sb_i16=sb_i16)
    return S.device_put_sell(sell, torch.bfloat16 if precision == "bf16"
                             else torch.float32, device=dev, sb_i16=sb_i16)


def _equal_storing_and_adding(b, precision, kernel, plain, x, dev, **kw):
    """Bin ``b`` through ``kernel`` (storing, then adding onto a y that
    holds values) equals ``plain(b, *x)`` bit for bit; returns the stored
    rows."""
    n = (int(b.group_ids.max()) + 1) * 1024
    want = plain(b, *x, **kw)
    want = want if precision == "dd" else (want,)
    rows = b.group_ids.long()
    y0 = [torch.randn(n, device=dev)]
    if precision == "dd":
        y0.append(y0[0] * 2.0**-30)
    stored = None
    for accumulate in (False, True):
        y = [t.clone() for t in y0]
        before = (kernel.launches, kernel.accumulating)
        kernel(b, *x, *y, accumulate=accumulate)
        torch.cuda.synchronize()
        assert (kernel.launches, kernel.accumulating) == (
            before[0] + 1, before[1] + accumulate)
        got = [t.view(-1, 8, 128)[rows] for t in y]
        exp = list(want)
        if accumulate:
            base = [t.view(-1, 8, 128)[rows] for t in y0]
            exp = list(dd_add_dd(*base, *want)) if precision == "dd" \
                else [base[0] + want[0]]
        else:
            stored = got
        for g, e in zip(got, exp):
            assert torch.equal(g, e), (accumulate,
                                       (g - e).abs().max().item())
    return stored


def _x_for(csr, precision, dev, seed=4):
    x = np.random.default_rng(seed).standard_normal(csr.ncols)
    if precision == "dd":
        return D.device_put_x_dd(x, csr.ncols, device=dev)
    return (S.device_put_x(x, csr.ncols, device=dev),)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("matrix", sorted(WL_MATRICES))
def test_wl_kernel_equals_plain_bit_for_bit(matrix, precision, dev):
    """The compacted wl kernel (f32, bf16, dd) against its plain version,
    which adds each row's slots in the kernel's order and rounding."""
    make, kw = WL_MATRICES[matrix]
    csr = CSRMatrix.from_coo(make())
    d = _upload(SellMatrix.from_csr(csr, **kw), precision, dev)
    kernel, plain = ((D.wl_bin_dd, D.wl_bin_plain_dd) if precision == "dd"
                     else (S.wl_bin, S.wl_bin_plain))
    x = _x_for(csr, precision, dev)
    bins = [b for b in d.bins if b.layout == "wl"]
    assert bins
    for b in bins:
        _equal_storing_and_adding(b, precision, kernel, plain, x, dev)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_wl_kernel_equals_the_padded_result(precision, dev):
    """On finite x the compacted kernel returns what the padded layout's
    kernel returned (``wl_padded_plain``: every slot, pads included, in the
    order (w, l, s)), bit for bit: a pad only added an exact zero."""
    csr = CSRMatrix.from_coo(fem_3d(20, 20, 20, dof=3, seed=1))
    sell = SellMatrix.from_csr(csr)
    d = _upload(sell, precision, dev)
    x = _x_for(csr, precision, dev, seed=6)
    pairs = [(h, b) for h, b in zip(sell.bins, d.bins) if h.layout == "wl"]
    assert pairs
    for h, b in pairs:
        assert b.ja.numel() < h.ja.size  # pad slots were dropped
        y = [torch.zeros(d.num_groups * 1024, device=dev)
             for _ in range(2 if precision == "dd" else 1)]
        if precision == "dd":
            D.wl_bin_dd(b, *x, *y)
            want = D.wl_padded_plain_dd(h, *x)
        else:
            S.wl_bin(b, *x, *y)
            want = (S.wl_padded_plain(h, x[0], torch.bfloat16
                                      if precision == "bf16"
                                      else torch.float32),)
        rows = b.group_ids.long()
        for got, exp in zip(y, want):
            assert torch.equal(got.view(-1, 8, 128)[rows], exp)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("mode", ["slots", "rows"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_sg_kernel_equals_plain_bit_for_bit(precision, mode, split, dev,
                                            monkeypatch):
    """The sg kernel in both modes, against its plain version, which sums
    in the kernel's order: storing, and adding onto y once. dd: the tile
    kernel, its groups' tiles split into chunks (joined by a second launch)
    or not; f32 and bf16: the row-list kernel on the compacted planes,
    whatever the split would be."""
    monkeypatch.setattr(S, "_SG_MIN_CHUNK", 2)
    if not split:
        monkeypatch.setattr(S, "_SG_SPLIT_BELOW", 0)
    csr = CSRMatrix.from_coo(road_network(20_000, seed=5))
    sell = SellMatrix.from_csr(csr, layout="sg", sg_slots=mode == "slots")
    d = _upload(sell, precision, dev)
    kernel, plain = ((D.sg_bin_dd, D.sg_bin_plain_dd) if precision == "dd"
                     else (S.sg_bin, S.sg_bin_plain))
    x = _x_for(csr, precision, dev)
    bins = [b for b in d.bins if b.layout == "sg"]
    assert bins and {b.sg_slots for b in bins} == {mode == "slots"}
    assert {S._sg_chunks(b) > 1 for b in bins} == {split}
    for b in bins:
        _equal_storing_and_adding(b, precision, kernel, plain, x, dev)
    if precision == "bf16":
        return
    y = combine_f64(*D.sell_spmv_dd(d, *x)) if precision == "dd" \
        else S.sell_spmv(d, *x).double()
    ref = torch.from_numpy(csr.spmv(np.random.default_rng(4).standard_normal(
        csr.ncols))).to(dev)
    tol = 1e-12 if precision == "dd" else 1e-5
    assert (y - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize("mode", ["slots", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compacted_sg_kernel_equals_the_padded_result(dtype, mode, dev):
    """On finite x the compacted sg kernel returns the padded layout's sums
    (``sg_padded_plain``) within f32 rounding: the same products in another
    order."""
    csr = CSRMatrix.from_coo(random_general(20000, 20000, 2.5e-4, seed=8))
    sell = SellMatrix.from_csr(csr, layout="sg", sg_slots=mode == "slots")
    d = S.device_put_sell(sell, dtype, device=dev)
    x = S.device_put_x(np.random.default_rng(3).standard_normal(csr.ncols),
                       csr.ncols, device=dev)
    pairs = [(h, b) for h, b in zip(sell.bins, d.bins) if h.layout == "sg"]
    assert pairs
    for h, b in pairs:
        assert b.row_table is not None and b.ja.numel() < np.size(h.ja)
        y = torch.zeros(d.num_groups * 1024, device=dev)
        S.sg_bin(b, x, y)
        _close(y.view(-1, 8, 128)[b.group_ids.long()],
               S.sg_padded_plain(h, x, dtype))


# split -> matrix: a 5-group bin splits its rows over lanes, a 40-group one
# runs a thread a row
K_MAJOR_SPLITS = {"split": lambda: banded(5 * 1024, 24, 512, seed=0),
                  "unsplit": lambda: banded(40 * 1024, 24, 512, seed=0)}


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("split", sorted(K_MAJOR_SPLITS))
def test_k_major_kernel_equals_plain_bit_for_bit(split, precision, dev):
    """The k-major kernel, its rows split over lanes (5 groups) or not (40
    groups), against its plain version, which sums each lane's slots in
    order and joins the lanes in the kernel's tree: storing, and adding."""
    csr = CSRMatrix.from_coo(K_MAJOR_SPLITS[split]())
    d = _upload(SellMatrix.from_csr(csr, layout="k-major"), precision, dev)
    kernel, plain = ((D.k_major_bin_dd, D.k_major_bin_plain_dd)
                     if precision == "dd"
                     else (S.k_major_bin, S.k_major_bin_plain))
    x = _x_for(csr, precision, dev)
    assert d.bins
    for b in d.bins:
        assert (S._k_major_lanes(b) > 1) == (split == "split")
        _equal_storing_and_adding(b, precision, kernel, plain, x, dev)


# matrix -> generator: k-major bins of 33 or more groups, whose rows run one
# lane each, so the dd upload compacts them (band64's shape cut to 40 groups,
# and the demo's SELL dd tier)
KM_LIST = {"band64": lambda: banded(40_000, 64, 64, seed=11),
           "demo": lambda: banded(50_000, 24, 500, seed=0)}


@pytest.mark.parametrize("matrix", sorted(KM_LIST))
def test_compacted_k_major_dd_kernel_bit_for_bit(matrix, dev):
    """The compacted k-major dd kernel against its plain version, storing
    and dd-adding, and against the padded layout's result
    (``k_major_padded_plain_dd``: every slot, pads included, in k order),
    bit for bit."""
    csr = CSRMatrix.from_coo(KM_LIST[matrix]())
    sell = SellMatrix.from_csr(csr, layout="k-major")
    d = D.device_put_sell_dd(sell, device=dev)
    x = _x_for(csr, "dd", dev)
    assert d.bins
    for h, b in zip(sell.bins, d.bins):
        assert S._k_major_lanes(b) == 1 and b.row_table is not None
        assert b.ja.numel() < np.size(h.ja)  # pad slots were dropped
        stored = _equal_storing_and_adding(b, "dd", D.k_major_bin_dd,
                                           D.k_major_bin_plain_dd, x, dev)
        for got, exp in zip(stored, D.k_major_padded_plain_dd(h, *x)):
            assert torch.equal(got, exp)


def test_compacted_k_major_dd_panels(dev):
    """Column panels of compacted k-major dd bins: the bins of both panels
    go out as one joint launch into their slices, and the SpMV equals the
    plain assembly, and each bin on the whole x table its padded layout on
    its panel's own, bit for bit."""
    csr = CSRMatrix.from_coo(random_general(40_000, 40_000, 1.5e-3, seed=3))
    psell = PanelSellMatrix.from_csr(csr, max_panel_cols=20_480,
                                     layout="k-major")
    dps = D.device_put_sell_dd(psell, device=dev)
    bins = [b for p in dps.panels for b in p.bins]
    assert len(dps.panels) == 2 and bins
    assert all(b.row_table is not None for b in bins)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        csr.ncols)).to(dev)
    xh = x.float()
    xl = (x - xh.double()).float()
    before = (D.k_major_bin_dd.launches, D.k_major_bin_dd.accumulating)
    got = D.panel_sell_spmv_dd(dps, xh, xl)
    torch.cuda.synchronize()
    assert len(dps.plan.launches) == 1 < len(bins)
    assert (D.k_major_bin_dd.launches - before[0],
            D.k_major_bin_dd.accumulating - before[1]) == (1, 0)
    for g, w in zip(got, D.panel_sell_spmv_dd_plain(dps, xh, xl)):
        assert torch.equal(g, w)
    whole = (S.panel_x_table(dps, xh), S.panel_x_table(dps, xl))
    for p, (hp, dp) in enumerate(zip(psell.panels, dps.panels)):
        c0, c1 = dps.bounds[p], dps.bounds[p + 1]
        tabs = (S.pack_x_table(xh[c0:c1], c1 - c0),
                S.pack_x_table(xl[c0:c1], c1 - c0))
        for h, b in zip(hp.bins, dp.bins):
            y = [torch.zeros(dps.num_groups * 1024, device=dev)
                 for _ in range(2)]
            D.k_major_bin_dd(b, *whole, *y)
            rows = b.group_ids.long()
            for t, exp in zip(y, D.k_major_padded_plain_dd(h, *tabs)):
                assert torch.equal(t.view(-1, 8, 128)[rows], exp)


def test_compacted_k_major_dd_bin_launches_the_list_entry(dev, monkeypatch):
    """A dd SpMV over compacted k-major bins launches
    ``sell_k_major_dd_list`` once a joint bin, counted on the k-major dd
    wrapper, and never the padded entry."""
    csr = CSRMatrix.from_coo(banded(40_000, 64, 64, seed=11))
    d = D.device_put_sell_dd(SellMatrix.from_csr(csr, layout="k-major"),
                             device=dev)
    xh, xl = D.device_put_x_dd(np.ones(csr.ncols), csr.ncols, device=dev)
    lib = _build.load()
    entry, called = lib.sell_k_major_dd_list, []

    def listed(*args):
        called.append(args)
        return entry(*args)

    def padded(*args):
        raise AssertionError("the padded k-major dd entry was launched")

    monkeypatch.setattr(lib, "sell_k_major_dd_list", listed)
    monkeypatch.setattr(lib, "sell_k_major_dd", padded)
    before = D.k_major_bin_dd.launches
    y = combine_f64(*D.sell_spmv_dd(d, xh, xl))
    torch.cuda.synchronize()
    assert len(called) == len(d.plan.launches) \
        == D.k_major_bin_dd.launches - before
    y_ref = csr.spmv(np.ones(csr.ncols))
    assert np.abs(y.cpu().numpy() - y_ref).max() < 1e-12 * np.abs(
        y_ref).max()


# layout -> (matrix, SellMatrix.from_csr keywords, int16 sb planes)
ZERO_CASES = {
    "k-major": (lambda: banded(4096, 24, 512, seed=0),
                {"layout": "k-major"}, False),
    "sb-major": (lambda: banded(4096, 24, 512, seed=0),
                 {"layout": "sb-major"}, False),
    "sb-list": (lambda: banded(4096, 24, 512, seed=0),
                {"layout": "sb-list"}, False),
    "sb-list-i16": (lambda: banded(4096, 24, 512, seed=0),
                    {"layout": "sb-list"}, True),
    "wl": (lambda: banded(4096, 18, 40, seed=2), {"layout": "wl"}, False),
    "sg": (lambda: random_general(20000, 20000, 2.5e-4, seed=8),
           {"layout": "sg"}, False),
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


@pytest.mark.parametrize("precision", ["f32", "dd"])
@pytest.mark.parametrize("layout", sorted(ZERO_CASES))
def test_stored_zero_adds_nothing(layout, precision, dev):
    """An entry stored as 0, the only one of its column, with x = inf at
    that column: the kernels' rows are finite and equal the fp64 oracle of
    the matrix without the entry; the entry sits in a bin of the layout."""
    make, kw, i16 = ZERO_CASES[layout]
    full = CSRMatrix.from_coo(make())
    want = layout.removesuffix("-i16")
    start = int(full.row_ptr[full.nrows // 2])
    for keep in range(start, start + 40):
        csr, c = _column_once(full, keep, 0.0)
        sell = SellMatrix.from_csr(csr, **kw)
        one, _ = _column_once(full, keep, 1.0)
        d1 = S.device_put_sell(SellMatrix.from_csr(one, **kw), device=dev,
                               sb_i16=i16)
        e = torch.zeros(S.slab_table_rows(csr.ncols) * 128, device=dev)
        e[c] = 1.0
        lit = set()
        for b in d1.bins:
            y = torch.zeros(d1.num_groups * 1024, device=dev)
            S._KERNEL[b.layout](b, e, y)
            if y.abs().max() > 0:
                lit.add(b.layout)
        if lit == {want}:
            break
    else:
        pytest.fail(f"no entry of the middle rows lies in a {want} bin")
    x = np.random.default_rng(2).standard_normal(csr.ncols)
    x[c] = np.inf
    ref_csr, _ = _column_once(full, keep, None)
    if precision == "dd":
        ref = torch.from_numpy(ref_csr.spmv(x)).to(dev)
        y = D.sell_spmv_dd_f64(D.device_put_sell_dd(sell, device=dev,
                                                    sb_i16=i16),
                               torch.from_numpy(x).to(dev))
        assert torch.isfinite(y).all()
        assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()
    else:
        ref = torch.from_numpy(ref_csr.spmv(
            x.astype(np.float32).astype(np.float64))).float().to(dev)
        y = S.sell_spmv(S.device_put_sell(sell, device=dev, sb_i16=i16),
                        S.device_put_x(x, csr.ncols, device=dev))
        assert torch.isfinite(y).all()
        _close(y, ref)


def _wl_band(drop_lane0=False):
    """``banded(1024, 18, 40, seed=2)`` as a SELL of one 1-group wl bin;
    with ``drop_lane0`` without the entries of columns 128*s, so that the
    column code 0 names in each block is no real slot's."""
    coo = banded(1024, 18, 40, seed=2)
    if drop_lane0:
        keep = coo.col % 128 != 0
        coo = COOMatrix(coo.nrows, coo.ncols, coo.row[keep], coo.col[keep],
                        coo.val[keep])
    csr = CSRMatrix.from_coo(coo)
    sell = SellMatrix.from_csr(csr, layout="wl")
    assert [(b.layout, b.n_groups) for b in sell.bins] == [("wl", 1)]
    return csr, sell


# matrix -> (CSR, SELL): fem's wl bins of 17 and 6 groups, the band's one
WL_SPMM_MATRICES = {
    "fem20": lambda: (lambda c: (c, SellMatrix.from_csr(c)))(
        CSRMatrix.from_coo(fem_3d(20, 20, 20, dof=3, seed=1))),
    "band_1group": _wl_band,
}


@pytest.mark.parametrize("rhs", [1, 4, 6, 8, 12, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("matrix", sorted(WL_SPMM_MATRICES))
def test_wl_spmm_equals_plain_bit_for_bit(matrix, dtype, rhs, dev):
    """The wl SpMM kernel on the compacted planes against its plain
    version, storing and adding, and each column against the SpMV kernel,
    f32 and bf16 values."""
    csr, sell = WL_SPMM_MATRICES[matrix]()
    d = S.device_put_sell(sell, dtype, device=dev)
    X = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (csr.ncols, rhs))).float().to(dev)
    x_tab = SM.pack_x_multi(X, csr.ncols)
    y0 = torch.randn(d.num_groups * 1024, 32, device=dev)[:, :rhs]
    wl = [b for b in d.bins if b.layout == "wl"]
    assert wl and all(b.as_.dtype == dtype for b in wl)
    for b in wl:
        want = SM.wl_spmm_bin_plain(b, x_tab)
        rows = b.group_ids.long()
        for accumulate in (False, True):
            y = torch.zeros(d.num_groups * 1024, 32, device=dev)[:, :rhs]
            y.copy_(y0)
            SM.wl_spmm_bin(b, x_tab, y, accumulate=accumulate)
            got = y.view(-1, 8, 128, rhs)[rows]
            exp = y0.reshape(-1, 8, 128, rhs)[rows] + want if accumulate \
                else want
            assert torch.equal(got, exp), accumulate
        for j in range(rhs):
            y = torch.zeros(d.num_groups * 1024, device=dev)
            S.wl_bin(b, S.pack_x_table(X[:, j], csr.ncols), y)
            assert torch.equal(y.view(-1, 8, 128)[rows], want[..., j])


@pytest.mark.parametrize("rhs", [4, 16])
@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_wl_spmm_tail_slots_add_nothing(bad, rhs, dev):
    """Slots past a row's length hold value 0 and code 0: with x = inf or
    NaN at every column code 0 names (no real slot's) and at the padded
    table's rows past ncols, the kernel's y stays finite and equal to the
    plain version, from the raw X and from the table."""
    csr, sell = _wl_band(drop_lane0=True)
    d = S.device_put_sell(sell, device=dev)
    b = d.bins[0]
    assert int(b.row_len.min()) < int(b.row_len.max())  # rows have tails
    X = np.random.default_rng(14).standard_normal((csr.ncols, rhs))
    X[::128] = bad
    Xd = torch.from_numpy(X).float().to(dev)
    tab = SM.pack_x_multi(Xd, csr.ncols)
    tab[csr.ncols:] = bad
    for x in (Xd, tab):
        want = SM.wl_spmm_bin_plain(b, x)
        assert torch.isfinite(want).all()
        y = SM._rhs_buffer(d.num_groups * 1024, rhs, dev)
        SM.wl_spmm_bin(b, x, y)
        assert torch.equal(y.view(-1, 8, 128, rhs)[b.group_ids.long()], want)
        assert torch.equal(SM.sell_spmm(d, x), SM.sell_spmm_plain(d, x))


@pytest.mark.parametrize("rhs", [4, 8, 16, 32])
def test_wl_spmm_reads_raw_x_in_place(rhs, dev):
    """``sell_spmm`` on an all-wl SELL passes a contiguous f32 X straight to
    the kernels: equal bit for bit to the packed table's result."""
    csr = CSRMatrix.from_coo(fem_3d(20, 20, 20, dof=3, seed=1))
    d = S.device_put_sell(SellMatrix.from_csr(csr, layout="wl"), device=dev)
    assert {b.layout for b in d.bins} == {"wl"}
    X = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (csr.ncols, rhs))).float().to(dev)
    assert SM._x_table(d, X) is X
    before = SM.wl_spmm_bin.launches
    Y = SM.sell_spmm(d, X)
    assert SM.wl_spmm_bin.launches == before + len(d.bins)
    assert torch.equal(Y, SM.sell_spmm(d, SM.pack_x_multi(X, csr.ncols)))


# ---- the compacted sb-list kernels and the k-major SpMM, bit for bit ----

SB_LIST_MATRICES = {"road": lambda: road_network(20_000, seed=5),
                    "banded": lambda: banded(5 * 1024, 18, 40, seed=2)}


@pytest.mark.parametrize("planes", ["i32", "i16"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("matrix", sorted(SB_LIST_MATRICES))
def test_sb_list_kernel_equals_plain_bit_for_bit(matrix, precision, planes,
                                                 dev):
    """The compacted sb-list kernel (int32 planes) and the padded int16 one,
    f32, bf16 and dd, against their plain versions, which add each row's
    real slots in the kernel's order and rounding: storing, and adding onto
    y once."""
    csr = CSRMatrix.from_coo(SB_LIST_MATRICES[matrix]())
    sell = SellMatrix.from_csr(csr, layout="sb-list")
    d = _upload(sell, precision, dev, sb_i16=planes == "i16")
    kernel, plain = ((D.sb_list_bin_dd, D.sb_list_bin_plain_dd)
                     if precision == "dd"
                     else (S.sb_list_bin, S.sb_list_bin_plain))
    x = _x_for(csr, precision, dev)
    assert d.bins
    for b in d.bins:
        assert (b.row_table is None) == (planes == "i16")
        _equal_storing_and_adding(b, precision, kernel, plain, x, dev)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("matrix", sorted(SB_LIST_MATRICES))
def test_sb_list_kernel_equals_the_padded_result(matrix, precision, dev):
    """On finite x the compacted kernel returns what the padded layout's
    kernel returned (``sb_list_padded_plain``: every slot, pads included, in
    entry order), bit for bit: a pad only added an exact zero."""
    csr = CSRMatrix.from_coo(SB_LIST_MATRICES[matrix]())
    sell = SellMatrix.from_csr(csr, layout="sb-list")
    d = _upload(sell, precision, dev)
    x = _x_for(csr, precision, dev, seed=6)
    for h, b in zip(sell.bins, d.bins):
        assert b.ja.numel() < np.asarray(h.ja).size  # pad slots were dropped
        y = [torch.zeros(d.num_groups * 1024, device=dev)
             for _ in range(2 if precision == "dd" else 1)]
        if precision == "dd":
            D.sb_list_bin_dd(b, *x, *y)
            want = D.sb_list_padded_plain_dd(h, *x)
        else:
            S.sb_list_bin(b, *x, *y)
            want = (S.sb_list_padded_plain(h, x[0], b.as_.dtype),)
        rows = b.group_ids.long()
        for got, exp in zip(y, want):
            assert torch.equal(got.view(-1, 8, 128)[rows], exp)


# path -> matrix: every block's window fits the staged rows, or none does
K_MAJOR_PATHS = {"staged": lambda: banded(5 * 1024, 24, 40, seed=0),
                 "global": lambda: banded(5 * 1024, 24, 512, seed=0)}


@pytest.mark.parametrize("rhs", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", sorted(K_MAJOR_PATHS))
def test_k_major_spmm_equals_plain_bit_for_bit(path, dtype, rhs, dev,
                                               monkeypatch):
    """The k-major SpMM kernel on x staged in shared memory or gathered from
    the table, storing and adding onto a y that holds values, against its
    plain version, which adds each row's entries in k order with one fmaf a
    column; and each column against the SpMV kernel."""
    # the SpMV kernel one thread a row, as the SpMM kernel sums: these
    # 5-group bins would split their SpMV rows over lanes
    monkeypatch.setattr(S, "_KM_SPLIT_BELOW", 0)
    csr = CSRMatrix.from_coo(K_MAJOR_PATHS[path]())
    d = S.device_put_sell(SellMatrix.from_csr(csr, layout="k-major"), dtype,
                          device=dev)
    X = torch.from_numpy(np.random.default_rng(rhs).standard_normal(
        (csr.ncols, rhs))).float().to(dev)
    x_tab = SM.pack_x_multi(X, csr.ncols)
    n = d.num_groups * 1024
    y0 = torch.randn(n, 32, device=dev)[:, :rhs]
    kernel = SM.k_major_spmm_bin
    for b in d.bins:
        assert SM.staged_blocks(b) == (b.n_groups * 8 if path == "staged"
                                       else 0)
        want = SM.k_major_spmm_bin_plain(b, x_tab)
        rows = b.group_ids.long()
        for accumulate in (False, True):
            y = torch.zeros(n, 32, device=dev)[:, :rhs]
            y.copy_(y0)
            before = (kernel.launches, kernel.accumulating)
            kernel(b, x_tab, y, accumulate=accumulate)
            torch.cuda.synchronize()
            assert (kernel.launches, kernel.accumulating) == (
                before[0] + 1, before[1] + accumulate)
            got = y.view(-1, 8, 128, rhs)[rows]
            exp = y0.reshape(-1, 8, 128, rhs)[rows] + want if accumulate \
                else want
            assert torch.equal(got, exp), accumulate
        for j in range(rhs):
            y = torch.zeros(n, device=dev)
            S.k_major_bin(b, S.pack_x_table(X[:, j], csr.ncols), y)
            assert torch.equal(y.view(-1, 8, 128)[rows], want[..., j]), j


def test_new_layouts_refuse_broken_tables(dev):
    """A k-major bin without its window table, or with one of another shape
    or type, or a staged span past the kernel's shared memory, and an int32
    sb-list bin without its row table: each raises on CUDA tensors and
    nothing is launched."""
    csr, d = _spmm_sell("k-major", torch.float32, dev)
    b = d.bins[0]
    x_tab = SM.pack_x_multi(torch.ones(csr.ncols, 4, device=dev), csr.ncols)
    y = SM._rhs_buffer(d.num_groups * 1024, 4, dev)
    before = SM.k_major_spmm_bin.launches
    for bad, what in (
            (dataclasses.replace(b, x_window=None), "x_window"),
            (dataclasses.replace(b, x_window=b.x_window[:-1]), "x_window"),
            (dataclasses.replace(b, x_window=b.x_window.long()), "x_window"),
            (dataclasses.replace(b, window_rows=S._STAGE_ROWS + 1),
             "window_rows")):
        with pytest.raises(ValueError, match=what):
            SM.k_major_spmm_bin(bad, x_tab, y)
    assert SM.k_major_spmm_bin.launches == before
    csr = CSRMatrix.from_coo(banded(5 * 1024, 18, 40, seed=2))
    (b,) = S.device_put_sell(SellMatrix.from_csr(csr, layout="sb-list"),
                             device=dev).bins
    x = S.device_put_x(np.ones(csr.ncols), csr.ncols, device=dev)
    y = torch.zeros(b.n_groups * 1024, device=dev)
    before = S.sb_list_bin.launches
    with pytest.raises(ValueError, match="row_table"):
        S.sb_list_bin(dataclasses.replace(b, row_table=None), x, y)
    assert S.sb_list_bin.launches == before


# ---- the PR kernels and the locality split ----

# tests/test_pr.py's cases, and the panel case (several problems)
PR_CASES = {
    "random": (lambda: random_general(500, 400, 0.01, seed=2), None),
    "powerlaw": (lambda: power_law(1500, 3, seed=3), None),
    "banded": (lambda: banded(800, 5, 50, seed=4), None),
    "road": (lambda: road_network(1200, seed=5), None),
    "panels": (lambda: random_general(3000, 2500, 0.01, seed=11), 512),
}


def _pr_host(case):
    make, target = PR_CASES[case]
    csr = CSRMatrix.from_coo(make())
    if target is None:
        return csr, PRMatrix.from_csr(csr)
    pr = PanelPRMatrix.from_csr(csr, target_rows=target)
    assert len(pr.panels) >= 3
    return csr, pr


def _problems(d):
    return getattr(d, "panels", (d,))


@pytest.mark.parametrize("case", sorted(PR_CASES))
def test_pr_kernel_matches_plain(case, dev):
    """Each problem through the kernel against the plain version, which runs
    the Beneš stages themselves (so the routed planes are under test), then
    the whole SpMV against the fp64 oracle (tests/test_pr.py:156)."""
    csr, pr = _pr_host(case)
    d = PRo.device_put_pr(pr, device=dev)
    x = np.random.default_rng(5).standard_normal(csr.ncols)
    x_tab = S.device_put_x(x, csr.ncols, device=dev)
    for p in _problems(d):
        before = PRo.pr_problem.launches
        y = PRo.pr_problem(p, x_tab)
        torch.cuda.synchronize()
        assert PRo.pr_problem.launches == before + 1
        _close(y, PRo.pr_problem_plain(p, x_tab))
    y = pr.unpermute(PRo.pr_spmv(d, x_tab).cpu().numpy().astype(np.float64))
    ref = csr.spmv(x)
    assert (np.abs(y - ref) / np.maximum(1.0, np.abs(ref))).max() < 5e-6


@pytest.mark.parametrize("case", ["powerlaw", "road", "panels"])
def test_pr_dd_kernel_matches_plain(case, dev):
    csr, pr = _pr_host(case)
    d = PRD.device_put_pr_dd(pr, device=dev)
    x = np.random.default_rng(6).standard_normal(csr.ncols)
    xh, xl = D.device_put_x_dd(x, csr.ncols, device=dev)
    for p in _problems(d):
        before = PRD.pr_problem_dd.launches
        got = PRD.pr_problem_dd(p, xh, xl)
        torch.cuda.synchronize()
        assert PRD.pr_problem_dd.launches == before + 1
        _dd_close(got, PRD.pr_problem_plain_dd(p, xh, xl))
    _dd_close(PRD.pr_spmv_dd(d, xh, xl), PRD.pr_spmv_dd_plain(d, xh, xl))
    y = pr.unpermute(combine_f64(*PRD.pr_spmv_dd(d, xh, xl)).cpu().numpy())
    ref = csr.spmv(x)
    assert np.abs(y - ref).max() < 1e-12 * np.abs(ref).max()


def test_pr_dd_kernel_exact_where_f32_cancels(dev):
    """Cancelling rows (see test_dd_kernel_exact_where_f32_cancels) through
    the PR kernels: dd returns the fp64 oracle, f32 misses it."""
    coo, x = cancelling_pairs(5 * 1024, seed=0)
    csr = CSRMatrix.from_coo(coo)
    pr = pr_from_csr(csr)
    y_ref = csr.spmv(x)
    scale = np.abs(y_ref).max()
    before = PRD.pr_problem_dd.launches
    y_dd = combine_f64(*PRD.pr_spmv_dd(
        PRD.device_put_pr_dd(pr, device=dev),
        *D.device_put_x_dd(x, csr.ncols, device=dev))).cpu().numpy()
    assert PRD.pr_problem_dd.launches > before
    y32 = PRo.pr_spmv(PRo.device_put_pr(pr, device=dev),
                      S.device_put_x(x, csr.ncols, device=dev)).cpu().numpy()
    assert np.abs(pr.unpermute(y_dd) - y_ref).max() < 1e-12 * scale
    assert np.abs(pr.unpermute(y32.astype(np.float64)) - y_ref).max() \
        >= 1e-6 * scale


def test_split_kernels_match_plain(dev):
    """The split composite (k-major near side, one-entry PR far side) in
    f32 and dd against its plain versions and the oracle."""
    csr = CSRMatrix.from_coo(road_network(20_000, seed=1))
    sm = SplitMatrix.from_csr(csr)
    assert {b.layout for b in sm.near.bins} == {"k-major"}
    x = np.random.default_rng(7).standard_normal(csr.ncols)
    x_tab = S.device_put_x(x, csr.ncols, device=dev)
    ds = SPL.device_put_split(sm, device=dev)
    before = (PRo.pr_problem.launches, S.k_major_bin.launches)
    y = SPL.split_spmv(ds, x_tab)
    torch.cuda.synchronize()
    assert PRo.pr_problem.launches > before[0]
    assert S.k_major_bin.launches > before[1]
    _close(y, SPL.split_spmv_plain(ds, x_tab))
    ref = csr.spmv(x)
    xh, xl = D.device_put_x_dd(x, csr.ncols, device=dev)
    dsd = SPL.device_put_split_dd(sm, device=dev)
    before = (PRD.pr_problem_dd.launches, D.k_major_bin_dd.launches)
    got = SPL.split_spmv_dd(dsd, xh, xl)
    torch.cuda.synchronize()
    assert PRD.pr_problem_dd.launches > before[0]
    assert D.k_major_bin_dd.launches > before[1]
    _dd_close(got, SPL.split_spmv_dd_plain(dsd, xh, xl))
    assert np.abs(combine_f64(*got).cpu().numpy() - ref).max() \
        < 1e-12 * np.abs(ref).max()


def _bad_inputs(d, x_tab):
    """(what, problem, x) triples that the PR wrapper must refuse."""
    n = x_tab.numel()
    return [
        ("x must be float32", d, x_tab.double()),
        ("x is not contiguous",
         d, torch.zeros(2 * n, device=x_tab.device)[::2]),
        ("dst_col is not contiguous",
         dataclasses.replace(d, dst_col=d.dst_col.t().contiguous().t()),
         x_tab),
        ("md must be int32", dataclasses.replace(d, md=d.md.long()), x_tab),
        ("val must be float32",
         dataclasses.replace(d, val=d.val.double()), x_tab),
        ("at least", d, x_tab[: 128 * d.max_slab]),
        ("is on cpu", dataclasses.replace(d, dst_col=d.dst_col.cpu()), x_tab),
    ]


def test_pr_kernels_refuse_bad_inputs(dev):
    """A wrongly typed, non-contiguous, short or misplaced input raises on
    CUDA tensors; nothing falls back to the plain version."""
    csr, pr = _pr_host("powerlaw")
    d = PRo.device_put_pr(pr, device=dev)
    x_tab = S.device_put_x(np.ones(csr.ncols), csr.ncols, device=dev)
    before = PRo.pr_problem.launches
    for what, p, x in _bad_inputs(d, x_tab):
        with pytest.raises(ValueError, match=what):
            PRo.pr_problem(p, x)
    assert PRo.pr_problem.launches == before
    dd = PRD.device_put_pr_dd(pr, device=dev)
    xh, xl = D.device_put_x_dd(np.ones(csr.ncols), csr.ncols, device=dev)
    before = PRD.pr_problem_dd.launches
    with pytest.raises(ValueError, match="x_lo must be float32"):
        PRD.pr_problem_dd(dd, xh, xl.double())
    with pytest.raises(ValueError, match="val_l is not contiguous"):
        PRD.pr_problem_dd(dataclasses.replace(
            dd, val_l=dd.val_l.t().contiguous().t()), xh, xl)
    assert PRD.pr_problem_dd.launches == before


# ---- multi-RHS SpMM: the SELL SpMM kernels and the BSR kernels ----

SPMM_WRAPPERS = {"k-major": (SM.k_major_spmm_bin, SM.k_major_spmm_bin_plain),
                 "wl": (SM.wl_spmm_bin, SM.wl_spmm_bin_plain)}
SPMM_MATRICES = {"k-major": (lambda: banded(5 * 1024, 24, 512, seed=0),
                             {"layout": "k-major"}),
                 "wl": (lambda: fem_3d(20, 20, 20, dof=3, seed=1), {})}


def _spmm_sell(layout, dtype, dev):
    make, kw = SPMM_MATRICES[layout]
    csr = CSRMatrix.from_coo(make())
    d = S.device_put_sell(SellMatrix.from_csr(csr, **kw), dtype, device=dev)
    assert any(b.layout == layout for b in d.bins)
    return csr, d


@pytest.mark.parametrize("rhs", [3, 6, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", sorted(SPMM_WRAPPERS))
def test_spmm_kernel_matches_plain(layout, dtype, rhs, dev):
    """Every bin of the layout through its SpMM kernel, storing and adding
    onto a y that already holds values, against its plain version; R
    covers each accumulator count (4, 8, 16, 32) and a width that is not a
    multiple of 4."""
    csr, d = _spmm_sell(layout, dtype, dev)
    X = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (csr.ncols, rhs))).to(dev)
    x_tab = SM.pack_x_multi(X, csr.ncols)
    kernel, plain = SPMM_WRAPPERS[layout]
    y0 = torch.randn(d.num_groups * 1024, 32, device=dev)[:, :rhs]
    for b in (b for b in d.bins if b.layout == layout):
        want = plain(b, x_tab)
        rows = b.group_ids.long()
        for accumulate in (False, True):
            y = torch.zeros(d.num_groups * 1024, 32, device=dev)[:, :rhs]
            y.copy_(y0)
            before = (kernel.launches, kernel.accumulating)
            kernel(b, x_tab, y, accumulate=accumulate)
            torch.cuda.synchronize()
            assert (kernel.launches, kernel.accumulating) == (
                before[0] + 1, before[1] + accumulate)
            got = y.view(-1, 8, 128, rhs)[rows]
            base = y0.reshape(-1, 8, 128, rhs)[rows]
            _close(got - base if accumulate else got, want)
    _close(SM.sell_spmm(d, X), SM.sell_spmm_plain(d, X))


@pytest.mark.parametrize("layout", sorted(SPMM_WRAPPERS))
def test_spmm_columns_equal_spmv_bit_for_bit(layout, dev, monkeypatch):
    """Column j of the SpMM kernel is the SpMV kernel on X[:, j], to the
    bit: the same entries in the same order, each added with one fmaf. The
    SpMV kernel runs one thread a row here, as the SpMM kernel sums (bins
    this small would split their SpMV rows over lanes)."""
    monkeypatch.setattr(S, "_KM_SPLIT_BELOW", 0)
    csr, d = _spmm_sell(layout, torch.float32, dev)
    X = np.random.default_rng(9).standard_normal((csr.ncols, 5))
    Y = SM.sell_spmm(d, SM.device_put_x_multi(X, csr.ncols, device=dev))
    for j in range(X.shape[1]):
        y = S.sell_spmv(d, S.device_put_x(X[:, j], csr.ncols, device=dev))
        assert torch.equal(Y[:, j], y), j


def test_panel_spmm_matches_plain_and_oracle(dev):
    csr = CSRMatrix.from_coo(fem_3d(10, 10, 10, dof=3, seed=0))
    dps = S.device_put_sell(PanelSellMatrix.from_csr(csr, max_panel_cols=1024),
                            device=dev)
    X = np.random.default_rng(10).standard_normal((csr.ncols, 8))
    Xd = torch.from_numpy(X).float().to(dev)
    before = (SM.k_major_spmm_bin.accumulating, SM.wl_spmm_bin.accumulating)
    Y = SM.sell_spmm(dps, Xd)
    assert SM.k_major_spmm_bin.accumulating > before[0]
    assert SM.wl_spmm_bin.accumulating > before[1]
    _close(Y, SM.sell_spmm_plain(dps, Xd))
    ref = np.column_stack([csr.spmv(X[:, j]) for j in range(8)])
    assert np.abs(Y.cpu().numpy() - ref).max() < 1e-5 * np.abs(ref).max()


def _bsr(dtype, dev, make=lambda: banded(700, 9, 40, seed=3)):
    csr = CSRMatrix.from_coo(make())
    return csr, BSR.device_put_bsr(BSRMatrix.from_csr(csr), dtype, device=dev)


def _subtile_coo(seed=21):
    """1000 x 900 (a ragged last block row, rows past nrows in its padded
    Y): each block row holds 0-4 blocks (pad slots beside the fuller rows;
    block row 3 holds none), each block a random third of its 16x16
    sub-tiles filled at random density, and every block's strip 5 (columns
    80-95) all zero."""
    rng = np.random.default_rng(seed)
    nrows, ncols = 1000, 900
    rows, cols = [], []
    for g in range(-(-nrows // 128)):
        n_blocks = 0 if g == 3 else int(rng.integers(1, 5))
        for bc in rng.choice(-(-ncols // 128), n_blocks, replace=False):
            for a, b in np.argwhere(rng.random((8, 8)) < 1 / 3):
                if b == 5:
                    continue
                r, c = np.nonzero(rng.random((16, 16)) < rng.random())
                rows.append(128 * g + 16 * a + r)
                cols.append(128 * bc + 16 * b + c)
    row, col = np.concatenate(rows), np.concatenate(cols)
    keep = (row < nrows) & (col < ncols)
    row, col = row[keep], col[keep]
    return COOMatrix(nrows, ncols, row.astype(np.int32), col.astype(np.int32),
                     rng.standard_normal(row.size))


BSR_MATRICES = {"banded": lambda: banded(700, 9, 40, seed=3),
                "subtiles": _subtile_coo}


@pytest.mark.parametrize("rhs", [3, 6, 9, 16, 128, 130, 300])
@pytest.mark.parametrize("matrix", sorted(BSR_MATRICES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", sorted(BSR.ROUTES))
def test_bsr_kernel_matches_plain(route, dtype, matrix, rhs, dev):
    """Both routes, f32 and bf16, B below, at and past the 128-column tile
    (130, 300: a ragged last tile), raw and padded X, against the plain
    version; 700 and 1000 rows leave a ragged last block row. The
    "subtiles" matrix has all-zero 16x16 sub-tiles at random, a wholly zero
    strip in every block, pad slots and an empty block row."""
    csr, d = _bsr(dtype, dev, BSR_MATRICES[matrix])
    if matrix == "subtiles":
        masks = d.tile_mask.cpu().numpy().view(np.uint64)
        assert (masks == 0).any() and (masks != 0).any()
        assert not (masks & np.uint64(0x2020202020202020)).any()
    X = np.random.default_rng(11).standard_normal((csr.ncols, rhs))
    wrapper = BSR.ROUTES[route]
    for xin in (torch.from_numpy(X).to(dev),
                BSR.pad_rhs(X, csr.ncols, dtype, device=dev)):
        before = wrapper.launches
        y = BSR.bsr_spmm(d, xin, route=route)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert y.shape == (csr.nrows, xin.shape[1])
        _close(y, BSR.bsr_spmm_plain(d, xin))


def test_bsr_f32_is_not_tf32(dev):
    """Full-mantissa values on a dense-ish matrix: f32 BSR must stay within
    1e-5 of max|y| of the fp64 oracle on both routes. Inputs cut to TF32's
    10-bit mantissa miss it by far more: the check shows it on X alone."""
    csr, d = _bsr(torch.float32, dev,
                  lambda: random_general(384, 384, 0.5, seed=12))
    X = np.random.default_rng(13).standard_normal((csr.ncols, 64))
    ref = np.column_stack([csr.spmv(X[:, j]) for j in range(64)])
    for route in BSR.ROUTES:
        y = BSR.bsr_spmm(d, torch.from_numpy(X).to(dev), route=route)
        err = np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-5, (route, err)
    assert not torch.backends.cuda.matmul.allow_tf32
    tf32 = torch.from_numpy(X).float().to(dev)
    tf32 = (tf32.view(torch.int32) & ~0x1FFF).view(torch.float32)
    y_tf32 = BSR.bsr_spmm(d, tf32)
    err_tf32 = np.abs(y_tf32.cpu().numpy() - ref).max() / np.abs(ref).max()
    assert err_tf32 > 1e-5  # the trap springs on TF32-rounded inputs


def test_spmm_wrappers_refuse_bad_inputs(dev):
    """Wrong dtype, device or shape raise on CUDA tensors; nothing falls
    back to the plain version and nothing is counted."""
    csr, d = _spmm_sell("k-major", torch.float32, dev)
    b = d.bins[0]
    x_tab = SM.pack_x_multi(torch.ones(csr.ncols, 4, device=dev), csr.ncols)
    y = SM._rhs_buffer(d.num_groups * 1024, 4, dev)
    before = SM.k_major_spmm_bin.launches
    bad = [
        ("x must be torch.float32", x_tab.double(), y),
        ("row-major buffer", x_tab.t().contiguous().t(), y),
        ("y is on cpu", x_tab, y.cpu()),
        ("shape", x_tab, y[:, :3]),
        ("whole groups", x_tab, y[:1000]),
    ]
    for what, x, yy in bad:
        with pytest.raises(ValueError, match=what):
            SM.k_major_spmm_bin(b, x, yy)
    with pytest.raises(ValueError, match="as_ must be"):
        SM.k_major_spmm_bin(dataclasses.replace(b, as_=b.as_.double()),
                            x_tab, y)
    assert SM.k_major_spmm_bin.launches == before
    csr, dbsr = _bsr(torch.float32, dev)
    xp = BSR.pad_rhs(np.ones((csr.ncols, 8)), csr.ncols, device=dev)[:, :8]
    yb = torch.empty(dbsr.n_block_rows * 128, 8, device=dev)
    before = BSR.bsr_blockspec.launches
    bad = [
        ("x must be torch.float32", xp.to(torch.bfloat16), yb),
        ("x has shape", xp[:-128], yb),
        ("y is on cpu", xp, yb.cpu()),
        ("y must be torch.float32", xp, yb.double()),
        ("row-major buffer", xp, torch.empty(8, yb.shape[0],
                                             device=dev).t()),
    ]
    for what, x, yy in bad:
        with pytest.raises(ValueError, match=what):
            BSR.bsr_blockspec(dbsr, x, yy)
    with pytest.raises(ValueError, match="blocks must be"):
        BSR.bsr_dma(dataclasses.replace(dbsr, blocks=dbsr.blocks.double()),
                    xp, yb)
    assert BSR.bsr_blockspec.launches == before


@pytest.mark.parametrize("route", sorted(BSR.ROUTES))
def test_bsr_kernels_refuse_a_bad_tile_mask(route, dev):
    """A DeviceBSR whose tile_mask is missing, short, of another type or on
    another device raises; nothing is launched."""
    csr, dbsr = _bsr(torch.float32, dev)
    xp = BSR.pad_rhs(np.ones((csr.ncols, 8)), csr.ncols, device=dev)[:, :8]
    yb = torch.empty(dbsr.n_block_rows * 128, 8, device=dev)
    wrapper = BSR.ROUTES[route]
    before = wrapper.launches
    m = dbsr.tile_mask
    for what, mask in (("tile_mask must be", None),
                       ("tile_mask must be", m[:-1]),
                       ("tile_mask must be", m.view(-1, 1)),
                       ("tile_mask must be", m.int()),
                       ("tile_mask is on cpu", m.cpu())):
        with pytest.raises(ValueError, match=what):
            wrapper(dataclasses.replace(dbsr, tile_mask=mask), xp, yb)
    assert wrapper.launches == before


# ---- bf16 PR values ----


@pytest.mark.parametrize("case", sorted(PR_CASES))
def test_pr_bf16_kernel_matches_plain(case, dev):
    """bf16 values through ``pr_spmv_bf16`` against the plain version on the
    same widened values, then the whole SpMV against the fp64 oracle of the
    bf16-rounded values."""
    csr, pr = _pr_host(case)
    d = PRo.device_put_pr(pr, torch.bfloat16, device=dev)
    assert all(p.val.dtype == torch.bfloat16 for p in _problems(d))
    x = np.random.default_rng(7).standard_normal(csr.ncols)
    x_tab = S.device_put_x(x, csr.ncols, device=dev)
    for p in _problems(d):
        before = (PRo.pr_problem.launches, PRo.pr_problem.launches_bf16)
        y = PRo.pr_problem(p, x_tab)
        torch.cuda.synchronize()
        assert (PRo.pr_problem.launches, PRo.pr_problem.launches_bf16) == (
            before[0] + 1, before[1] + 1)
        _close(y, PRo.pr_problem_plain(p, x_tab))
    y = pr.unpermute(PRo.pr_spmv(d, x_tab).cpu().numpy().astype(np.float64))
    q = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                  quantize_bf16(csr.values))
    ref = q.spmv(x_tab.cpu().numpy()[: csr.ncols].astype(np.float64))
    assert (np.abs(y - ref) / np.maximum(1.0, np.abs(ref))).max() < 5e-6


# ---- the harness: flush_hbm and the stages of the JAX harness ----


def test_flush_hbm_buffer_is_twice_the_l2(dev):
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    n = flush_hbm(dev)
    assert n >= 2 * l2 and n >= 64 << 20
    assert flush_hbm(dev, mbytes=300) >= 300 << 20
    assert flush_hbm("cpu") == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_matrix_new_stages_on_cuda(dtype, dev):
    """serial_hll, csr, ell, hll, sell_sigma and pr after RCM, each timed as
    the best of rounds of device time and validated with no significant
    difference; device_validate checks every rep against the first."""
    coo = road_network(20_000, seed=5)
    stages = ("serial_hll", "csr", "ell", "sell", "hll", "sell_sigma", "pr")
    res = run_matrix("road", coo, BenchConfig(
        iterations=5, skip=1, stages=stages, dtype=dtype, reorder="rcm",
        sell_layout="sb-list", device_validate=True),
        log=lambda m: None, device=dev)
    assert res.format_stats["reorder"]["applied"]
    assert tuple(res.stages) == ("serial_csr", *stages) and not res.skipped
    assert {b.layout for b in res.sell.bins} == {"sb-list"}
    for name in stages:
        st = res.stages[name]
        assert st.diff.significant_diffs == 0, name
        assert st.seconds > 0 and st.per_call_s > 0, name
    for name in stages[1:]:
        assert res.stages[name].extra["device_val_max_diff"] == 0.0, name


# ---- the bandwidth probe's kernels ----


def _ints(shape, dtype, dev, seed=0, lo=-8, hi=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    return BW.small_ints(shape, dtype, generator=g, device=dev, lo=lo, hi=hi)


# rows: one 8-row tile, an odd count of tiles, and enough to span the grid
@pytest.mark.parametrize("nrows", [8, 8 * 37, 8 * 12_345])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int16,
                                   torch.int8])
def test_bw_read_matches_plain(dtype, nrows, dev):
    """Small integers: every f32 sum is exact, so kernel and plain version
    agree bit for bit whatever the order of the sums."""
    a = _ints((nrows, 128), dtype, dev)
    seed = _ints((8, 128), torch.float32, dev, seed=1)
    before = BW.bw_read.launches
    got = BW.bw_read(a, seed)
    assert BW.bw_read.launches == before + 1
    assert torch.equal(got, BW.bw_read_plain(a, seed))


@pytest.mark.parametrize("nrows", [8, 8 * 37, 8 * 12_345])
def test_bw_read2_matches_plain(nrows, dev):
    a = _ints((nrows, 128), torch.float32, dev)
    b = _ints((nrows, 128), torch.int32, dev, seed=2, lo=0, hi=128)
    seed = _ints((8, 128), torch.float32, dev, seed=1)
    assert torch.equal(BW.bw_read(a, seed, b), BW.bw_read_plain(a, seed, b))


@pytest.mark.parametrize("nrows", [8, 8 * 37 + 3, 8 * 12_345])
def test_bw_copy_matches_plain(nrows, dev):
    buf = _ints((nrows, 128), torch.float32, dev)
    seed = _ints((8, 128), torch.float32, dev, seed=1)
    before = BW.bw_copy.launches
    out = BW.bw_copy(buf, seed)
    assert BW.bw_copy.launches == before + 1
    assert torch.equal(out, BW.bw_copy_plain(buf, seed))
    into = torch.empty_like(buf)
    assert BW.bw_copy(buf, seed, into) is into and torch.equal(into, out)


@pytest.mark.parametrize("chunks", [1, 7, 3000])
@pytest.mark.parametrize("config", [(8, 2), (8, 3), *BW.ASYNC_CONFIGS])
def test_bw_read_async_matches_plain(config, chunks, dev):
    chunk_rows, nbuf = config
    buf = _ints((chunk_rows * chunks, 128), torch.float32, dev)
    seed = _ints((8, 128), torch.float32, dev, seed=1)
    before = BW.bw_read_async.launches
    got = BW.bw_read_async(buf, seed, chunk_rows=chunk_rows, nbuf=nbuf)
    assert BW.bw_read_async.launches == before + 1
    assert torch.equal(got, BW.bw_read_async_plain(buf, seed))


@pytest.mark.parametrize("variant", [
    dict(span=4), dict(span=1), dict(span=8), dict(span=4, compute=False),
    dict(span=4, packed=True)])
def test_bw_kernelsim_matches_plain(variant, dev):
    """Codes with sel up to span + 1 (past the window: they add nothing)."""
    ng, k, xrows = 13, 32, 300
    packed = variant.get("packed", False)
    g = torch.Generator(device=dev).manual_seed(3)
    qb, x, code, as_ = BW.kernelsim_inputs(ng, k, xrows, variant["span"] + 2,
                                           generator=g, device=dev,
                                           packed=packed)
    seed = _ints((8, 128), torch.float32, dev, seed=1)
    before = BW.bw_kernelsim.launches
    got = BW.bw_kernelsim(qb, x, code, as_, seed, k=k, **variant)
    assert BW.bw_kernelsim.launches == before + 1
    want = BW.bw_kernelsim_plain(qb, x, code, as_, seed, k=k, **variant)
    assert torch.equal(got, want) and want.abs().max() > 0


def test_bw_wrappers_refuse_bad_inputs(dev):
    """CPU tensors, mixed devices, wrong types and shapes raise; nothing is
    counted."""
    a = _ints((64, 128), torch.float32, dev)
    seed = _ints((8, 128), torch.float32, dev, seed=1)
    counts = {k: w.launches for k, w in BW.KERNELS.items()}
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        BW.bw_read(a.cpu(), seed.cpu())
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        BW.bw_copy(a.cpu(), seed.cpu())
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        BW.bw_read_async(a.cpu(), seed.cpu(), chunk_rows=8)
    with pytest.raises(ValueError, match="seed is on cpu"):
        BW.bw_read(a, seed.cpu())
    with pytest.raises(ValueError, match="must be torch.float32"):
        BW.bw_read(a.double(), seed)
    with pytest.raises(ValueError, match="multiple of 8"):
        BW.bw_read(a[:60], seed)
    with pytest.raises(ValueError, match="not the shape"):
        BW.bw_read(a, seed, torch.zeros(8, 128, dtype=torch.int32,
                                        device=dev))
    with pytest.raises(ValueError, match="multiple of 8 and nbuf"):
        BW.bw_read_async(a, seed, chunk_rows=8, nbuf=4)
    with pytest.raises(ValueError, match="no packed no-compute"):
        BW.bw_kernelsim(torch.zeros(1, 16, dtype=torch.int32, device=dev), a,
                        torch.zeros(64, 128, dtype=torch.int32, device=dev),
                        torch.zeros(128, 128, device=dev), seed, k=16,
                        compute=False, packed=True)
    with pytest.raises(ValueError, match="kernelsim planes"):
        BW.bw_kernelsim(torch.zeros(1, 8, dtype=torch.int32, device=dev), a,
                        torch.zeros(8, 128, dtype=torch.int32, device=dev),
                        a, seed, k=8)
    assert {k: w.launches for k, w in BW.KERNELS.items()} == counts


def test_run_probes_quick_reports_every_probe(dev):
    """The probe's entry point at its quick size: one record per probe, each
    with a positive rate; every kernel of the probe launched."""
    before = {k: w.launches for k, w in BW.KERNELS.items()}
    lines = []
    recs = BW.run_probes(dev, quick=True, emit=lines.append,
                         log=lambda m: None)
    assert len(lines) == len(recs) and recs[-1]["probe"] == "launch_overhead"
    names = {r["probe"] for r in recs}
    assert {"xla_sum_read", "xla_copy_rw", "bw_read_f32", "bw_read2_f32_i32",
            "bw_copy_f32", "bw_read_i16", "bw_read_i8",
            "kernelsim_span4"} <= names
    assert all(r["seconds"] > 0 and r["GBps"] > 0 for r in recs)
    assert all(w.launches > before[k] for k, w in BW.KERNELS.items())


# ---- the kernel-variant probes' kernels ----

KP_CODES = {"stream": (torch.int32, torch.int16, torch.int8),
            "bcast": (torch.int32, torch.int16),
            "window": (torch.int32, torch.int16, torch.int8),
            "masked": (torch.int32, torch.int16),
            "sblist": (torch.int32,), "wl": (torch.int32,)}
# (steps, kb, ck): one 8-row group a step, one part a step, parts of an odd
# count of groups, few steps of many rows (probe 3's KB=8192 shape), tall
# chunks (probe 2's ck=64)
KP_GEOMETRIES = [(5, 8, 8), (300, 64, 8), (7, 1000, 8), (3, 8192, 8),
                 (11, 512, 64)]


def _kp_decode_case(mode, dtype, steps, kb, ck, dev, span=4):
    """Codes that reach every branch: masked slabs one below and two past
    the window, sb-list slabs in and out of a list that repeats a slab."""
    g = torch.Generator(device=dev).manual_seed(11)
    nch, xr = kb // ck, 300

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    x = BW.small_ints((xr, 128), torch.float32, generator=g, device=dev)
    as_ = BW.small_ints((steps * kb, 128), torch.float32, generator=g,
                        device=dev)
    m = ri(0, 128, (steps, nch, ck, 128))
    kw = {"kb": kb, "ck": ck}
    tab = ri(1, xr - ck - span - 2, (steps, nch))
    if mode == "stream":
        code = ri(-100, 100, (steps * kb, 128))
    elif mode in ("bcast", "window"):
        code = m if dtype != torch.int32 or mode == "window" else \
            ri(-(1 << 20), 1 << 20, m.shape)
        if dtype == torch.int32 and mode == "window":
            code = m + ri(0, 1 << 10, m.shape) * 128  # slab bits ignored
    elif mode == "masked":
        d = ri(-1, span + 2, m.shape)
        q = 0 if dtype == torch.int16 else tab[:, :, None, None]
        code = ((q + d) << 7) | m
        kw["span"] = span
    elif mode == "sblist":
        tab = ri(0, xr, (steps, nch, span))
        tab[:, :, 1] = tab[:, :, 0]  # a slab listed twice counts twice
        pick = tab.gather(2, ri(0, span, (steps, nch, ck * 128)).long()
                          .view(steps, nch, -1)).view(steps, nch, ck, 128)
        slab = torch.where(ri(0, 4, m.shape) > 0, pick, ri(0, xr, m.shape))
        code = slab * 128 + m
        tab = tab.view(steps, -1).contiguous()
        kw["span"] = span
    else:  # wl, the most layers per window (of 4, 2, 1) that divide nch
        L = next(n for n in (4, 2, 1) if nch % n == 0)
        tab = ri(0, xr, (steps, 8 * nch // L))
        code = m
        kw["L"] = L
    code = code.reshape(-1, 128).to(dtype).contiguous()
    return (mode, code, as_, tab, x), kw


@pytest.mark.parametrize("geometry", KP_GEOMETRIES)
@pytest.mark.parametrize("mode,dtype", [(m, t) for m, ts in KP_CODES.items()
                                        for t in ts])
def test_kp_decode_matches_plain(mode, dtype, geometry, dev):
    """Small integers: every f32 sum is exact, so kernel and plain version
    agree bit for bit whatever the order of the sums."""
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        kernel_probe as KP)
    steps, kb, ck = geometry
    if mode == "wl" and ck != 8:
        ck = 8
    args, kw = _kp_decode_case(mode, dtype, steps, kb, ck, dev)
    before = KP.kp_decode.launches
    got = KP.kp_decode(*args, **kw)
    assert KP.kp_decode.launches == before + 1
    want = KP.kp_decode_plain(*args, **kw)
    assert torch.equal(got, want) and want.abs().max() > 0


@pytest.mark.parametrize("steps,kb", [(1, 8), (5, 64), (3, 8192), (40, 1000)])
@pytest.mark.parametrize("mode", ["fused8", "halves_gather", "halves_pure"])
def test_kp_fused_matches_plain(mode, steps, kb, dev):
    """halves_pure sums value bits that wrap int32 (kernel: uint32 adds);
    fused8 streams float(ja), so its codes stay below 128 (exact sums)."""
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        kernel_probe as KP)
    g = torch.Generator(device=dev).manual_seed(12)
    x = BW.small_ints((300, 128), torch.float32, generator=g, device=dev)
    qb = KP.qb_for(steps, kb // 8, 300, generator=g)
    ja, as_ = KP.mk_data(qb, 1, 8, generator=g)
    f = (KP.fuse_chunks(ja & 127, as_) if mode == "fused8"
         else KP.fuse_halves(ja, as_, kb))
    args = (f, qb, x) if mode == "halves_gather" else (f,)
    before = KP.kp_fused.launches
    got = KP.kp_fused(mode, *args, kb=kb)
    assert KP.kp_fused.launches == before + 1
    want = KP.kp_fused_plain(mode, *args, kb=kb)
    assert torch.equal(got, want) and want.abs().max() > 0
    if mode == "halves_pure":
        s = f.sum(0, dtype=torch.int64)
        assert bool(((s < -2 ** 31) | (s >= 2 ** 31)).any())


@pytest.mark.parametrize("rows", [8, 8 * 37 + 3, 1 << 16, 1 << 21])
@pytest.mark.parametrize("two", [False, True])
def test_kp_colsum_matches_plain(two, rows, dev):
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        kernel_probe as KP)
    a = _ints((rows, 128), torch.float32, dev, lo=-4, hi=4)
    b = _ints((rows, 128), torch.float32, dev, seed=3, lo=-4, hi=4) \
        if two else None
    before = KP.kp_colsum.launches
    got = KP.kp_colsum(a, b)
    assert KP.kp_colsum.launches == before + 1
    assert torch.equal(got, KP.kp_colsum_plain(a, b))


def test_kp_wrappers_refuse_bad_inputs(dev):
    """CPU tensors, mixed devices, wrong types and shapes raise; nothing is
    counted."""
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        kernel_probe as KP)
    (mode, code, as_, tab, x), kw = _kp_decode_case(
        "masked", torch.int32, 2, 64, 8, dev)
    counts = {k: w.launches for k, w in KP.KERNELS.items()}
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        KP.kp_decode(mode, code.cpu(), as_.cpu(), tab.cpu(), x.cpu(), **kw)
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        KP.kp_fused("halves_pure", code.cpu(), kb=32)
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        KP.kp_colsum(as_.cpu())
    with pytest.raises(ValueError, match="tab is on cpu"):
        KP.kp_decode(mode, code, as_, tab.cpu(), x, **kw)
    with pytest.raises(ValueError, match="tab must be"):
        KP.kp_decode(mode, code, as_, tab[:, :3].contiguous(), x, **kw)
    with pytest.raises(ValueError, match="ck must be"):
        KP.kp_decode(mode, code, as_, tab, x, kb=64, ck=12)
    with pytest.raises(ValueError, match="int32/int16/int8"):
        KP.kp_decode(mode, code.double(), as_, tab, x, **kw)
    with pytest.raises(ValueError, match="whole"):
        KP.kp_fused("halves_pure", code[:72].contiguous(), kb=64)
    with pytest.raises(ValueError, match="not the shape"):
        KP.kp_colsum(as_, as_[:8].contiguous())
    assert {k: w.launches for k, w in KP.KERNELS.items()} == counts


def test_run_kernel_probes_quick_on_the_card(dev):
    """The probes' entry point at its quick size: every variant's kernel
    equals its plain version (run_kernel_probes raises otherwise) and its
    checksum; every kernel launched; each record has a positive rate."""
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        kernel_probe as KP)
    before = {k: w.launches for k, w in KP.KERNELS.items()}
    lines = []
    recs = KP.run_kernel_probes(dev, quick=True, emit=lines.append,
                                log=lambda m: None)
    assert len(lines) == len(recs) == 58
    assert all(r["ms"] > 0 and r["GBps"] > 0 and r["bound_ms"] > 0
               and r["plain_ms"] > 0 and r["equal"] for r in recs)
    assert all(r.get("rel_err", 0.0) == 0.0 for r in recs)
    assert all(w.launches > before[k] for k, w in KP.KERNELS.items())
    assert all(r["library_ms"] > 0 for r in recs
               if r["variant"].startswith("read1_kb"))


# ---------------------------------------------------------------------------
# the solvers over the kernels


def _spd_fem(n=12):
    """fem_3d(n, n, n, dof=3) made SPD as the smoke makes its spd_fem3d:
    (M + M^T)/2 on the symmetric pattern, plus the largest absolute row sum
    + 1 on the diagonal."""
    csr = CSRMatrix.from_coo(fem_3d(n, n, n, dof=3, seed=1))
    t = csr.transpose()
    assert np.array_equal(t.col_idx, csr.col_idx)
    vals = (csr.values + t.values) / 2
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
    vals[rows == csr.col_idx] += np.bincount(
        rows, weights=np.abs(vals), minlength=csr.nrows).max() + 1.0
    return CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx, vals)


def _true_res(csr, X, B):
    """The largest true relative residual over the columns, fp64 on the
    host."""
    X, B = X.double().cpu().numpy(), B.double().cpu().numpy()
    X, B = X.reshape(len(X), -1), B.reshape(len(B), -1)
    return max(np.linalg.norm(B[:, j] - csr.spmv(X[:, j]))
               / np.linalg.norm(B[:, j]) for j in range(X.shape[1]))


def test_cg_sell_on_card_launches_and_matches_cpu(dev):
    csr = _spd_fem()
    sell = SellMatrix.from_csr(csr)
    layouts = {b.layout for b in sell.bins}
    assert layouts == {"k-major", "wl"}
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        csr.nrows)).float()
    before = {lay: S._KERNEL[lay].launches for lay in layouts}
    xg, kg, _ = SV.cg_sell(S.device_put_sell(sell, device=dev), b.to(dev),
                           tol=1e-5)
    assert all(S._KERNEL[lay].launches > n for lay, n in before.items())
    xc, kc, _ = SV.cg_sell(S.device_put_sell(sell, device="cpu"), b,
                           tol=1e-5)
    assert kg == kc
    _close(xg.cpu(), xc)
    assert _true_res(csr, xg, b) <= 1e-4


def test_cg_dd_matches_fp64_csr_on_card(dev):
    csr = _spd_fem()
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        csr.nrows)).to(dev)
    ddd = D.device_put_sell_dd(SellMatrix.from_csr(csr), device=dev)
    before = D._KERNEL_DD["wl"].launches
    x_dd, k_dd, _ = SV.cg(lambda v: D.sell_spmv_dd_f64(ddd, v), b, tol=1e-10)
    assert D._KERNEL_DD["wl"].launches > before
    x64, k64, _ = SV.cg_sell(device_put_csr(csr, torch.float64, device=dev),
                             b, tol=1e-10)
    assert k_dd == k64
    assert float((x_dd - x64).abs().max()) <= 1e-10 * float(x64.abs().max())
    assert _true_res(csr, x_dd, b) <= 1e-9


def _cg_case(case, dev):
    """(matvec, b, keyword arguments of cg) for a fused-CG case: the SELL
    f32 matvec or the dd one (fp64 in and out) over ``_spd_fem()``, or at
    600,000 rows (past the kernels' 1024 blocks, so their loops stride) a
    diagonal. Each matvec is deterministic (the fp64 CSR one adds with
    atomics)."""
    rng = np.random.default_rng(7)
    if case == "f32_large":
        d = torch.from_numpy(rng.uniform(1.0, 4.0, 600_000)).float().to(dev)
        b = torch.from_numpy(rng.standard_normal(d.numel())).float().to(dev)
        return (lambda v: d * v), b, {"tol": 1e-5}
    csr = _spd_fem()
    dt = torch.float64 if case == "f64_minv" else torch.float32
    b = torch.from_numpy(rng.standard_normal(csr.nrows)).to(dev, dt)
    if dt == torch.float64:
        ddd = D.device_put_sell_dd(SellMatrix.from_csr(csr), device=dev)
        matvec, kw = (lambda v: D.sell_spmv_dd_f64(ddd, v)), {"tol": 1e-10}
    else:
        d32 = S.device_put_sell(SellMatrix.from_csr(csr), device=dev)
        tab = torch.zeros(S.slab_table_rows(csr.ncols) * 128, device=dev)

        def matvec(v):
            tab[: v.shape[0]].copy_(v)
            return S.sell_spmv(d32, tab)
        kw = {"tol": 1e-5}
    if case != "f32_none":
        kw["minv"] = SV.jacobi_preconditioner(csr, dt, device=dev)
    if case == "x0":
        kw["x0"] = torch.from_numpy(rng.standard_normal(csr.nrows)).to(
            dev, dt)
    if case == "maxiter":
        kw["maxiter"] = 2
    if case == "b_zero":
        b = torch.zeros_like(b)
    return matvec, b, kw


@pytest.mark.parametrize("case", ["f32_minv", "f32_none", "f64_minv", "x0",
                                  "maxiter", "b_zero", "f32_large"])
def test_cg_fused_matches_eager_loop_on_card(case, dev):
    from sparsematrixvectormultiplication_tpu_torch.ops import cg_step as CS
    from sparsematrixvectormultiplication_tpu_torch.utils import profiling

    cg_mod = importlib.import_module(
        "sparsematrixvectormultiplication_tpu_torch.solvers.cg")
    matvec, b, kw = _cg_case(case, dev)
    assert cg_mod._eager_reason(b, kw.get("x0"), kw.get("minv")) is None
    before = [f.launches for f in (CS.cg_init, CS.cg_alpha, CS.cg_step,
                                   CS.cg_dir)]
    profiling.reset()
    profiling.enable()
    try:
        x, k, res = SV.cg(matvec, b, **kw)
        counted = profiling.counters()
    finally:
        profiling.disable()
        profiling.reset()
    assert [f.launches - n for f, n in zip(
        (CS.cg_init, CS.cg_alpha, CS.cg_step, CS.cg_dir), before)] \
        == [1, k, k, k]
    assert counted.get("solvers.cg.fused_iters", 0) == k
    assert counted["solvers.cg.host_reads"] == k + (k < kw.get("maxiter",
                                                               1000))
    x_e, k_e, res_e = cg_mod._cg_eager(matvec, b, kw.get("x0"), kw["tol"],
                                       kw.get("maxiter", 1000),
                                       kw.get("minv"), None)
    assert k == k_e
    assert {"maxiter": k == 2, "b_zero": k == 0}.get(case, k > 2)
    assert x.dtype == res.dtype == b.dtype and res.dim() == 0
    if b.dtype == torch.float64:
        assert float((x - x_e).abs().max()) <= 1e-12 * float(
            x_e.abs().max())
        torch.testing.assert_close(res, res_e, rtol=1e-6, atol=0.0)
    elif case == "b_zero":
        assert not bool(x.any()) and float(res) == float(res_e) == 0.0
    else:
        _close(x, x_e)
        torch.testing.assert_close(res, res_e, rtol=1e-2, atol=0.0)
    x2, k2, res2 = SV.cg(matvec, b, **kw)
    assert k2 == k and torch.equal(x2, x) and torch.equal(res2, res)


@pytest.mark.parametrize("then", ["full", "b_zero"])
@pytest.mark.parametrize("first", ["maxiter", "raise"])
def test_cg_fused_after_a_solve_left_early_on_card(first, then, dev):
    """A fused solve that leaves with its last ``cg_step``'s flag unread
    (at ``maxiter``, or where its matvec raises), that ``cg_step`` held
    back on the stream behind a spin, then at once, with no host sync
    between, a whole solve or a ``b = 0`` one: the second reads its own
    stop flag, not a late write of the first's (the first waits for its
    unread flag before its pinned word is freed)."""
    cg_mod = importlib.import_module(
        "sparsematrixvectormultiplication_tpu_torch.solvers.cg")
    matvec, b, kw = _cg_case("f32_minv", dev)
    b2 = torch.zeros_like(b) if then == "b_zero" else b
    x1_e, _, _ = cg_mod._cg_eager(matvec, b, None, kw["tol"], 2,
                                  kw["minv"], None)
    x2_e, k2_e, res2_e = cg_mod._cg_eager(matvec, b2, None, kw["tol"], 1000,
                                          kw["minv"], None)
    calls = []
    # the call whose spin the last cg_step queues behind: the second
    # iteration's head at maxiter 2; the first's where the third raises
    spin_at = 3 if first == "maxiter" else 2

    def held(v):
        calls.append(1)
        if len(calls) == spin_at:
            torch.cuda._sleep(100_000_000)
        if first == "raise" and len(calls) == 3:
            raise ArithmeticError("matvec failed")
        return matvec(v)

    torch.cuda.synchronize(dev)
    if first == "raise":
        with pytest.raises(ArithmeticError, match="matvec failed"):
            SV.cg(held, b, **kw)
    else:
        x1, k1, _ = SV.cg(held, b, maxiter=2, **kw)
    x2, k2, res2 = SV.cg(matvec, b2, **kw)
    assert len(calls) == 3
    if first == "maxiter":
        assert k1 == 2
        _close(x1, x1_e)
    assert k2 == k2_e and (k2 == 0) == (then == "b_zero")
    assert bool(torch.isfinite(x2).all())
    if then == "b_zero":
        assert not bool(x2.any()) and float(res2) == float(res2_e) == 0.0
    else:
        _close(x2, x2_e)
        torch.testing.assert_close(res2, res2_e, rtol=1e-2, atol=0.0)


def test_cg_with_prec_callable_stays_eager_on_card(dev):
    from sparsematrixvectormultiplication_tpu_torch.utils import profiling

    matvec, b, kw = _cg_case("f32_minv", dev)
    minv = kw.pop("minv")
    profiling.reset()
    profiling.enable()
    try:
        x, k, _ = SV.cg(matvec, b, prec=lambda r: r * minv, **kw)
        counted = profiling.counters()
    finally:
        profiling.disable()
        profiling.reset()
    assert k > 0 and "solvers.cg.fused_iters" not in counted
    assert counted["solvers.cg.host_reads"] == k + 1
    x_f, k_f, _ = SV.cg(matvec, b, minv=minv, **kw)
    assert k_f == k
    _close(x_f, x)


@pytest.mark.parametrize("kind", ["sell_spmm", "bsr_spmm"])
def test_cg_multi_on_card_launches_and_matches_cpu(kind, dev):
    csr = _spd_fem()
    if kind == "sell_spmm":
        host, put = SellMatrix.from_csr(csr), S.device_put_sell
        wrappers = [SM.k_major_spmm_bin, SM.wl_spmm_bin]
        spmm = SM.sell_spmm
    else:
        host, put = BSRMatrix.from_csr(csr), BSR.device_put_bsr
        wrappers = [BSR.bsr_blockspec]
        spmm = BSR.bsr_spmm
    B = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (csr.nrows, 8))).float()
    d_gpu, d_cpu = put(host, device=dev), put(host, device="cpu")
    before = [w.launches for w in wrappers]
    Xg, kg, _ = SV.cg_multi(lambda X: spmm(d_gpu, X), B.to(dev), tol=1e-5)
    assert all(w.launches > n for w, n in zip(wrappers, before))
    Xc, kc, _ = SV.cg_multi(lambda X: spmm(d_cpu, X), B, tol=1e-5)
    assert kg == kc
    _close(Xg.cpu(), Xc)
    assert _true_res(csr, Xg, B) <= 1e-4


def test_solvers_on_cuda_containers_never_run_plain(dev, monkeypatch):
    def plain(*args, **kw):
        raise AssertionError("a plain version ran on a CUDA container")

    for mod, name in ((S, "_write_plain"), (D, "_write_plain_dd"),
                      (SM, "_write_plain"), (BSR, "_plain_rows")):
        monkeypatch.setattr(mod, name, plain)
    csr = _spd_fem()
    sell = SellMatrix.from_csr(csr)
    rng = np.random.default_rng(3)
    b = torch.from_numpy(rng.standard_normal(csr.nrows)).to(dev)
    B = torch.from_numpy(rng.standard_normal((csr.nrows, 4))).float().to(dev)
    d32 = S.device_put_sell(sell, device=dev)
    ddd = D.device_put_sell_dd(sell, device=dev)
    dbsr = BSR.device_put_bsr(BSRMatrix.from_csr(csr), device=dev)
    tab = torch.zeros(S.slab_table_rows(csr.ncols) * 128, device=dev)

    def mv32(v):
        tab[: v.shape[0]].copy_(v)
        return S.sell_spmv(d32, tab)

    runs = [SV.cg_sell(d32, b.float(), tol=1e-5),
            SV.cg(lambda v: D.sell_spmv_dd_f64(ddd, v), b, tol=1e-10),
            SV.cg_multi(lambda X: SM.sell_spmm(d32, X), B, tol=1e-5),
            SV.cg_multi(lambda X: BSR.bsr_spmm(dbsr, X), B, tol=1e-5),
            SV.bicgstab(mv32, b.float(), tol=1e-5),
            SV.gmres(mv32, b.float(), tol=1e-5, restart=8)]
    for x, _, _ in runs:
        assert x.device.type == "cuda" and bool(torch.isfinite(x).all())


# ---- the sweep and tune layer on the card ----


def test_autotune_measures_on_card_and_its_pick_validates(dev):
    from sparsematrixvectormultiplication_tpu_torch.tune import (
        autotune as T)

    csr = CSRMatrix.from_coo(banded(5 * 1024, 24, 512, seed=0))
    before = {lay: w.launches for lay, w in S._KERNEL.items()}
    tr = T.autotune_sell(csr, device=dev)
    assert [n for n, _, _ in tr.table] == [
        c.name for c in T._default_candidates()]
    for name, sec, stats in tr.table:
        assert np.isfinite(sec) and stats["measured"] == sec > 0, name
    assert tr.best_seconds == min(s for _, s, _ in tr.table)
    assert tr.assembly in ("auto", "sum")
    forced = {"k-major", "sb-major", "sb-list", "wl"}
    assert all(S._KERNEL[lay].launches > before[lay] for lay in forced)
    res = run_matrix("tuned", banded(5 * 1024, 24, 512, seed=0), BenchConfig(
        iterations=4, rounds=1, stages=("sell", "sell_dd"), autotune=True),
        log=lambda m: None, device=dev)
    # the stage ran its own tuner's pick: the fastest of its table (a
    # second tuner run may pick another of candidates that time alike)
    tune = res.format_stats["tune"]
    assert len(tune["table"]) == 10 and tune["hack_size"] > 0
    assert tune["ladder"] == min(tune["table"], key=lambda r: r[1])[0]
    for stage in ("sell", "sell_dd"):
        assert res.stages[stage].diff.significant_diffs == 0, stage
        assert res.stages[stage].extra["device_bytes"] > 0


def test_assembly_sum_and_chain_equal_auto_on_card(dev):
    csr = CSRMatrix.from_coo(banded(20 * 1024, 24, 64, seed=2))
    sell = SellMatrix.from_csr(csr, layout="wl-shed")
    assert any(b.add_into for b in sell.bins) and len(sell.bins) > 1
    x = np.random.default_rng(5).standard_normal(csr.ncols)
    d = S.device_put_sell(sell, device=dev)
    x_tab = S.device_put_x(x, csr.ncols, device=dev)
    auto = S.sell_spmv(d, x_tab)
    for assembly in ("sum", "chain"):
        got = S.sell_spmv(d, x_tab, assembly)
        _close(got, auto)
        _close(got, S.sell_spmv_plain(d, x_tab, assembly))
    ref = torch.from_numpy(csr.spmv(x.astype(np.float32).astype(np.float64)))
    _close(auto.double().cpu(), ref)


def test_ladder_sweep_rows_validate_on_card(dev, tmp_path):
    import csv

    from sparsematrixvectormultiplication_tpu_torch.bench.scale import (
        run_ladder_sweep)

    csr = CSRMatrix.from_coo(power_law(20_000, 6, seed=5))
    out = str(tmp_path / "ladders.csv")
    rows = run_ladder_sweep("pl", csr, out, iterations=4, rounds=1,
                            device=dev, log=lambda m: None)
    assert len(rows) == 4
    with open(out) as f:
        table = list(csv.DictReader(f))
    for r in table:
        assert r["significant_diffs"] == "0", r["stage"]
        assert float(r["pct_stream_bw"]) > 0 and float(r["time_s"]) > 0


def test_autotune_launch_error_propagates(dev, monkeypatch):
    from sparsematrixvectormultiplication_tpu_torch.formats.sell import (
        DEFAULT_K_BINS)
    from sparsematrixvectormultiplication_tpu_torch.tune import (
        autotune as T)

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setitem(S._KERNEL, "k-major", broken)
    csr = CSRMatrix.from_coo(banded(5 * 1024, 24, 512, seed=0))
    cands = [T.SellCandidate("default-kmajor", DEFAULT_K_BINS, "k-major")]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        T.autotune_sell(csr, candidates=cands, device=dev)


def test_sweep_cli_on_card(dev, tmp_path):
    import csv

    from sparsematrixvectormultiplication_tpu_torch.bench import cli
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        csv_report as R)
    from sparsematrixvectormultiplication_tpu_torch.io.mmio import (
        write_matrix_market)

    coo = banded(8192, 16, 200, seed=1)
    (tmp_path / "m").mkdir()
    write_matrix_market(str(tmp_path / "m" / "band.mtx"), coo.nrows,
                        coo.ncols, coo.row, coo.col, coo.val)
    out = tmp_path / "r"
    assert cli.main(["--matrix-dir", str(tmp_path / "m"), "--output-dir",
                     str(out), "--iterations", "4", "--rounds", "1",
                     "--kernels", "serial_hll,csr,ell,sell,sell_bf16,"
                     "sell_dd,hll"], log=lambda m: None) == 0
    for name, header in (("spmv_results.csv", R.NATIVE_HEADER),
                         ("spmv_results_openmp.csv", R.OPENMP_HEADER),
                         ("spmv_results_cuda.csv", R.CUDA_HEADER),
                         ("spmv_tile_config.csv", R.TILE_HEADER),
                         ("matrix_memory_stats.csv", R.MEMORY_STATS_HEADER)):
        with open(out / name) as f:
            assert next(csv.reader(f)) == header, name
    with open(out / "spmv_results.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 8
    for r in rows:
        assert r["significant_diffs"] == "0", r["stage"]
        if not r["stage"].startswith("serial"):
            assert float(r["pct_stream_bw"]) > 0, r["stage"]


# ---------------------------------------------------------------------------
# the multi-device layer: ranks on the card against the same paths' plain
# versions on CPU ranks
# ---------------------------------------------------------------------------


def _shard_jobs(n):
    """Row-sharded SELL (sg and add_into k-major bins), SELL SpMM (k-major),
    BSR, PR, the split and column-sharded SELL over ``n`` shards."""
    from sparsematrixvectormultiplication_tpu_torch.parallel import (
        spmd_bsr, spmd_colsell, spmd_pallas, spmd_pr, spmd_split)
    from sparsematrixvectormultiplication_tpu_torch.bench.scale import (
        ShardJob)

    rng = np.random.default_rng(0)
    uni = CSRMatrix.from_coo(random_general(20000, 20000, 2.5e-4, seed=8))
    band = CSRMatrix.from_coo(banded(8192, 9, 300, seed=1))
    road = CSRMatrix.from_coo(road_network(50_000, seed=2))
    x_u, x_b, x_r = (rng.standard_normal(c.ncols) for c in (uni, band, road))
    X = rng.standard_normal((band.ncols, 8)).astype(np.float32)
    return [
        (ShardJob("sell", spmd_pallas.build_spmd_sell(uni, n), x_u, (n,),
                  check_plain=True), uni.spmv(x_u)),
        (ShardJob("sell_spmm", spmd_pallas.build_spmd_sell(
            band, n, sell_kwargs={"layout": "k-major"}), X, (n,)), None),
        (ShardJob("bsr", spmd_bsr.shard_bsr(BSRMatrix.from_csr(band), n), X,
                  (n,)), None),
        (ShardJob("pr", spmd_pr.build_spmd_pr(road, n), x_r, (n,)),
         road.spmv(x_r)),
        (ShardJob("split", spmd_split.build_spmd_split(road, n), x_r, (n,)),
         road.spmv(x_r)),
        (ShardJob("sell_cols", spmd_colsell.build_spmd_sell_cols(band, n),
                  x_b, (n,), ("cols",)), band.spmv(x_b))]


def test_sharded_paths_on_ranks_sharing_the_card(dev, tmp_path):
    """4 gloo ranks on cuda:0 launch the kernels, and equal 4 CPU ranks'
    plain versions within the f32 tolerance (and the oracle)."""
    from sparsematrixvectormultiplication_tpu_torch.bench.scale import (
        run_shard_jobs)
    from sparsematrixvectormultiplication_tpu_torch.parallel import launch

    jobs = _shard_jobs(4)
    out, want = (launch.spawn(run_shard_jobs, 4, device_type=t,
                              args=([j for j, _ in jobs],), timeout_s=300,
                              store_dir=str(tmp_path))
                 for t in ("cuda", "cpu"))
    for i, (job, ref) in enumerate(jobs):
        got = [torch.from_numpy(o[i]["y"]) for o in out]
        for g in got[1:]:
            assert torch.equal(g, got[0]), job.path
        _close(got[0], torch.from_numpy(want[0][i]["y"]))
        if ref is not None:
            assert np.abs(got[0].double().numpy() - ref).max() <= \
                1e-5 * np.abs(ref).max(), job.path
        assert {o[i]["backend"] for o in out} == {"gloo"}
        assert sum(sum(o[i]["launches"].values()) for o in out) > 0, job.path
    assert out[0][0]["plain_max_abs_err"] <= 2e-5 * out[0][0]["plain_scale"]


def test_nccl_ranks_one_per_card(dev, tmp_path):
    from sparsematrixvectormultiplication_tpu_torch.bench.scale import (
        ShardJob, run_shard_jobs)
    from sparsematrixvectormultiplication_tpu_torch.parallel import (
        launch, spmd_pallas)

    n = torch.cuda.device_count()
    csr = CSRMatrix.from_coo(banded(8192, 9, 300, seed=1))
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    job = ShardJob("sell", spmd_pallas.build_spmd_sell(csr, n), x, (n,),
                   reps=3)
    out = launch.spawn(run_shard_jobs, n, device_type="cuda", args=([job],),
                       timeout_s=300, store_dir=str(tmp_path))
    assert {o[0]["backend"] for o in out} == {"nccl"}
    ref = csr.spmv(x)
    for o in out:
        assert np.abs(o[0]["y"] - ref).max() <= 1e-5 * np.abs(ref).max()
        assert o[0]["call_s"] > 0 and o[0]["launches"]


def test_shard_sell_rows_on_one_card(dev):
    from sparsematrixvectormultiplication_tpu_torch.parallel import (
        multidevice)

    csr = CSRMatrix.from_coo(banded(8192, 9, 300, seed=1))
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    md = multidevice.shard_sell_rows(csr, [dev] * 4)
    before = S.k_major_bin.launches + S.sb_major_bin.launches
    y = md.spmv(x)
    assert y.device == dev
    assert S.k_major_bin.launches + S.sb_major_bin.launches > before
    want = multidevice.shard_sell_rows(csr, [torch.device("cpu")] * 4).spmv(x)
    _close(y.cpu(), want)


def test_flagship_functions_on_the_card(dev):
    """The flagship line's per-matrix functions (bench/flagship.py) on
    fem_3d(20, 20, 20, dof=3) on the card: the record valid, and each
    stage's SELL, run through the kernels, equal to its plain version (f32
    and bf16 at the f32 tolerance, dd within 1e-12*max|y|)."""
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        flagship as F)
    from sparsematrixvectormultiplication_tpu_torch.ops.sell_dd import (
        device_put_x_dd)

    coo = fem_3d(20, 20, 20, dof=3, seed=1)
    runs = {"fem3d_cube": (F.run_fem3d_cube, {"k-major", "wl"}),
            "banded_adversarial": (F.run_banded_adversarial,
                                   {"k-major", "wl"}),
            "road_scattered": (F.run_road_scattered, {"sb-list"})}
    before = sum(w.launches for w in (*S._KERNEL.values(),
                                      *D._KERNEL_DD.values()))
    results = {name: fn(coo, dev, lambda m: None, layouts=lay, iterations=8)
               for name, (fn, lay) in runs.items()}
    assert sum(w.launches for w in (*S._KERNEL.values(),
                                    *D._KERNEL_DD.values())) > before
    rec = F.flagship_record(results, device=torch.cuda.get_device_name(dev),
                            power_limit_w=None, wall_s=0.0,
                            generate_s=dict.fromkeys(F.MATRICES, 0.0),
                            log=lambda m: None)
    assert rec["valid"] is True
    x = np.ones(coo.ncols)
    xt = S.device_put_x(x, coo.ncols, device=dev)
    xh, xl = device_put_x_dd(x, coo.ncols, device=dev)
    for name, res in results.items():
        stages = F.MATRICES[name][2]
        assert res.device == str(dev) and tuple(res.stages) == (
            "serial_csr", *stages)
        for dtype, stage in ((torch.float32, "sell"),
                             (torch.bfloat16, "sell_bf16")):
            if stage in stages:
                d = S.device_put_sell(res.sell, dtype, device=dev)
                _close(S.sell_spmv(d, xt), S.sell_spmv_plain(d, xt))
        if "sell_dd" in stages:
            d = D.device_put_sell_dd(res.sell, device=dev)
            y = combine_f64(*D.sell_spmv_dd(d, xh, xl))
            want = combine_f64(*D.sell_spmv_dd_plain(d, xh, xl))
            assert (y - want).abs().max() <= 1e-12 * want.abs().max()


def _two_bands():
    """Two bands of one K and spans 8 and 20 slabs: two sb-major bins that
    join (tests/test_torch_joint.py's)."""
    a = banded(3072, 24, 300, seed=1)
    b = banded(5120, 24, 1500, seed=2)
    return COOMatrix(8192, 8192, np.concatenate([a.row, b.row + 3072]),
                     np.concatenate([a.col, b.col + 3072]),
                     np.concatenate([a.val, b.val]))


# case -> (matrix, SellMatrix.from_csr keywords): k-major + two wl bins,
# two sb-major bins, seven compacted sb-list bins, sg + add_into k-major
JOINT_CASES = {
    "fem": (lambda: fem_3d(20, 20, 20, dof=3, seed=1), {}),
    "banded": (_two_bands, {"layout": "sb-major", "merge_bins": False}),
    "road": (lambda: road_network(20_000, seed=5),
             {"layout": "sb-list", "merge_bins": False}),
    "uniform": (lambda: random_general(30_000, 30_000, 2.5e-4, seed=3), {}),
}
EXACT = ("k-major", "wl", "sb-list", "sg")  # kernels equal to their plain


def _counted(ws):
    return sum(w.launches for w in ws.values())


@pytest.mark.parametrize("precision", ["f32", "bf16", "dd"])
@pytest.mark.parametrize("case", sorted(JOINT_CASES))
def test_joint_launches_match_plain(case, precision, dev):
    """Each joint launch of the plan against its plain version (bit for bit
    where the layout's kernel is, sb-major at the f32 and dd tolerances),
    the SpMV against the plain plan, and the wrappers' launch counts of
    one SpMV equal to the plan's launches and ``sell_spmv_launches``
    without the zero fills and the pair table."""
    make, kw = JOINT_CASES[case]
    csr = CSRMatrix.from_coo(make())
    sell = SellMatrix.from_csr(csr, **kw)
    x = np.random.default_rng(6).standard_normal(csr.ncols)
    dd = precision == "dd"
    if dd:
        d = D.device_put_sell_dd(sell, device=dev)
        xs = D.device_put_x_dd(x, csr.ncols, device=dev)
        kernels, plains, ws = DD_WRAPPERS, DD_WRAPPERS, D
    else:
        d = S.device_put_sell(sell, torch.bfloat16 if precision == "bf16"
                              else torch.float32, device=dev)
        xs = (S.device_put_x(x, csr.ncols, device=dev),)
        kernels, plains, ws = WRAPPERS, WRAPPERS, S
    assert len(d.plan.launches) < len(d.bins) or (case, dd) == ("uniform",
                                                                 True)
    for j in d.plan.launches:
        kernel, plain = kernels[j.bin.layout][0], plains[j.bin.layout][1]
        ys = [torch.full((d.num_groups * 1024,), float("nan"), device=dev)
              for _ in xs]
        kernel(j.bin, *xs, *ys)
        rows = j.bin.group_ids.long()
        got = [y.view(-1, 8, 128)[rows] for y in ys]
        want = plain(j.bin, *xs)
        want = want if dd else (want,)
        if j.bin.layout in EXACT:
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        elif dd:
            _dd_close(got, want)
        else:
            _close(got[0], want[0])
    wrappers = {lay: w[0] for lay, w in kernels.items()}
    before = _counted(wrappers)
    y = ws.sell_spmv_dd(d, *xs) if dd else (ws.sell_spmv(d, *xs),)
    torch.cuda.synchronize()
    launched = _counted(wrappers) - before
    pairs = dd and any(D._pairs(j.bin) for j in d.plan.launches)
    count = D.sell_spmv_dd_launches(d) if dd else S.sell_spmv_launches(d)
    assert launched == len(d.plan.launches) == count - pairs
    want = D.sell_spmv_dd_plain(d, *xs) if dd else (S.sell_spmv_plain(d,
                                                                       *xs),)
    if all(j.bin.layout in EXACT for j in d.plan.launches):
        assert all(torch.equal(g, w) for g, w in zip(y, want))
    elif dd:
        _dd_close(y, want)
    else:
        _close(y[0], want[0])


@pytest.mark.parametrize("dd", [False, True], ids=["f32", "dd"])
def test_panel_reduce_matches_plain(dd, dev):
    """panel_reduce on slices with NaN where no bin writes, -0 sums and a
    group no slice covers: bit for bit its plain version."""
    rng = np.random.default_rng(12)
    slices, ng = 5, 7
    cover = torch.from_numpy(rng.integers(0, 2, (slices, ng))
                             .astype(np.uint8)).to(dev)
    cover[:, 3] = 0
    parts = [torch.from_numpy(rng.standard_normal(slices * ng * 1024)
                              .astype(np.float32)).to(dev)
             for _ in range(1 + dd)]
    if dd:
        parts[1] *= 2.0**-30
    for p in parts:
        v = p.view(slices, ng, 1024)
        v[~cover.bool()] = float("nan")
        v[:, :, :8] = -0.0
    ys = [torch.full((ng * 1024,), float("nan"), device=dev)
          for _ in parts]
    if dd:
        before = D.panel_reduce_dd.launches
        D.panel_reduce_dd(*parts, cover, *ys)
        want = D.panel_reduce_plain_dd(*parts, cover)
        assert D.panel_reduce_dd.launches == before + 1
    else:
        before = S.panel_reduce.launches
        S.panel_reduce(parts[0], cover, ys[0])
        want = (S.panel_reduce_plain(parts[0], cover),)
        assert S.panel_reduce.launches == before + 1
    torch.cuda.synchronize()
    for y, w in zip(ys, want):
        assert torch.equal(y, w)
        assert torch.equal(y.view(ng, 1024)[3], torch.zeros(1024,
                                                             device=dev))
        assert not torch.signbit(y.view(ng, 1024)[:, :8]).any()


@pytest.mark.parametrize("dd", [False, True], ids=["f32", "dd"])
def test_panel_spmv_launches_follow_the_plan(dd, dev):
    """fem_3d(10, 10, 10) in 1024-column panels: the joint launches and one
    panel_reduce a call, as ``sell_spmv_launches`` counts them, and the
    result bit for bit the plain plan's."""
    csr = CSRMatrix.from_coo(fem_3d(10, 10, 10, dof=3, seed=0))
    psell = PanelSellMatrix.from_csr(csr, max_panel_cols=1024)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        csr.ncols)).to(dev)
    if dd:
        dps = D.device_put_sell_dd(psell, device=dev)
        xs, wrappers, reduce = (x.float(), (x - x.float().double()).float()), \
            {lay: w[0] for lay, w in DD_WRAPPERS.items()}, D.panel_reduce_dd
        run, plain = D.panel_sell_spmv_dd, D.panel_sell_spmv_dd_plain
    else:
        dps = S.device_put_sell(psell, device=dev)
        xs, wrappers, reduce = (x.float(),), \
            {lay: w[0] for lay, w in WRAPPERS.items()}, S.panel_reduce
        run = lambda d, v: (S.panel_sell_spmv(d, v),)  # noqa: E731
        plain = lambda d, v: (S.panel_sell_spmv_plain(d, v),)  # noqa: E731
    n_bins = sum(len(p.bins) for p in dps.panels)
    assert len(dps.plan.launches) < n_bins
    before = (_counted(wrappers), reduce.launches)
    got = run(dps, *xs)
    torch.cuda.synchronize()
    assert (_counted(wrappers) - before[0], reduce.launches - before[1]) \
        == (len(dps.plan.launches), 1)
    count = D.sell_spmv_dd_launches(dps) if dd else S.sell_spmv_launches(dps)
    # the x tables' fills and copies and, in dd, the pair table
    assert count == dps.plan.kernels + (5 if dd else 2)
    for g, w in zip(got, plain(dps, *xs)):
        assert torch.equal(g, w)


# ---- the dd entry's x split and y join (csrc/dd_split_join.cu) ----

F32_MAX = float(np.finfo(np.float32).max)
# signed zeros, subnormals of both widths, values that round to f32's
# largest and past it, infinities, NaN, halves that do not fit one f32
DD_SPECIAL = np.array([0.0, -0.0, 5e-324, -1e-310, 1e-45, -3e-39, F32_MAX,
                       F32_MAX * (1 + 2.0**-26), 3.5e38, -1e300, np.inf,
                       -np.inf, np.nan, 1 / 3, -2 / 3, 1 + 2.0**-30])
FEM3D_COLS = 648_000  # fem3d_cube's fem_3d(60, 60, 60, dof=3)


def _same_bits(got, want):
    """Bit for bit, NaN payloads aside: a NaN must be one in both."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    ints = torch.int32 if got.element_size() == 4 else torch.int64
    assert torch.equal(got.contiguous().view(ints)[~nan],
                       want.contiguous().view(ints)[~nan])


def _special_x(n, dev, seed=3):
    x = np.random.default_rng(seed).standard_normal(n)
    x[: min(n, DD_SPECIAL.size)] = DD_SPECIAL[:n]
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("ncols", [1000, FEM3D_COLS])
@pytest.mark.parametrize("outputs", [
    "pairs", "halves", "pairs+halves", "unpadded"])
def test_dd_prepare_x_matches_plain(outputs, ncols, dev):
    """dd_prepare_x against dd_prepare_x_plain (the PyTorch ops it
    replaces) bit for bit, for what each plan kind asks of it (pair bins
    alone, other bins alone, both; column panels' unpadded halves), on x
    with the special values, into a block torch.empty hands back full of
    NaN: every pad slot must come back +0."""
    pair, halves = {"pairs": (True, False), "halves": (False, True),
                    "pairs+halves": (True, True),
                    "unpadded": (False, True)}[outputs]
    rows = ncols if outputs == "unpadded" \
        else S.slab_table_rows(ncols) * 128
    x = _special_x(ncols, dev)
    torch.cuda.empty_cache()  # so the next block of this size is dirty's
    dirty = torch.full((rows * 2 * (pair + halves),), float("nan"),
                       device=dev)
    held = dirty.data_ptr()
    del dirty
    before = D.dd_prepare_x.launches
    got = D.dd_prepare_x(x, rows, pair=pair, halves=halves)
    torch.cuda.synchronize()
    assert D.dd_prepare_x.launches == before + 1
    assert next(t for t in got if t is not None).data_ptr() == held
    want = D.dd_prepare_x_plain(x, rows, pair, halves)
    for g, w, asked in zip(got, want, (pair, halves, halves)):
        assert (g is None) == (w is None) == (not asked)
        if g is not None:
            _same_bits(g, w)
            pad = g[ncols:]
            assert not pad.view(torch.int32).any()  # +0, not -0 or NaN


@pytest.mark.parametrize("n", [1, 1000, FEM3D_COLS])
def test_dd_join_y_matches_plain(n, dev):
    rng = np.random.default_rng(7)
    with np.errstate(over="ignore"):
        yh = np.concatenate([DD_SPECIAL, rng.standard_normal(n)])[:n]
        yl = np.concatenate([-DD_SPECIAL[::-1], rng.standard_normal(n)
                             * 2.0**-30])[:n]
        yh, yl = (torch.from_numpy(v.astype(np.float32)).to(dev)
                  for v in (yh, yl))
    before = D.dd_join_y.launches
    got = D.dd_join_y(yh, yl)
    torch.cuda.synchronize()
    assert D.dd_join_y.launches == before + 1
    _same_bits(got, D.dd_join_y_plain(yh, yl))
    with pytest.raises(ValueError, match="contiguous f32"):
        D.dd_join_y(yh.double(), yl)


# plan kind -> host SELL: pair bins alone, k-major alone, both, panels
F64_PLANS = {
    "pairs": lambda: SellMatrix.from_csr(CSRMatrix.from_coo(
        fem_3d(20, 20, 20, dof=3, seed=1)), layout="wl"),
    "k-major": lambda: SellMatrix.from_csr(CSRMatrix.from_coo(
        banded(5 * 1024, 24, 512, seed=0)), layout="k-major"),
    "mixed": lambda: SellMatrix.from_csr(CSRMatrix.from_coo(
        fem_3d(20, 20, 20, dof=3, seed=1))),
    "panels": lambda: PanelSellMatrix.from_csr(CSRMatrix.from_coo(
        fem_3d(10, 10, 10, dof=3, seed=0)), max_panel_cols=1024),
}


@pytest.mark.parametrize("plan", sorted(F64_PLANS))
def test_sell_spmv_dd_f64_equals_the_torch_composition(plan, dev):
    """sell_spmv_dd_f64 (the split and join kernels around the plan's
    launches) returns, bit for bit, the y of the PyTorch ops it replaced:
    ``x.float()``, ``(x - hi.double()).float()``, ``pack_x_table`` of each
    half (flat) and ``combine_f64`` of ``sell_spmv_dd`` /
    ``panel_sell_spmv_dd``; each call launches the two kernels once."""
    d = D.device_put_sell_dd(F64_PLANS[plan](), device=dev)
    pairs = {D._pairs(j.bin) for j in D._plan_of(d).launches}
    assert pairs == {"pairs": {True}, "k-major": {False}}.get(
        plan, {True, False})
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        d.ncols)).to(dev)
    xh = x.float()
    xl = (x - xh.double()).float()
    if plan == "panels":
        want = combine_f64(*D.panel_sell_spmv_dd(d, xh, xl))
    else:
        want = combine_f64(*D.sell_spmv_dd(d, S.pack_x_table(xh, d.ncols),
                                           S.pack_x_table(xl, d.ncols)))
    before = (D.dd_prepare_x.launches, D.dd_join_y.launches)
    got = D.sell_spmv_dd_f64(d, x)
    torch.cuda.synchronize()
    assert (D.dd_prepare_x.launches, D.dd_join_y.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float64 and torch.equal(got, want)


def test_sell_spmv_dd_f64_pairs_launch_three_kernels(dev, tmp_path):
    """A plan of pair bins alone that covers every group (fem3d_cube's
    kind): one call is dd_prepare_x, the plan's one joint launch and
    dd_join_y, by the wrappers' counts and by the profiler's device
    events: no other kernel, copy or fill."""
    import json

    from torch.profiler import ProfilerActivity, profile

    d = D.device_put_sell_dd(F64_PLANS["pairs"](), device=dev)
    assert d.plan.kernels == 1 and d.plan.covered == d.num_groups
    x = torch.randn(d.ncols, dtype=torch.float64, device=dev)
    D.sell_spmv_dd_f64(d, x)
    torch.cuda.synchronize()
    ws = {**{k: w[0] for k, w in DD_WRAPPERS.items()},
          "prepare": D.dd_prepare_x, "join": D.dd_join_y}
    before = _counted(ws)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        D.sell_spmv_dd_f64(d, x)
        torch.cuda.synchronize()
    assert _counted(ws) - before == 3
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())
    device = [e["name"] for e in events.get("traceEvents", events)
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert device, "the profiler recorded no device activity"
    assert len(device) == 3, device
    assert sum("prepare_x" in n for n in device) == 1
    assert sum("join_y" in n for n in device) == 1


# ---- heavy-tailed rows: the row-order rule's row map (csrc/row_map.cu) ----

def _row_map(n, dev, seed):
    """A row map over n rows: a third with no segment, most with one, a few
    with up to 300, their positions a permutation of the sorted y."""
    g = torch.Generator().manual_seed(seed)
    count = (torch.rand(n, generator=g) >= 1 / 3).to(torch.int64)
    heavy = torch.randint(0, n, (max(1, n // 500),), generator=g)
    count[heavy] = torch.randint(2, 300, (heavy.numel(),), generator=g)
    ptr = torch.zeros(n + 1, dtype=torch.int64)
    ptr[1:] = count.cumsum(0)
    pos = torch.randperm(int(ptr[-1]), generator=g)
    return S.RowMap(ptr.to(torch.int32).to(dev), pos.to(torch.int32).to(dev),
                    int(ptr[-1]))


@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_row_gather_matches_plain(n, dev):
    """row_gather and row_gather_dd against their plain versions bit for
    bit: rows of no segment (+0, whatever src holds), of one, and of up to
    300 added in order; src with signed zeros, and NaN past what the map
    reads."""
    rm = _row_map(n, dev, n)
    m = int(rm.ptr[-1])
    g = torch.Generator().manual_seed(n + 1)
    src = torch.full((m + 300,), float("nan"))
    src[:m] = torch.randn(m, generator=g)
    src[: min(m, 7)] = -0.0
    lo = src * 2.0**-30
    src, lo = src.to(dev), lo.to(dev)
    before = (S.row_gather.launches, S.row_gather_dd.launches)
    got = S.row_gather(src, rm)
    got_dd = S.row_gather_dd(src, lo, rm)
    torch.cuda.synchronize()
    assert (S.row_gather.launches, S.row_gather_dd.launches) == (
        before[0] + 1, before[1] + 1)
    _same_bits(got, S.row_gather_plain(src, rm))
    for g_, w in zip(got_dd, S.row_gather_dd_plain(src, lo, rm)):
        _same_bits(g_, w)
    empty = (rm.ptr[1:] == rm.ptr[:-1])
    assert not got[empty].view(torch.int32).any()


def _kron_csr(scale, seed=3):
    from sparsematrixvectormultiplication_tpu_torch.models import (
        kron_pagerank_reference as KR)

    n, row, col = KR.kron_graph(scale, 16, seed)
    val, dangling = KR.transition(n, row, col)
    csr = CSRMatrix.from_coo(COOMatrix(
        n, n, row.to(torch.int32).numpy(), col.to(torch.int32).numpy(),
        val.numpy()))
    return KR, (n, row, col, val, dangling), csr


def test_kron_spmv_through_the_row_map(dev):
    """GAP's kron graph (SCALE 15) converted by the row-order rule (heavy
    rows split, rows sorted): the kernels' y in the caller's order equals
    the plain versions' bit for bit, and the sorted container's y gathered
    by segments; rows with no entry +0; one gather launch more than the
    sorted container's. In double-double, the pair gathered by
    row_gather_dd, within fp64 rounding of the oracle."""
    import dataclasses as dc

    _, (n, *_, dangling), csr = _kron_csr(15)
    ruled = SellMatrix.from_csr(csr)
    assert ruled.row_map is not None
    d = S.device_put_sell(ruled, device=dev)
    ds = S.device_put_sell(dc.replace(ruled, row_map=None), device=dev)
    x = torch.randn(n, device=dev)
    tab = S.pack_x_table(x, n)
    before = S.row_gather.launches
    y = S.sell_spmv(d, tab)
    torch.cuda.synchronize()
    assert S.row_gather.launches == before + 1
    _same_bits(y, S.sell_spmv_plain(d, tab))
    _same_bits(y, S.row_gather_plain(S.sell_spmv(ds, tab), d.row_map))
    assert not y[dangling.to(dev)].view(torch.int32).any()
    assert S.sell_spmv_launches(d) == S.sell_spmv_launches(ds) + 1
    want = csr.spmv(x.cpu().double().numpy())
    _close(y.cpu().double(), torch.from_numpy(want))
    dd = D.device_put_sell_dd(ruled, device=dev)
    y64 = D.sell_spmv_dd_f64(dd, x.double())
    np.testing.assert_allclose(y64.cpu().numpy(), want, rtol=1e-12,
                               atol=1e-12)


def test_kron_pagerank_on_the_card(dev):
    """The port's PageRank through the kernels against the plain fp64
    reference after as many iterations (L1 within 1e-5: f32 rounding
    grows the gap some 1e-7 an iteration)."""
    KR, (n, row, col, val, dangling), csr = _kron_csr(15)
    d = S.device_put_sell(SellMatrix.from_csr(csr), device=dev)
    tab = S.pack_x_table(torch.zeros(n, device=dev), n)

    def matvec(v):
        tab[:n].copy_(v)
        return S.sell_spmv(d, tab)

    p, iters, _ = SV.pagerank(matvec, dangling.float().to(dev), alpha=0.85,
                              tol=1e-4, maxiter=20)
    want, _, _ = KR.pagerank(n, row.to(dev), col.to(dev), val.to(dev),
                             dangling.to(dev), tol=-1, maxiter=iters)
    assert float((p.double() - want).abs().sum()) < 1e-5


def test_graphed_kron_pagerank_on_the_card(dev):
    """``GraphedPageRank`` captures one iteration (the kernels' matvec
    through the row map, the update) and replays it: each solve equals
    ``pagerank``'s on the same matvec bit for bit, iterations and move too,
    solve after solve, capped or not; a replay launches nothing from the
    host, so the wrappers' launch counts stay where the capture left
    them."""
    _, (n, *_, dangling), csr = _kron_csr(15)
    d = S.device_put_sell(SellMatrix.from_csr(csr), device=dev)
    tab = S.pack_x_table(torch.zeros(n, device=dev), n)

    def matvec(v):
        tab[:n].copy_(v)
        return S.sell_spmv(d, tab)

    mask = dangling.float().to(dev)
    solver = SV.GraphedPageRank(matvec, mask, alpha=0.85)
    assert solver.graph is not None
    held = S.row_gather.launches
    for maxiter in (20, 4, 20):
        got = solver(tol=1e-4, maxiter=maxiter)
        assert S.row_gather.launches == held
        want = SV.pagerank(matvec, mask, alpha=0.85, tol=1e-4,
                           maxiter=maxiter)
        held = S.row_gather.launches
        assert got[1] == want[1] and (maxiter == 4) is (got[1] == 4)
        _same_bits(got[0], want[0])
        _same_bits(got[2], want[2])

