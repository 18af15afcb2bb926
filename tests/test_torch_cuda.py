"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false. Run on a GPU machine with ``python -m pytest tests/test_torch_cuda.py``.
Tolerance: rtol=1e-5, atol=1e-5*max|y| (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu_torch import (
    CSRMatrix,
    PanelSellMatrix,
    SellMatrix,
    run_matrix,
)
from sparsematrixvectormultiplication_tpu_torch.bench.harness import BenchConfig
from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
    banded,
    fem_3d,
    road_network,
)
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
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
    before = S.wl_bin.accumulating
    _close(S.panel_sell_spmv(dps, x), S.panel_sell_spmv_plain(dps, x))
    assert S.wl_bin.accumulating > before


def test_run_matrix_on_cuda(dev):
    coo = fem_3d(20, 20, 20, dof=3, seed=1)
    before = (S.k_major_bin.launches, S.wl_bin.launches)
    res = run_matrix("fem20", coo, BenchConfig(iterations=3, skip=1),
                     x=np.random.default_rng(3).standard_normal(coo.ncols),
                     log=lambda m: None, device=dev)
    for name in ("sell", "sell_bf16"):
        assert res.stages[name].diff.significant_diffs == 0, name
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
