"""The port's sb-major, sb-list and sg bins, accumulate assembly and column
panels against the JAX package.

The JAX side runs ``sell_spmv_pallas(..., interpret=True)`` on its own host
``SellMatrix``; the port uploads that same host object and runs it on the
CPU, where every wrapper takes its plain PyTorch version. The int16 sb
planes are selected with ``SPMV_SB_I16=1`` on the JAX side and with
``sb_i16=True`` on the port's. Tolerance: rtol=1e-5, atol=1e-5*max|y| —
both sum in f32, in another order.
"""

import dataclasses

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
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    _pack_sb_i16,
    _pack_sl_i16,
    device_put_sell as jax_device_put_sell,
    sell_spmv_pallas,
)
from sparsematrixvectormultiplication_tpu_torch import (
    CSRMatrix,
    PanelSellMatrix,
    SellMatrix,
)
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S

RTOL = 1e-5
ATOL_REL = 1e-5


def _x(n, seed=11):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


def _banded():
    return JCSR.from_coo(jsyn.banded(4096, 24, 512, seed=0))


def _road():
    # as tests/test_sg.py runs it in interpret mode
    return JCSR.from_coo(jsyn.road_network(8000, seed=5)).split_heavy_rows(
        256)[0]


# case -> (JAX CSR, SellMatrix.from_csr keywords, int16 sb planes, layouts)
CASES = {
    "sb-major": (_banded, dict(layout="sb-major"), False, {"sb-major"}),
    "sb-list": (_banded, dict(layout="sb-list"), False, {"sb-list"}),
    "sb-major-i16": (_banded, dict(layout="sb-major"), True, {"sb-major"}),
    "sb-list-i16": (_banded, dict(layout="sb-list"), True, {"sb-list"}),
    "sg-slots": (_road, dict(layout="sg"), False, {"sg", "k-major"}),
    "sg-rows": (_road, dict(layout="sg", sg_slots=False), False,
                {"sg", "k-major"}),
}


@pytest.fixture(scope="module")
def host_sells():
    return {name: JSell.from_csr(make(), **kw)
            for name, (make, kw, _, _) in CASES.items()}


def _jax_y(sell, x, i16, monkeypatch):
    monkeypatch.setenv("SPMV_SB_I16", "1" if i16 else "0")
    return np.asarray(sell_spmv_pallas(
        jax_device_put_sell(sell, jnp.float32), jnp.asarray(x),
        interpret=True))


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_pallas_interpret(case, host_sells, monkeypatch):
    _, _, i16, layouts = CASES[case]
    sell = host_sells[case]
    assert {b.layout for b in sell.bins} == layouts
    x = _x(sell.ncols)
    y_ref = _jax_y(sell, x, i16, monkeypatch)
    d = S.device_put_sell(sell, device="cpu", sb_i16=i16)
    sb = [b for b in d.bins if b.layout in ("sb-major", "sb-list")]
    assert all(b.ja.dtype == (torch.int16 if i16 else torch.int32)
               for b in sb)
    x_tab = S.device_put_x(x, sell.ncols, device="cpu")
    _close(S.sell_spmv(d, x_tab), y_ref)
    _close(S.sell_spmv_plain(d, x_tab), y_ref)


def test_sg_cases_cover_far_bins_and_both_tables(host_sells):
    """road's sg conversion has add_into far bins and both the static
    (span > 0) and the dynamic (span == 0) window tables."""
    for case in ("sg-slots", "sg-rows"):
        bins = host_sells[case].bins
        assert any(b.add_into and b.layout == "k-major" for b in bins)
        assert {b.span > 0 for b in bins if b.layout == "sg"} == {True, False}
        assert {b.sg_slots for b in bins if b.layout == "sg"} == {
            case == "sg-slots"}


@pytest.mark.parametrize("layout", ["sb-major", "sb-list"])
def test_int16_planes_bit_identical_to_jax(layout, host_sells, monkeypatch):
    sell = host_sells[layout]
    pack = {"sb-major": (S._pack_sb_i16, _pack_sb_i16),
            "sb-list": (S._pack_sl_i16, _pack_sl_i16)}[layout]
    monkeypatch.setenv("SPMV_SB_I16", "1")
    theirs = jax_device_put_sell(sell, jnp.float32)
    mine = S.device_put_sell(sell, device="cpu", sb_i16=True)
    for h, jb, b in zip(sell.bins, theirs.bins, mine.bins):
        args = (np.asarray(h.ja), np.asarray(h.slab_list), h.n_groups, h.k,
                h.chunk_k, h.span)
        want = pack[1](*args)
        assert np.array_equal(pack[0](*args), want)
        assert b.ja.dtype == torch.int16
        assert np.array_equal(b.ja.numpy(), want)
        assert np.array_equal(b.ja.numpy(), np.asarray(jb.ja))
        assert b.ja.numel() == b.as_.numel() and b.ja.element_size() == 2


def test_int16_pad_reads_no_x():
    """A pad (dq = -1) on qbase 0 would name column m-128; the plain version
    skips it, and NaN in x shows any read."""
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(syn.banded(2048, 8, 64)),
                               layout="sb-major")
    d = S.device_put_sell(sell, device="cpu", sb_i16=True)
    (b,) = d.bins
    ja = b.ja.clone()
    ja[0, 0] = (-1 << 7) | 5  # row 0's first entry becomes a pad
    b.as_[0, 0] = 0.0
    b.ja = ja
    x = torch.ones(S.slab_table_rows(sell.ncols) * 128)
    x[-128:] = float("nan")  # column m-128 wraps to the tail in torch
    y = S.sb_major_bin_plain(b, x)
    assert torch.isfinite(y).all()


PANELS = {
    # tests/test_panels.py's shape: 3000 x 9000 at 0.2%, 2048-column panels
    "random": (lambda m: m.random_general(3000, 9000, 0.002, seed=3), 2048,
               {"k-major"}),
    "fem": (lambda m: m.fem_3d(10, 10, 10, dof=3, seed=0), 1024,
            {"k-major", "wl"}),
}


@pytest.mark.parametrize("name", sorted(PANELS))
def test_panels_match_pallas_interpret(name):
    make, width, layouts = PANELS[name]
    psell = JPanel.from_csr(JCSR.from_coo(make(jsyn)), max_panel_cols=width)
    assert len(psell.panels) >= 3
    assert {b.layout for p in psell.panels for b in p.bins} == layouts
    x = _x(psell.ncols, seed=5)
    y_ref = np.asarray(sell_spmv_pallas(
        jax_device_put_sell(psell, jnp.float32), jnp.asarray(x),
        interpret=True))
    dps = S.device_put_sell(psell, device="cpu")
    assert isinstance(dps, S.DevicePanelSell)
    _close(S.panel_sell_spmv(dps, torch.from_numpy(x)), y_ref)
    _close(S.panel_sell_spmv_plain(dps, torch.from_numpy(x)), y_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_panels_against_fp64_oracle(dtype):
    from sparsematrixvectormultiplication_tpu_torch.bench.harness import (
        quantize_bf16,
    )
    from sparsematrixvectormultiplication_tpu_torch.utils.validation import (
        difference_metrics,
    )

    csr = CSRMatrix.from_coo(syn.fem_3d(10, 10, 10, dof=3, seed=0))
    psell = PanelSellMatrix.from_csr(csr, max_panel_cols=1024)
    x = np.random.default_rng(4).standard_normal(csr.ncols)
    y = S.panel_sell_spmv(S.device_put_sell(psell, dtype, device="cpu"),
                          torch.from_numpy(x.astype(np.float32))).numpy()
    vals = csr.values if dtype == torch.float32 else quantize_bf16(csr.values)
    ref = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                    vals).spmv(x.astype(np.float32).astype(np.float64))
    assert difference_metrics(ref, y).significant_diffs == 0


def test_panel_spmv_checks_its_inputs():
    csr = CSRMatrix.from_coo(syn.banded(2048, 8, 64))
    dps = S.device_put_sell(PanelSellMatrix.from_csr(csr, max_panel_cols=1024),
                            device="cpu")
    d = S.device_put_sell(SellMatrix.from_csr(csr), device="cpu")
    with pytest.raises(ValueError, match="f32 vector of 2048"):
        S.panel_sell_spmv(dps, torch.ones(2048, dtype=torch.float64))
    with pytest.raises(TypeError, match="panel_sell_spmv"):
        S.sell_spmv(dps, S.device_put_x(np.ones(2048), 2048, device="cpu"))
    with pytest.raises(TypeError, match="DevicePanelSell"):
        S.panel_sell_spmv(d, torch.ones(2048))


def test_accumulate_adds_onto_y():
    """Every wrapper adds its rows onto y with accumulate=True, and stores
    them otherwise; the launch counters stay untouched on the CPU."""
    csr = JCSR.from_coo(jsyn.road_network(8000, seed=5))
    sell = JSell.from_csr(csr)
    d = S.device_put_sell(sell, device="cpu")
    x_tab = S.device_put_x(_x(sell.ncols), sell.ncols, device="cpu")
    before = {k: (w.launches, w.accumulating) for k, w in S._KERNEL.items()}
    for b in d.bins:
        wrapper = S._KERNEL[b.layout]
        base = torch.arange(d.num_groups * 1024, dtype=torch.float32)
        y = base.clone()
        wrapper(b, x_tab, y, accumulate=True)
        rows = y.view(-1, 8, 128)[b.group_ids.long()]
        plain = S._PLAIN[b.layout](b, x_tab)
        assert torch.equal(
            rows, base.view(-1, 8, 128)[b.group_ids.long()] + plain)
        wrapper(b, x_tab, y)
        assert torch.equal(y.view(-1, 8, 128)[b.group_ids.long()], plain)
    assert {b.layout for b in d.bins} >= {"sg", "k-major"}
    assert before == {k: (w.launches, w.accumulating)
                      for k, w in S._KERNEL.items()}


def test_sg_plain_ignores_padding_tiles():
    """Tiles past slab_count are padding: the padded plain version reads
    none of them, as the tile kernel bounds its tile loop by the real count,
    and the compacted upload keeps none of them."""
    sell = JSell.from_csr(_road(), layout="sg")
    i, h = next((i, b) for i, b in enumerate(sell.bins)
                if b.layout == "sg" and int(np.min(b.slab_count)) < b.k)
    x_tab = S.device_put_x(_x(sell.ncols), sell.ncols, device="cpu")
    want = S.sg_padded_plain(h, x_tab)
    want_compact = S.sg_bin_plain(S.device_put_sell(sell, device="cpu")
                                  .bins[i], x_tab)
    g = int(np.argmin(h.slab_count))
    t = int(np.asarray(h.slab_count).reshape(-1)[g])
    vals = np.array(h.as_).reshape(h.n_groups, h.k, 8, 128)
    vals[g, t:] = float("nan")  # padding tiles: never multiplied in
    h = dataclasses.replace(h, as_=vals.reshape(np.shape(h.as_)))
    assert torch.equal(S.sg_padded_plain(h, x_tab), want)
    nan = dataclasses.replace(sell, bins=[h if j == i else b
                                          for j, b in enumerate(sell.bins)])
    assert torch.equal(S.sg_bin_plain(S.device_put_sell(nan, device="cpu")
                                      .bins[i], x_tab), want_compact)
