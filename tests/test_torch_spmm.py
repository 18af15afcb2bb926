"""The port's multi-RHS SELL SpMM (ops/sell_spmm.py) and the SpMM stages of
run_matrix against the JAX package.

On the CPU the wrappers run the plain PyTorch versions of the CUDA kernels;
those are held against ``sell_spmm_pallas(..., interpret=True)`` on the same
host SELL at rtol=1e-5, atol=1e-5*max|Y| (both sum in f32, in another
order). The JAX wl SpMM kernel reads unpacked lane offsets, so its side of
the wl comparison runs with ``SPMV_WL_PACK=0``; the port's side uses its
own upload, whose wl planes are compacted.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.formats.bsr import BSRMatrix as JBSR
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.formats.sell import (
    PanelSellMatrix as JPanelSell,
    SellMatrix as JSell,
)
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops.pallas_bsr import (
    bsr_spmm_pallas,
    device_put_bsr as jax_device_put_bsr,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    device_put_sell as jax_device_put_sell,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_sell_spmm import (
    pack_x_multi as jax_pack_x_multi,
    sell_spmm_pallas,
)
from sparsematrixvectormultiplication_tpu_torch import (
    BSRMatrix,
    COOMatrix,
    CSRMatrix,
    SellMatrix,
    run_matrix,
)
from sparsematrixvectormultiplication_tpu_torch.bench.harness import BenchConfig
from sparsematrixvectormultiplication_tpu_torch.formats.sell import (
    slab_table_rows,
)
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import bsr as BSR
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_spmm as SM


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _X(n, r, seed=0):
    return np.random.default_rng(seed).standard_normal((n, r))


def _jax_spmm(jsell, X, dtype=jnp.float32):
    d = jax_device_put_sell(jsell, dtype=dtype, resident=False)
    return np.asarray(sell_spmm_pallas(d, jnp.asarray(X, jnp.float32),
                                       interpret=True))


def _port_spmm(sell, X, dtype=torch.float32):
    d = S.device_put_sell(sell, dtype, device="cpu")
    return SM.sell_spmm(d, torch.from_numpy(X)).numpy()


@pytest.mark.parametrize("r", [1, 5, 16])
def test_pack_x_multi_matches_jax_table(r):
    """The port's table is the JAX stacked tables transposed: row c holds
    X[c, :R], rows of R rounded up to 4 floats."""
    X = _X(1000, r, 1).astype(np.float32)
    want = np.asarray(jax_pack_x_multi(X, 1000)).reshape(r, -1).T
    tab = SM.pack_x_multi(torch.from_numpy(X), 1000)
    assert tab.dtype == torch.float32
    assert tuple(tab.shape) == want.shape == (slab_table_rows(1000) * 128, r)
    assert tab.stride() == (-(-r // 4) * 4, 1)
    np.testing.assert_array_equal(tab.numpy(), want)
    assert torch.equal(SM.device_put_x_multi(X, 1000, device="cpu"), tab)


@pytest.mark.parametrize("r", [1, 8, 16])
def test_k_major_matches_pallas_interpret(r):
    """The JAX tests' banded case, on the same host SELL."""
    jsell = JSell.from_csr(JCSR.from_coo(jsyn.banded(3000, 9, 30, seed=1)),
                           layout="k-major")
    X = _X(jsell.ncols, r)
    want = _jax_spmm(jsell, X)
    got = _port_spmm(jsell, X)
    assert got.shape == want.shape == (3000, r)
    _close(got, want)


def test_bf16_values_match_pallas_interpret():
    jsell = JSell.from_csr(JCSR.from_coo(jsyn.banded(2000, 9, 30, seed=3)),
                           layout="k-major")
    X = _X(jsell.ncols, 8, 3)
    _close(_port_spmm(jsell, X, torch.bfloat16),
           _jax_spmm(jsell, X, jnp.bfloat16))


def test_big_k_matches_pallas_interpret():
    """A power-law head gives a K > 64 bin (the JAX kernel's rolled
    reduction)."""
    jsell = JSell.from_csr(JCSR.from_coo(jsyn.power_law(3000, 12, 2.3,
                                                       seed=5)),
                           layout="k-major")
    assert any(b.k > 64 for b in jsell.bins)
    X = _X(jsell.ncols, 8, 2)
    _close(_port_spmm(jsell, X), _jax_spmm(jsell, X))


def test_panels_match_pallas_interpret():
    jps = JPanelSell.from_csr(JCSR.from_coo(jsyn.banded(3000, 9, 400,
                                                        seed=7)),
                              max_panel_cols=1024, layout="k-major")
    assert len(jps.panels) >= 3
    X = _X(jps.ncols, 4, 6)
    want = np.asarray(sell_spmm_pallas(
        jax_device_put_sell(jps, dtype=jnp.float32, resident=False),
        jnp.asarray(X, jnp.float32), interpret=True))
    got = _port_spmm(jps, X)
    _close(got, want)
    csr = CSRMatrix.from_coo(syn.banded(3000, 9, 400, seed=7))
    ref = np.column_stack([csr.spmv(X[:, j]) for j in range(4)])
    _close(got, ref)


@pytest.mark.parametrize("r", [1, 2])
def test_wl_matches_pallas_interpret_unpacked(r, monkeypatch):
    """The port's wl SpMM on its compacted upload against the JAX kernel on
    the unpacked plane it reads (SPMV_WL_PACK=0); both against the
    oracle."""
    jsell = JSell.from_csr(JCSR.from_coo(jsyn.banded(1024, 18, 40, seed=2)),
                           layout="wl")
    assert [(b.layout, b.k) for b in jsell.bins] == [("wl", 48)]
    X = _X(jsell.ncols, r, 5)
    got = _port_spmm(jsell, X)
    d = S.device_put_sell(jsell, device="cpu")
    b = d.bins[0]  # compacted: a 2-byte code a real slot
    assert b.ja.dtype == torch.int16 and b.ja.numel() == b.as_.numel()
    monkeypatch.setenv("SPMV_WL_PACK", "0")
    want = _jax_spmm(jsell, X)
    _close(got, want)
    csr = CSRMatrix.from_coo(syn.banded(1024, 18, 40, seed=2))
    _close(got, np.column_stack([csr.spmv(X[:, j]) for j in range(r)]))


def test_sigma_sorted_rows_and_add_into():
    """A SELL-sigma conversion: the result comes in the SELL's row order,
    as the JAX function returns it."""
    csr = CSRMatrix.from_coo(syn.power_law(4000, 2, seed=6))
    sell = SellMatrix.from_csr(csr, layout="k-major", sigma_sort=True)
    assert sell.row_perm is not None
    X = _X(csr.ncols, 3, 7)
    got = _port_spmm(sell, X)
    ref = np.column_stack([csr.spmv(X[:, j]) for j in range(3)])
    _close(got, ref[sell.row_perm])


def test_packed_table_and_raw_x_agree():
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(syn.fem_3d(8, 8, 8, dof=3)))
    assert {b.layout for b in sell.bins} == {"k-major", "wl"}
    d = S.device_put_sell(sell, device="cpu")
    X = torch.from_numpy(_X(sell.ncols, 6, 8)).float()
    y_raw = SM.sell_spmm(d, X)
    assert tuple(y_raw.shape) == (sell.nrows, 6)
    assert torch.equal(y_raw, SM.sell_spmm(d, SM.pack_x_multi(X, sell.ncols)))
    assert torch.equal(y_raw, SM.sell_spmm_plain(d, X))
    # each column against the SpMV plain versions (the same f32 products)
    for j in range(6):
        y = S.sell_spmv(d, S.pack_x_table(X[:, j], sell.ncols))
        torch.testing.assert_close(y_raw[:, j], y, rtol=1e-5,
                                   atol=1e-5 * float(y.abs().max()))


def _wl_sell(drop_lane0=False):
    """The all-wl SELL of ``banded(1024, 18, 40, seed=2)`` (one group); with
    ``drop_lane0`` without the entries of columns 128*s, so that the column
    code 0 names in each block is no real slot's."""
    coo = syn.banded(1024, 18, 40, seed=2)
    if drop_lane0:
        keep = coo.col % 128 != 0
        coo = COOMatrix(coo.nrows, coo.ncols, coo.row[keep], coo.col[keep],
                        coo.val[keep])
    csr = CSRMatrix.from_coo(coo)
    sell = SellMatrix.from_csr(csr, layout="wl")
    assert {b.layout for b in sell.bins} == {"wl"}
    return csr, S.device_put_sell(sell, device="cpu")


@pytest.mark.parametrize("r", [8, 16])
def test_x_table_is_the_raw_x_on_all_wl_sells(r):
    """An all-wl SELL reads a contiguous f32 X in place: no table is
    packed, and Y equals the packed table's bit for bit."""
    _, d = _wl_sell()
    X = torch.from_numpy(_X(d.ncols, r, 10)).float()
    tab = SM._x_table(d, X)
    assert tab is X and tab.data_ptr() == X.data_ptr()
    assert torch.equal(SM.sell_spmm(d, X),
                       SM.sell_spmm(d, SM.pack_x_multi(X, d.ncols)))


# case -> (the SELL, X): each needs the packed table
PACKED_CASES = {
    "r6": lambda: (_wl_sell()[1], _X(1024, 6, 11)),
    "k-major": lambda: (S.device_put_sell(SellMatrix.from_csr(
        CSRMatrix.from_coo(syn.fem_3d(8, 8, 8, dof=3))), device="cpu"),
        _X(1536, 8, 12)),
    "strided": lambda: (_wl_sell()[1], _X(16, 1024, 13).T),
}


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_x_table_packs_otherwise(case):
    """R not a multiple of 4, a SELL with a k-major bin, or an X whose rows
    are not unit-stride: the raw X is packed into the padded table, and Y
    equals the packed table's bit for bit."""
    d, X = PACKED_CASES[case]()
    X = torch.from_numpy(X).float()
    tab = SM._x_table(d, X)
    assert tab.shape == (slab_table_rows(d.ncols) * 128, X.shape[1])
    assert tab.data_ptr() != X.data_ptr()
    assert torch.equal(SM.sell_spmm(d, X),
                       SM.sell_spmm(d, SM.pack_x_multi(X, d.ncols)))


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_wl_tail_slots_add_nothing(bad):
    """Slots past a row's length hold value 0 and code 0: with x = inf or
    NaN at every column code 0 names (no real slot's) and at the padded
    table's rows past ncols, y stays finite and equal to the oracle, from
    the raw X and from the table."""
    csr, d = _wl_sell(drop_lane0=True)
    b = d.bins[0]
    assert int(b.row_len.min()) < int(b.row_len.max())  # rows have tails
    X = _X(csr.ncols, 8, 14)
    want = np.column_stack([csr.spmv(X[:, j]) for j in range(8)])
    X[::128] = bad
    Xt = torch.from_numpy(X).float()
    tab = SM.pack_x_multi(Xt, csr.ncols)
    tab[csr.ncols:] = bad
    for x in (Xt, tab):
        y = SM.sell_spmm(d, x)
        assert torch.isfinite(y).all()
        _close(y, want)


@pytest.mark.parametrize("layout", ["wl", "k-major"])
def test_spmm_sweep_counts_each_entry_once(layout, monkeypatch):
    """bench/spmm_sweep.py's bound counts every real entry once, each x row
    a bin reads and each y row it writes, and the sweep refuses to run
    without a card."""
    from sparsematrixvectormultiplication_tpu_torch.bench import spmm_sweep
    csr = CSRMatrix.from_coo(syn.fem_3d(8, 8, 8, dof=3, seed=1))
    d = S.device_put_sell(SellMatrix.from_csr(csr, layout=layout),
                          device="cpu")
    counts = [spmm_sweep.bin_counts(b) for b in d.bins]
    assert sum(c[0] for c in counts) == csr.nnz
    assert sum(c[2] for c in counts) == csr.nrows  # every row has entries
    assert all(c[1] <= csr.ncols for c in counts)
    nnz, n_x, n_y = counts[0]
    ms, by = spmm_sweep.bound(nnz, n_x, n_y, 16, 4, 2)
    assert by == "bytes"
    assert ms == pytest.approx((nnz * 6 + 64 * (n_x + n_y)) / 3.35e9)
    assert spmm_sweep.main(["--rhs"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert spmm_sweep.main([]) == 1


def test_cpu_tensors_run_plain_without_launching():
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(syn.fem_3d(8, 8, 8, dof=3)))
    d = S.device_put_sell(sell, device="cpu")
    counts = lambda: [(w.launches, w.accumulating)  # noqa: E731
                      for w in SM._KERNEL.values()]
    before = counts()
    SM.sell_spmm(d, torch.ones(sell.ncols, 3))
    assert counts() == before


def test_guards_raise():
    csr = CSRMatrix.from_coo(syn.banded(500, 5, 10, seed=0))
    with pytest.raises(ValueError, match="MAX_RHS"):
        SM.pack_x_multi(torch.ones(csr.ncols, SM.MAX_RHS + 1), csr.ncols)
    d = S.device_put_sell(SellMatrix.from_csr(csr, layout="k-major"),
                          device="cpu")
    with pytest.raises(ValueError, match="MAX_RHS"):
        SM.sell_spmm(d, torch.ones(csr.ncols, SM.MAX_RHS + 1))
    with pytest.raises(ValueError, match="raw"):
        SM.sell_spmm(d, torch.ones(csr.ncols + 1, 2))
    with pytest.raises(TypeError, match="DeviceSell"):
        SM.sell_spmm(d.bins[0], torch.ones(csr.ncols, 2))
    for layout in ("sb-major", "sb-list"):
        dl = S.device_put_sell(SellMatrix.from_csr(csr, layout=layout),
                               device="cpu")
        with pytest.raises(NotImplementedError, match="k-major"):
            SM.sell_spmm(dl, torch.ones(csr.ncols, 2))
    road = CSRMatrix.from_coo(syn.road_network(8000, seed=5))
    dsg = S.device_put_sell(SellMatrix.from_csr(road, layout="sg"),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="k-major"):
        SM.sell_spmm(dsg, torch.ones(road.ncols, 2))


@pytest.mark.parametrize("layout", sorted(SM._KERNEL))
def test_wrapper_raises_off_cpu_and_cuda(layout):
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(syn.fem_3d(8, 8, 8, dof=3)))
    b = next(b for b in S.device_put_sell(sell, device="meta").bins
             if b.layout == layout)
    x_tab = torch.zeros(slab_table_rows(sell.ncols) * 128, 4, device="meta")
    y = torch.zeros(sell.num_groups * 1024, 4, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        SM._KERNEL[layout](b, x_tab, y)


def test_slice_matches_jax_pipeline():
    """Same seed through both packages' generator -> CSR -> k-major SELL and
    128x128 BSR -> upload -> SpMM; the JAX side runs its Pallas kernels in
    interpret mode."""
    X = _X(3000, 8, 9)
    jcsr = JCSR.from_coo(jsyn.banded(3000, 9, 30, seed=4))
    csr = CSRMatrix.from_coo(syn.banded(3000, 9, 30, seed=4))
    want = _jax_spmm(JSell.from_csr(jcsr, layout="k-major"), X)
    _close(_port_spmm(SellMatrix.from_csr(csr, layout="k-major"), X), want)
    want_bsr = np.asarray(bsr_spmm_pallas(
        jax_device_put_bsr(JBSR.from_csr(jcsr)), jnp.asarray(X, jnp.float32),
        interpret=True))
    got_bsr = BSR.bsr_spmm(BSR.device_put_bsr(BSRMatrix.from_csr(csr),
                                              device="cpu"),
                           torch.from_numpy(X))
    _close(got_bsr, want_bsr, 2e-5)


# matrix -> (generator, the k-major SELL's row order is sigma-sorted)
STAGE_MATRICES = {
    # short rows: heavy rows split into segments that index_add_ reduces
    "entry_banded": (lambda: syn.banded(8192, 24, 512, seed=0), False),
    "fem_mixed": (lambda: syn.fem_3d(8, 8, 8, dof=3, seed=1), False),
    "power_law": (lambda: syn.power_law(4000, 2, seed=6), True),
}


@pytest.mark.parametrize("matrix", sorted(STAGE_MATRICES))
def test_run_matrix_spmm_stages(matrix):
    make, sigma = STAGE_MATRICES[matrix]
    coo = make()
    logs = []
    res = run_matrix(matrix, coo,
                     BenchConfig(iterations=1, skip=0, sell_spmm_rhs=8,
                                 spmm_rhs=24,
                                 stages=("sell_spmm", "bsr_spmm")),
                     log=logs.append, device="cpu")
    assert tuple(res.stages) == ("serial_csr", "sell_spmm", "bsr_spmm")
    assert not res.skipped
    assert {b.layout for b in res.sell_spmm.bins} == {"k-major"}
    assert (res.sell_spmm.row_perm is not None) == sigma
    assert res.bsr is not None and res.bsr.nnz == coo.nnz
    for stage, rhs in (("sell_spmm", 8), ("bsr_spmm", 24)):
        st = res.stages[stage]
        assert st.diff.significant_diffs == 0, (stage, st.diff)
        assert st.rhs == rhs and st.norm_err < 1e-5
        assert st.gflops > 0
    assert any("bsr_spmm" in m and "fill" in m for m in logs)


def test_run_matrix_records_bsr_skip():
    """A scattered matrix whose blocks exceed the 2 GiB budget skips the
    bsr_spmm stage with the reason; the other stages still run."""
    coo = syn.random_general(30_000, 30_000, 1e-3, seed=3)
    res = run_matrix("scattered", coo,
                     BenchConfig(iterations=1, skip=0, sell_spmm_rhs=4,
                                 stages=("sell", "sell_spmm", "bsr_spmm")),
                     log=lambda m: None, device="cpu")
    assert tuple(res.stages) == ("serial_csr", "sell", "sell_spmm")
    assert "budget" in res.skipped["bsr_spmm"]
    assert res.bsr is None
    assert res.stages["sell_spmm"].diff.significant_diffs == 0


def test_stage_failure_raises(monkeypatch):
    """A failure other than the budget propagates from the SpMM stages."""
    from sparsematrixvectormultiplication_tpu_torch.bench import harness

    def broken(*a, **k):
        raise RuntimeError("upload failed")

    monkeypatch.setattr(harness, "device_put_bsr", broken)
    coo = syn.banded(2000, 9, 30, seed=1)
    with pytest.raises(RuntimeError, match="upload failed"):
        run_matrix("b", coo, BenchConfig(stages=("bsr_spmm",)),
                   log=lambda m: None, device="cpu")
    cfg = dataclasses.replace(BenchConfig(), stages=("sell_spmm",),
                              sell_spmm_rhs=SM.MAX_RHS + 1)
    with pytest.raises(ValueError, match="MAX_RHS"):
        run_matrix("b", coo, cfg, log=lambda m: None, device="cpu")
