"""PageRank on GAP's kron graph through the port's normal path, against the
plain reference (``models/kron_pagerank_reference.py``), on the CPU.

The path: ``SellMatrix.from_csr`` as the package exports it (its row-order
rule sorts heavy-tailed rows, ``formats/sell_order.py``), ``device_put_sell``
(the container keeps the row map), ``sell_spmv`` (y gathered back into the
caller's row order) inside ``pagerank``; on CPU tensors every kernel runs
its plain version. Beside it: the rule leaves fem3d-class and banded
matrices to the host copy, bit for bit; the gather through the row map
equals the sorted output unpermuted; an explicit ``sigma_sort=True`` keeps
the sorted order; PageRank's spans and counter; the benchmark's generator
against the reference and ``pagerank_operator``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sparsematrixvectormultiplication_tpu_torch as port
from benchmark.reference import gap_kron
from benchmark.reference import pagerank as bench_pagerank
from sparsematrixvectormultiplication_tpu_torch.formats import sell as host
from sparsematrixvectormultiplication_tpu_torch.formats import sell_order
from sparsematrixvectormultiplication_tpu_torch.models import synthetic
from sparsematrixvectormultiplication_tpu_torch.models import (
    kron_pagerank_reference as R)
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
from sparsematrixvectormultiplication_tpu_torch.ops import sell_spmm as SM
from sparsematrixvectormultiplication_tpu_torch.utils import profiling

# the f32 port against the fp64 reference after the same iterations: p's
# entries sum to 1, and each iteration rounds every entry's f32 products
# and sums (relative 2**-24, a few dozen additions a row) and the vector
# work, so the L1 gap grows by some 1e-7 an iteration; bf16 values
# (relative 2**-9) read about 1e-3 (tests/test_torch_pagerank_kron.py's
# control case), 100x the bound
L1_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many small torch ops (the plain versions step slot by
    slot); with the intra-op pool on every core they slow some 10x on a host
    whose cores other test workers hold (its threads spin on each op)."""
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(held)


def _graph(scale, seed=3):
    n, row, col = R.kron_graph(scale, 16, seed)
    val, dangling = R.transition(n, row, col)
    csr = port.CSRMatrix.from_coo(port.COOMatrix(
        n, n, row.to(torch.int32).numpy(), col.to(torch.int32).numpy(),
        val.numpy()))
    return n, row, col, val, dangling, csr


def _matvec(d, n):
    tab = S.pack_x_table(torch.zeros(n), n)

    def matvec(v):
        tab[:n].copy_(v)
        return S.sell_spmv(d, tab)
    return matvec


@pytest.mark.parametrize("scale,routed", [(10, False), (12, True)])
@pytest.mark.parametrize("dtype,tol,correct", [
    (torch.float32, L1_TOL, True), (torch.bfloat16, L1_TOL, False)])
def test_port_pagerank_matches_the_plain_reference(scale, routed, dtype, tol,
                                                   correct):
    """Through the rule (SCALE 12: four groups, sorted; SCALE 10: one group,
    which sorting cannot shrink, left alone), the row map and the plain
    twins, the port's p is the reference's after as many iterations, in
    f32 values; bf16 values fail the same tolerance."""
    n, row, col, val, dangling, csr = _graph(scale)
    sell = port.SellMatrix.from_csr(csr)
    assert (sell.row_map is not None) is routed
    d = port.device_put_sell(sell, dtype, device="cpu")
    assert not d.sigma_sorted and (d.row_map is not None) is routed
    p, iters, delta = port.pagerank(_matvec(d, n), dangling.float(),
                                    alpha=0.85, tol=1e-4, maxiter=20)
    assert p.dtype == torch.float32 and 1 < iters <= 20
    assert float(delta) <= 1e-4 or iters == 20
    want, k, _ = R.pagerank(n, row, col, val, dangling, tol=-1,
                            maxiter=iters)
    assert k == iters
    gap = float((p.double() - want).abs().sum())
    assert (gap <= tol) is correct, gap
    if correct:  # bf16 columns of 1/deg do not sum to 1: p drifts
        assert abs(float(p.double().sum()) - 1.0) < 1e-5


def test_reference_stops_as_gap_does():
    n, row, col, val, dangling, _ = _graph(10)
    p, k, delta = R.pagerank(n, row, col, val, dangling)
    assert delta <= 1e-4 and 1 < k < 20
    assert abs(float(p.sum()) - 1.0) < 1e-12
    p20, k20, _ = R.pagerank(n, row, col, val, dangling, tol=-1, maxiter=20)
    assert k20 == 20 and float((p20 - p).abs().sum()) < 1e-3


def test_reference_f32_and_f64_agree():
    n, row, col, val, dangling, _ = _graph(9)
    p64, k, _ = R.pagerank(n, row, col, val, dangling)
    p32, k32, _ = R.pagerank(n, row, col, val, dangling,
                             dtype=torch.float32)
    assert k32 == k and float((p32.double() - p64).abs().sum()) < L1_TOL


def test_kron_graph_is_symmetric_simple_and_seeded():
    n, row, col = R.kron_graph(9, 16, 5)
    key = row * n + col
    assert torch.equal(key, torch.unique(key))  # sorted, no duplicate
    assert not bool((row == col).any())
    assert torch.equal(torch.sort(col * n + row).values, key)  # symmetric
    assert row.numel() <= 2 * 16 * n
    _, row2, col2 = R.kron_graph(9, 16, 5)
    assert torch.equal(row, row2) and torch.equal(col, col2)
    _, row3, _ = R.kron_graph(9, 16, 6)
    assert row3.numel() != row.numel() or not torch.equal(row3, row)
    deg = torch.bincount(row, minlength=n)
    assert int(deg.max()) > 8 * float(deg.float().mean())  # heavy-tailed


def test_benchmark_generator_is_the_reference_and_pagerank_operator():
    """The benchmark's frozen generator returns the reference's graph as
    P = A D^-1, and P equals ``pagerank_operator`` of the 0/1 adjacency
    (A^T scaled by out-degree: A is symmetric)."""
    m = gap_kron.generate({"scale": 9, "edge_factor": 16}, 7, "cpu")
    n, row, col = R.kron_graph(9, 16, 7)
    val, dangling = R.transition(n, row, col)
    assert m.nrows == m.ncols == n
    assert torch.equal(m.row, row) and torch.equal(m.col, col)
    assert torch.equal(m.val, val)
    adj = port.CSRMatrix.from_coo(port.COOMatrix(
        n, n, row.to(torch.int32).numpy(), col.to(torch.int32).numpy(),
        np.ones(row.numel())))
    op, dang = port.pagerank_operator(adj)
    p = port.CSRMatrix.from_coo(port.COOMatrix(
        n, n, m.row.to(torch.int32).numpy(), m.col.to(torch.int32).numpy(),
        m.val.numpy()))
    assert np.array_equal(op.row_ptr, p.row_ptr)
    assert np.array_equal(op.col_idx, p.col_idx)
    assert np.array_equal(op.values, p.values)
    assert np.array_equal(dang, dangling.numpy())
    ref, move = bench_pagerank.iterate(m, 6, 0.85)
    want, _, delta = R.pagerank(n, row, col, val, dangling, tol=-1, maxiter=6)
    assert bench_pagerank.l1_gap(ref, want) < 1e-15
    assert move == pytest.approx(float(delta), rel=1e-12)
    assert bench_pagerank.l1_gap(ref[:-1], want) == float("inf")


@pytest.mark.parametrize("name,make", [
    ("fem_3d", lambda: synthetic.fem_3d(12, 12, 12, dof=3, seed=1)),
    ("banded", lambda: synthetic.banded(9000, 20, 300, seed=2)),
    ("road", lambda: synthetic.road_network(20_000, seed=5)),
    ("power_law_one_group", lambda: synthetic.power_law(1000, 8, seed=1)),
])
def test_rule_leaves_other_matrices_to_the_copy(name, make):
    """fem3d-class, banded and road matrices, and a single group that
    sorting cannot shrink, convert as the host copy converts them, bit for
    bit, and upload without a row map."""
    csr = port.CSRMatrix.from_coo(make())
    assert not sell_order.heavy_tailed(csr.row_nnz())
    got = port.SellMatrix.from_csr(csr)
    want = host.SellMatrix.from_csr(csr)
    assert got.row_map is None and got.row_perm is None
    assert len(got.bins) == len(want.bins)
    for g, w in zip(got.bins, want.bins):
        for f in ("k", "layout", "real_nnz", "span", "chunk_k", "add_into",
                  "sg_slots"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("group_ids", "ja", "as_", "slab_list", "slab_count"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
    assert port.device_put_sell(got, device="cpu").row_map is None


def test_rule_keeps_explicit_choices():
    """``sigma_sort`` or a forced layout bypass the rule: an explicit
    ``sigma_sort=True`` keeps its y in sorted order."""
    *_, csr = _graph(12)
    assert sell_order.heavy_tailed(csr.row_nnz())
    for kw in ({"sigma_sort": False}, {"layout": "k-major"}):
        s = port.SellMatrix.from_csr(csr, **kw)
        assert s.row_perm is None and s.row_map is None
    s = port.SellMatrix.from_csr(csr, sigma_sort=True)
    assert s.row_perm is not None and s.row_map is None
    d = port.device_put_sell(s, device="cpu")
    assert d.sigma_sorted and d.row_map is None


def test_binned_slots_are_the_default_binnings():
    """The rule's count is the slots the copy's k-major binning stores,
    group by group, without merging bins; sorted rows store fewer."""
    *_, csr = _graph(12)
    lens = csr.row_nnz()
    forced = host.SellMatrix.from_csr(csr, layout="k-major",
                                      merge_bins=False)
    assert sell_order.binned_slots(lens) == forced.padded_nnz
    srt = host.SellMatrix.from_csr(csr, layout="k-major", merge_bins=False,
                                   sigma_sort=True)
    assert sell_order.binned_slots(-np.sort(-lens)) == srt.padded_nnz
    assert 2 * srt.padded_nnz <= forced.padded_nnz
    assert sell_order.binned_slots(np.zeros(0, np.int64)) == 0
    assert not sell_order.heavy_tailed(np.zeros(5000, np.int64))
    # one row past the last bin edge doubles it, as from_csr does
    lens = np.ones(3000, np.int64)
    lens[5] = 3000
    assert sell_order.binned_slots(lens) == (4096 + 2 * 1) * 1024


def test_rule_splits_heavy_rows_then_sorts():
    """The rule's conversion is the copy's conversion of the rows split at
    HEAVY_ROW_CAP (strided) and sorted, bin for bin; its row map lists each
    caller row's segments, none for a row with no entry; the host oracle
    and shape are the caller's."""
    n, row, col, val, dangling, csr = _graph(12)
    assert int(csr.row_nnz().max()) > sell_order.HEAVY_ROW_CAP
    ruled = port.SellMatrix.from_csr(csr)
    segs, seg_map = csr.split_heavy_rows(sell_order.HEAVY_ROW_CAP,
                                         strided=True)
    want = host.SellMatrix.from_csr(segs, sigma_sort=True)
    assert ruled.nrows == segs.nrows > n and ruled.shape == (n, n)
    assert np.array_equal(ruled.row_perm, want.row_perm)
    assert [(b.layout, b.k, b.n_groups) for b in ruled.bins] == [
        (b.layout, b.k, b.n_groups) for b in want.bins]
    for g, w in zip(ruled.bins, want.bins):
        assert np.array_equal(g.ja, w.ja) and np.array_equal(g.as_, w.as_)
    ptr, pos = ruled.row_map
    count = np.diff(ptr)
    assert np.array_equal(count == 0, dangling.numpy())
    lens = csr.row_nnz()
    assert np.array_equal(count[lens > 0], -(-lens[lens > 0]
                                             // sell_order.HEAVY_ROW_CAP))
    assert np.array_equal(np.sort(pos), np.sort(np.flatnonzero(
        segs.row_nnz()[ruled.row_perm] > 0)))
    x = np.random.default_rng(4).standard_normal(n)
    np.testing.assert_allclose(ruled.spmv(x), csr.spmv(x), rtol=1e-12,
                               atol=1e-12)


def test_gather_is_the_sorted_output_by_segments_and_empty_rows_are_zero():
    """sell_spmv through the row map: the sorted SELL's y with each caller
    row's segments added (exactly its one segment's sum where it has one),
    rows with no entry +0 whatever x holds; the plain versions and the
    other assemblies agree bit for bit; one launch more."""
    n, row, col, val, dangling, csr = _graph(12)
    ruled = port.SellMatrix.from_csr(csr)
    d_map = port.device_put_sell(ruled, device="cpu")
    sorted_ = dataclasses.replace(ruled, row_map=None)
    d_sig = port.device_put_sell(sorted_, device="cpu")
    assert d_sig.sigma_sorted and not d_map.sigma_sorted
    assert d_map.nrows == n and d_sig.nrows == ruled.nrows
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(n)).float()
    x[dangling.nonzero()[:3, 0]] = float("inf")  # no row reads them
    tab = S.pack_x_table(x, n)
    y = S.sell_spmv(d_map, tab)
    y_sig = S.sell_spmv(d_sig, tab)
    assert y.shape == (n,) and not y[dangling].any()
    ptr, pos = (torch.from_numpy(a).long() for a in ruled.row_map)
    one = (ptr[1:] - ptr[:-1]) == 1
    assert torch.equal(y[one], y_sig[pos[ptr[:-1][one]]])
    np.testing.assert_allclose(y.numpy(), ruled.unpermute(y_sig.numpy()),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(S.sell_spmv_plain(d_map, tab), y)
    for assembly in ("chain", "sum"):
        assert torch.equal(S.sell_spmv(d_map, tab, assembly=assembly), y)
    assert S.sell_spmv_launches(d_map) == S.sell_spmv_launches(d_sig) + 1
    np.testing.assert_allclose(y.double().numpy(), csr.spmv(
        np.nan_to_num(x.double().numpy(), posinf=0.0)), rtol=1e-5,
        atol=1e-5)


def test_row_gather_plain():
    src = torch.tensor([5.0, -1.0, 2.5, 7.0, -0.0])
    rm = S.RowMap(torch.tensor([0, 1, 1, 3, 4, 4, 5], dtype=torch.int32),
                  torch.tensor([2, 0, 3, 1, 4], dtype=torch.int32), 5)
    got = S.row_gather_plain(src, rm)
    assert torch.equal(got, torch.tensor([2.5, 0.0, 12.0, -1.0, 0.0, 0.0]))
    assert not got.view(torch.int32)[4:].any()  # +0, not -0
    assert torch.equal(S.row_gather(src, rm), got)
    h, l = S.row_gather_dd_plain(src, src * 2.0**-30, rm)
    assert torch.equal(h, got)


@pytest.mark.parametrize("ptr,pos", [
    ([0, 1, 3], [0, 1]),        # ptr past pos
    ([0, 2, 1], [0, 1]),        # ptr falls
    ([1, 2, 2], [0, 1]),        # ptr not from 0
    ([0, 1, 2], [0, 1 << 20]),  # pos past the sorted y
    ([0, 1, 2], [-1, 0]),
])
def test_upload_refuses_a_row_map_that_does_not_fit(ptr, pos):
    *_, csr = _graph(12)
    ruled = port.SellMatrix.from_csr(csr)
    bad = dataclasses.replace(ruled, row_map=(np.array(ptr), np.array(pos)))
    with pytest.raises(ValueError, match="row map"):
        port.device_put_sell(bad, device="cpu")


def test_row_map_serves_dd_cg_and_refuses_spmm():
    """A row-map container in double-double gives the caller's order too;
    ``cg_sell`` takes it; ``sell_spmm`` refuses it rather than return
    sorted rows."""
    coo = synthetic.power_law(5000, 6, seed=3)
    csr = port.CSRMatrix.from_coo(coo)
    ruled = port.SellMatrix.from_csr(csr)
    assert ruled.row_map is not None
    plain = host.SellMatrix.from_csr(csr)
    x = np.random.default_rng(2).standard_normal(csr.ncols)
    x64 = torch.from_numpy(x)
    got = D.sell_spmv_dd_f64(D.device_put_sell_dd(ruled, device="cpu"), x64)
    want = D.sell_spmv_dd_f64(D.device_put_sell_dd(plain, device="cpu"), x64)
    np.testing.assert_allclose(got.numpy(), csr.spmv(x), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13,
                               atol=1e-13)
    d = port.device_put_sell(ruled, device="cpu")
    with pytest.raises(NotImplementedError, match="row-order rule"):
        SM.sell_spmm(d, torch.zeros(csr.ncols, 4))
    tab = S.pack_x_table(torch.from_numpy(x).float(), csr.ncols)
    np.testing.assert_allclose(S.sell_spmv(d, tab).numpy(), csr.spmv(x),
                               rtol=1e-4, atol=1e-4)


def test_spd_row_map_container_runs_cg_sell():
    coo = synthetic.power_law(5000, 6, seed=3)
    a = port.CSRMatrix.from_coo(coo)
    rows = np.repeat(np.arange(a.nrows), np.diff(a.row_ptr))
    r = np.concatenate([rows, a.col_idx, np.arange(a.nrows)])
    c = np.concatenate([a.col_idx, rows, np.arange(a.nrows)])
    v = np.concatenate([np.abs(a.values), np.abs(a.values),
                        np.full(a.nrows, 0.0)])
    sym = port.CSRMatrix.from_coo(port.COOMatrix(
        a.nrows, a.ncols, r.astype(np.int32), c.astype(np.int32), v))
    absrow = np.bincount(np.repeat(np.arange(sym.nrows),
                                   np.diff(sym.row_ptr)),
                         weights=np.abs(sym.values), minlength=sym.nrows)
    diag = np.repeat(np.arange(sym.nrows), np.diff(sym.row_ptr)) \
        == sym.col_idx
    vals = sym.values.copy()
    vals[diag] += absrow.max() + 1.0
    spd = port.CSRMatrix(sym.nrows, sym.ncols, sym.row_ptr, sym.col_idx,
                         vals)
    sell = port.SellMatrix.from_csr(spd)
    assert sell.row_map is not None
    d = port.device_put_sell(sell, device="cpu")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        spd.nrows)).float()
    x, iters, res = port.cg_sell(d, b, tol=1e-5, maxiter=200)
    r = b.double().numpy() - spd.spmv(x.double().numpy())
    assert np.linalg.norm(r) <= 2e-5 * np.linalg.norm(b.numpy())


def test_pagerank_spans_and_host_reads():
    n, row, col, val, dangling, csr = _graph(10)
    d = port.device_put_sell(port.SellMatrix.from_csr(csr), device="cpu")
    profiling.reset()
    port.pagerank(_matvec(d, n), dangling.float(), tol=1e-4, maxiter=20)
    assert "solvers.pagerank" not in profiling.summary()  # tracing off
    profiling.enable()
    try:
        _, iters, _ = port.pagerank(_matvec(d, n), dangling.float(),
                                    tol=1e-4, maxiter=20)
        _, capped, _ = port.pagerank(_matvec(d, n), dangling.float(),
                                     tol=1e-4, maxiter=3)
    finally:
        profiling.disable()
    s, c = profiling.summary(), profiling.counters()
    profiling.reset()
    assert capped == 3 and iters > 3
    assert s["solvers.pagerank"]["count"] == 2
    assert s["solvers.pagerank.matvec"]["count"] == iters + capped
    assert s["solvers.pagerank.update"]["count"] == iters + capped
    # one read a stop test: the one that ends a converged solve, none
    # after the last iteration of a capped one
    assert s["solvers.pagerank.stop_test"]["count"] == iters + 1 + capped
    assert c["solvers.pagerank.host_reads"] == iters + 1 + capped
    assert s["ops.sell_spmv"]["count"] == iters + capped
    assert s["solvers.pagerank"]["total_s"] >= \
        s["solvers.pagerank.matvec"]["total_s"]


@pytest.mark.parametrize("maxiter", [0, 3, 20])
def test_graphed_pagerank_off_cuda_is_pagerank(maxiter):
    """Off CUDA, ``GraphedPageRank`` captures nothing and each solve is
    ``pagerank``'s, bit for bit, as new tensors: solves of one solver do
    not share their answers."""
    n, row, col, val, dangling, csr = _graph(10)
    d = port.device_put_sell(port.SellMatrix.from_csr(csr), device="cpu")
    solver = port.GraphedPageRank(_matvec(d, n), dangling.float(),
                                  alpha=0.85)
    assert solver.graph is None
    want = port.pagerank(_matvec(d, n), dangling.float(), alpha=0.85,
                         tol=1e-4, maxiter=maxiter)
    first = solver(tol=1e-4, maxiter=maxiter)
    again = solver(tol=1e-4, maxiter=maxiter)
    for got in (first, again):
        assert got[1] == want[1] == min(maxiter, got[1])
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[2], want[2])
    assert first[0].data_ptr() != again[0].data_ptr()


def test_graphed_pagerank_spans_and_host_reads():
    """The solve's spans and host reads as ``pagerank``'s; on the card a
    replay is the span ``solvers.pagerank.iteration``."""
    n, row, col, val, dangling, csr = _graph(10)
    d = port.device_put_sell(port.SellMatrix.from_csr(csr), device="cpu")
    solver = port.GraphedPageRank(_matvec(d, n), dangling.float())
    profiling.reset()
    profiling.enable()
    try:
        _, iters, _ = solver(tol=1e-4, maxiter=20)
    finally:
        profiling.disable()
    s, c = profiling.summary(), profiling.counters()
    profiling.reset()
    assert s["solvers.pagerank"]["count"] == 1
    assert s["solvers.pagerank.matvec"]["count"] == iters
    assert s["solvers.pagerank.stop_test"]["count"] == iters + 1
    assert c["solvers.pagerank.host_reads"] == iters + 1
    assert "solvers.pagerank.iteration" not in s


def test_graphed_pagerank_refuses_a_mask_that_is_no_tensor():
    with pytest.raises(TypeError):
        port.GraphedPageRank(lambda v: v, np.zeros(4, np.float32))


def test_rule_has_a_span_inside_the_conversion():
    *_, csr = _graph(12)
    profiling.reset()
    port.SellMatrix.from_csr(csr)
    s = profiling.summary()
    profiling.reset()
    assert s["formats.sell.from_csr"]["count"] == 1
    assert s["formats.sell.row_order"]["count"] == 1
    assert s["formats.sell.row_order"]["total_s"] \
        <= s["formats.sell.from_csr"]["total_s"]
