"""The PageRank cell: its files found by name, its broken timed paths not
correct at a tiny size, the readers of PageRank's spans and counter, and a
package without the row-order rule refused before anything is
generated."""

import importlib
import sys
import time
import types

import pytest
import torch

from benchmark.harness import core, spec
from benchmark.metrics import (pagerank_host_reads, pagerank_spmv_roofline,
                               pagerank_sync_idle_pct, plane_bytes_per_nnz)

PORT = "sparsematrixvectormultiplication_tpu_torch"
PAGERANK = "gap_kron_s20.pagerank_f32"
TINY = {"gap_kron_s20": {"scale": 12, "edge_factor": 16}}
SEED = 2**31 + 11
READERS = {"pagerank_host_reads": pagerank_host_reads.read,
           "pagerank_sync_idle_pct": pagerank_sync_idle_pct.read,
           "pagerank_spmv_roofline": pagerank_spmv_roofline.read}
profiling = importlib.import_module(PORT + ".utils.profiling")


@pytest.fixture(autouse=True)
def clean():
    profiling.disable()
    profiling.reset()
    yield
    profiling.reset()


def tiny(name):
    cell = spec.find_cell(name)
    cell.config = dict(cell.config, params=TINY[cell.config["name"]],
                       layouts=None)
    cell.traffic = dict(cell.traffic, warmup=1, sample=3)
    return cell


def run(cell, seconds=0.05, control=None):
    return core.run_cell(cell, SEED, seconds, False, "cpu",
                         time.perf_counter(), log=lambda *a: None,
                         control=control)


def test_new_cell_is_found_with_its_metrics():
    cell = spec.find_cell(PAGERANK)
    assert cell.config["generator"] == "gap_kron"
    assert cell.config["params"] == {"scale": 20, "edge_factor": 16}
    assert cell.traffic["client"] == "pagerank"
    assert (cell.traffic["alpha"], cell.traffic["tol"],
            cell.traffic["maxiter"]) == (0.85, 1e-4, 20)
    assert set(cell.limits) == {"max_l1_gap", "stop_move"}
    assert {m["name"] for m in cell.end_to_end} == {"solve_ms", "setup_s"}
    assert {"pagerank_host_reads", "pagerank_sync_idle_pct",
            "pagerank_spmv_roofline", "plane_bytes_per_nnz.pagerank",
            "solve_ms_p95", "iters_per_solve", "idle_pct.solve",
            "sell_build_s", "convert_s", "upload_s"} \
        == {m["name"] for m in cell.per_layer}
    assert spec.reader_path("plane_bytes_per_nnz.pagerank").name \
        == "plane_bytes_per_nnz.py"


def _one_short(cls):
    """The answer one iteration behind the count the solve reports (its
    last update lost): the check, run for as many iterations as reported,
    has to tell p_k from p_(k-1)."""
    class Broken(cls):
        def __call__(self, *, tol, maxiter):
            _, iters, delta = super().__call__(tol=tol, maxiter=maxiter)
            p, _, _ = super().__call__(tol=tol, maxiter=iters - 1)
            return p, iters, delta
    return Broken


def _dangling_dropped(cls):
    """GAP's rule: the dangling mass is lost, not spread."""
    class Broken(cls):
        def __init__(self, matvec, dangling, **kw):
            super().__init__(matvec, torch.zeros_like(dangling), **kw)
    return Broken


def _loose_stop(cls):
    """A solve stopped at a ten times looser tolerance, reporting its own
    (shorter) count: p is the reference's at that count, and only GAP's
    stop rule tells it."""
    class Broken(cls):
        def __call__(self, *, tol, maxiter):
            return super().__call__(tol=10 * tol, maxiter=maxiter)
    return Broken


def _one_early(cls):
    """A solve that stops one iteration before GAP's rule does, reporting
    its own count."""
    class Broken(cls):
        def __call__(self, *, tol, maxiter):
            _, iters, _ = super().__call__(tol=tol, maxiter=maxiter)
            return super().__call__(tol=tol, maxiter=iters - 1)
    return Broken


def _half_rows(fn):
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return broken


FAULTS = [
    ("GraphedPageRank", _one_short),
    ("GraphedPageRank", _dangling_dropped),
    ("GraphedPageRank", _loose_stop),
    ("GraphedPageRank", _one_early),
    ("sell_spmv", _half_rows),
]


@pytest.mark.parametrize("entry,fault", FAULTS,
                         ids=[f.__name__[1:] for _, f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, entry, fault):
    """An answer one iteration behind its count, the dangling mass dropped
    (GAP's own rule), a solve stopped early by a looser tolerance or one
    iteration before GAP's rule (each with its own count), half of every
    product's rows lost: not correct."""
    port = importlib.import_module(PORT)
    monkeypatch.setattr(port, entry, fault(getattr(port, entry)))
    cell = tiny(PAGERANK)
    cell.traffic = dict(cell.traffic, sample=50)
    line = run(cell)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] >= 1


def test_tiny_cell_is_correct_and_its_control_is_not():
    cell = tiny(PAGERANK)
    line = run(cell)
    assert line["correct"] is True, line["checks"]
    low = run(cell, control=cell.traffic["control"])
    assert low["correct"] is False
    value = next(iter(low["checks"].values()))
    assert value["value"] > value["limit"]


def test_pagerank_run_reads_its_iterations_and_plane_bytes():
    seen = {}
    real = core.read_metrics

    def keep(r, metrics):
        seen["run"] = r
        return real(r, metrics)

    cell = tiny(PAGERANK)
    try:
        core.read_metrics = keep
        line = run(cell)
    finally:
        core.read_metrics = real
    r = seen["run"]
    assert r.stats["iters"] and all(1 < k <= 20 for k in r.stats["iters"])
    assert plane_bytes_per_nnz.read(r) > 4  # 4 B of value an entry at least
    assert line["metrics"]["solve_ms"]["value"] > 0


def _run(requests=2, gaps=(), ops=(), window_s=1.0):
    run = core.Run(spec.find_cell(PAGERANK), torch.device("cpu"), "f32")
    run.kind = "NVIDIA H100 80GB HBM3"
    run.nnz, run.nrows, run.ncols = 1000, 100, 100
    run.trace = {"window_s": window_s, "busy_s": 0.5, "device_s": 0.5,
                 "ops": [list(o) for o in ops], "gaps": [list(g) for g in gaps],
                 "requests": requests}
    return run


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_when_the_package_recorded_nothing(name):
    assert READERS[name](_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_for_a_package_without_spans(monkeypatch, name):
    monkeypatch.setitem(sys.modules, PORT + ".utils.profiling",
                        types.ModuleType("profiling"))
    run = _run(gaps=[["pagerank", 0.2]], ops=[["row_list_kernel", 1e-3]])
    assert READERS[name](run) is None


@pytest.mark.parametrize("matvec_span", ["solvers.pagerank.matvec",
                                         "solvers.pagerank.iteration"])
def test_readers_read_pagerank_spans_and_counter(matvec_span):
    """A matvec is a ``pagerank`` iteration's matvec span or a replay of
    ``GraphedPageRank``'s captured iteration."""
    profiling.enable()
    try:
        for _ in range(6):
            with profiling.annotate(matvec_span):
                pass
            profiling.count("solvers.pagerank.host_reads")
    finally:
        profiling.disable()
    run = _run(requests=2,
               gaps=[["solvers.pagerank.stop_test", 0.25],
                     ["solvers.pagerank.update", 0.5]],
               ops=[["void row_list_kernel<F32Sum>(int const*)", 3e-6],
                    ["void k_major_kernel<F32Sum>(int const*)", 1e-6],
                    ["row_gather_kernel(float const*)", 1e-6],
                    ["at::native::vectorized_elementwise_kernel", 9e-6]])
    assert pagerank_host_reads.read(run) == 3.0
    assert pagerank_sync_idle_pct.read(run) == pytest.approx(25.0)
    # 6 products of 1000 entries, 100 rows and columns: 4800 B each
    least = 4800 / 3.35e12
    assert pagerank_spmv_roofline.read(run) == pytest.approx(
        100 * 6 * least / 5e-6)


def test_client_refuses_a_package_without_the_row_order_rule(monkeypatch):
    """The parent's package: importing the client raises at once, so a run
    fails before the graph is generated or converted."""
    monkeypatch.setitem(sys.modules, PORT + ".formats.sell_order", None)
    monkeypatch.delitem(sys.modules, "benchmark.clients.pagerank",
                        raising=False)
    with pytest.raises(ImportError):
        importlib.import_module("benchmark.clients.pagerank")
    monkeypatch.delitem(sys.modules, "benchmark.clients.pagerank",
                        raising=False)
