"""The port's spans and counters (``utils.profiling``): off, a span is one
null context and records nothing; under ``torch.profiler`` or after
``enable()``, the entries' spans land in the trace as ``user_annotation``
events nested in their parents, and in ``summary()``; the conversion's
spans record always."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsematrixvectormultiplication_tpu_torch.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.sell import (
    PanelSellMatrix, SellMatrix)
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
from sparsematrixvectormultiplication_tpu_torch.ops import sell_spmm as SM
from sparsematrixvectormultiplication_tpu_torch.solvers.cg import (
    cg, jacobi_preconditioner)
from sparsematrixvectormultiplication_tpu_torch.utils import profiling

CPU = torch.device("cpu")
N = 3000
PER_CALL = ("ops.sell_spmv", "ops.sell_spmm", "ops.sell_spmv_dd_f64",
            "ops.dd.split_x", "ops.dd.assemble", "ops.dd.join_y",
            "solvers.cg", "solvers.cg.matvec", "solvers.cg.update",
            "solvers.cg.stop_test")


@pytest.fixture(autouse=True)
def clean():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _spd_csr(n=N, seed=3) -> CSRMatrix:
    """B + B^T + c I, c above the largest absolute row sum: symmetric and
    diagonally dominant, so SPD."""
    coo = syn.banded(n, 9, 40, seed=seed)
    row = np.concatenate([coo.row, coo.col, np.arange(n)])
    col = np.concatenate([coo.col, coo.row, np.arange(n)])
    val = np.concatenate([coo.val, coo.val, np.zeros(n)])
    csr = CSRMatrix.from_coo(COOMatrix(n, n, row.astype(np.int32),
                                       col.astype(np.int32), val))
    rows = np.repeat(np.arange(n), np.diff(csr.row_ptr))
    shift = np.bincount(rows, np.abs(csr.values), n).max() + 1.0
    csr.values[rows == csr.col_idx] += shift
    return csr


@pytest.fixture(scope="module")
def system():
    csr = _spd_csr()
    sell = SellMatrix.from_csr(csr)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(N))
    return csr, sell, x


def _sell_spmv(system):
    csr, sell, x = system
    d = S.device_put_sell(sell, device=CPU)
    S.sell_spmv(d, S.pack_x_table(x.float(), N))


def _sell_spmv_dd_f64(system):
    csr, sell, x = system
    D.sell_spmv_dd_f64(D.device_put_sell_dd(sell, device=CPU), x)


def _sell_spmm(system):
    csr, sell, x = system
    SM.sell_spmm(S.device_put_sell(sell, device=CPU),
                 torch.stack([x.float()] * 4, dim=1))


def _cg(system):
    csr, sell, x = system
    d = S.device_put_sell(sell, device=CPU)
    tab = S.pack_x_table(torch.zeros(N), N)

    def matvec(v):
        tab[:N].copy_(v)
        return S.sell_spmv(d, tab)

    return cg(matvec, x.float(), tol=1e-5, maxiter=200,
              minv=jacobi_preconditioner(csr, torch.float32, device=CPU))


def _from_csr(system):
    SellMatrix.from_csr(system[0])


# entry -> (parent, child) spans it nests in the trace on the CPU
ENTRIES = {
    "sell_spmv": (_sell_spmv, [("ops.sell_spmv", None)]),
    "sell_spmv_dd_f64": (_sell_spmv_dd_f64, [
        ("ops.sell_spmv_dd_f64", c) for c in
        ("ops.dd.split_x", "ops.dd.assemble", "ops.dd.join_y")]),
    "sell_spmm": (_sell_spmm, [("ops.sell_spmm", None)]),
    "cg": (_cg, [("solvers.cg", "solvers.cg.matvec"),
                 ("solvers.cg", "solvers.cg.update"),
                 ("solvers.cg", "solvers.cg.stop_test"),
                 ("solvers.cg.matvec", "ops.sell_spmv")]),
    "from_csr": (_from_csr, [("formats.sell.from_csr", c) for c in
                             ("formats.sell.slab_lists",
                              "formats.sell.wl_profile", "formats.sell.fill",
                              "formats.sell.emit")]),
}


def _annotations(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _inside(child, parent) -> bool:
    eps = 1e-2  # microseconds: the trace rounds ts and dur apart
    return (parent["ts"] - eps <= child["ts"]
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + eps)


def test_off_annotate_is_one_null_context_and_enters_nothing(monkeypatch,
                                                             system):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(profiling, "_record_enter", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    assert not profiling.tracing()
    null = profiling.annotate("a")
    assert profiling.annotate("b") is null
    with null as v:
        assert v is None
    for entry, _ in ENTRIES.values():
        entry(system)
    assert not set(profiling.summary()) & set(PER_CALL)
    profiling.count("c", 3)
    assert profiling.counters() == {}


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_spans_nest_in_the_profiler_trace(tmp_path, system, name):
    entry, pairs = ENTRIES[name]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        entry(system)
    assert not profiling.tracing()
    events = _annotations(prof, tmp_path)
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    for parent, child in pairs:
        assert parent in by_name, (parent, sorted(by_name))
        for c in by_name.get(child, ()) if child else ():
            assert any(_inside(c, p) for p in by_name[parent]), (parent, c)
        if child:
            assert child in by_name, (child, sorted(by_name))
    summary = profiling.summary()
    for parent, child in pairs:
        for span in (parent, child):
            if span:
                assert summary[span]["count"] == len(by_name[span])


def test_cg_counts_its_stop_tests_and_host_reads(system):
    with profile(activities=[ProfilerActivity.CPU]):
        _, iters, _ = _cg(system)
    assert 0 < iters < 200
    summary = profiling.summary()
    assert summary["solvers.cg"]["count"] == 1
    assert summary["solvers.cg.stop_test"]["count"] == iters + 1
    assert summary["solvers.cg.matvec"]["count"] == iters + 1
    assert summary["solvers.cg.update"]["count"] == iters
    assert summary["ops.sell_spmv"]["count"] == iters + 1
    assert profiling.counters() == {"solvers.cg.host_reads": iters + 1}
    for name, s in summary.items():
        assert 0 <= s["self_s"] <= s["total_s"], name
    inner = sum(summary[f"solvers.cg.{k}"]["total_s"]
                for k in ("matvec", "update", "stop_test"))
    cg_span = summary["solvers.cg"]
    assert cg_span["self_s"] == pytest.approx(cg_span["total_s"] - inner)


def _shed_csr():
    return CSRMatrix.from_coo(syn.banded(2048, 24, 64, seed=2))


@pytest.mark.parametrize("layout", ["auto", "wl", "wl-shed", "panels"])
def test_from_csr_records_once_with_tracing_off(layout):
    csr = _shed_csr()
    if layout == "panels":
        host = PanelSellMatrix.from_csr(csr, max_panel_cols=1024)
        assert len(host.panels) > 1
    else:
        host = SellMatrix.from_csr(csr, layout=layout)
    if layout == "wl-shed":  # the wl part and the shed remainder
        assert any(b.add_into for b in host.bins) and len(host.bins) > 1
    summary = profiling.summary()
    assert summary["formats.sell.from_csr"]["count"] == 1
    assert ("formats.sell.wl_shed" in summary) == (layout == "wl-shed")
    assert summary["formats.sell.fill"]["count"] >= 1
    stages = [s for name, s in summary.items()
              if name.startswith("formats.sell.")
              and name != "formats.sell.from_csr"]
    total = summary["formats.sell.from_csr"]
    assert 0 <= total["self_s"] <= total["total_s"]
    assert sum(s["self_s"] for s in stages) + total["self_s"] == \
        pytest.approx(total["total_s"])
    assert not set(summary) & set(PER_CALL)
    assert profiling.counters() == {}


def test_enable_and_disable_turn_recording_on_and_off():
    with profiling.annotate("off"):
        pass
    profiling.count("n")
    assert profiling.summary() == {} and profiling.counters() == {}
    profiling.enable()
    assert profiling.tracing()
    with profiling.annotate("on"):
        pass
    profiling.count("n", 2)
    profiling.count("n")
    profiling.disable()
    assert not profiling.tracing()
    with profiling.annotate("on"):
        pass
    profiling.count("n")
    assert profiling.summary()["on"]["count"] == 1
    assert profiling.counters() == {"n": 3}
    profiling.reset()
    assert profiling.summary() == {} and profiling.counters() == {}


def test_a_span_reentered_under_its_own_name_adds_once():
    profiling.enable()
    with profiling.annotate("outer"):
        with profiling.annotate("mid"):
            with profiling.annotate("outer"):
                with profiling.annotate("leaf"):
                    pass
    s = profiling.summary()
    assert s["outer"]["count"] == 1 and s["mid"]["count"] == 1
    assert s["leaf"]["count"] == 1
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["total_s"] - s["mid"]["total_s"])
    assert s["mid"]["self_s"] == pytest.approx(
        s["mid"]["total_s"] - s["leaf"]["total_s"])


def test_setup_span_records_off_and_decorates():
    @profiling.setup_span("setup.work")
    def work(n):
        """Docs."""
        with profiling.setup_span("setup.part"):
            return sum(range(n))

    assert work(100) == 4950 and work.__doc__ == "Docs."
    work(10)
    s = profiling.summary()
    assert s["setup.work"]["count"] == 2 and s["setup.part"]["count"] == 2
    assert s["setup.work"]["self_s"] == pytest.approx(
        s["setup.work"]["total_s"] - s["setup.part"]["total_s"])


def test_a_span_that_raises_still_closes():
    profiling.enable()
    with pytest.raises(ValueError):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                raise ValueError
    with profiling.annotate("next"):
        pass
    s = profiling.summary()
    assert s["outer"]["count"] == s["inner"]["count"] == 1
    assert s["next"]["self_s"] == s["next"]["total_s"]  # not a child


@pytest.mark.cuda
def test_spans_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    csr = _spd_csr()
    sell = SellMatrix.from_csr(csr)
    d = S.device_put_sell(sell, device=dev)
    dd = D.device_put_sell_dd(sell, device=dev)
    tab = S.pack_x_table(torch.ones(N, device=dev), N)
    x64 = torch.ones(N, dtype=torch.float64, device=dev)
    S.sell_spmv(d, tab)
    D.sell_spmv_dd_f64(dd, x64)
    torch.cuda.synchronize(dev)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        S.sell_spmv(d, tab)
        D.sell_spmv_dd_f64(dd, x64)
        torch.cuda.synchronize(dev)
    events = _annotations(prof, tmp_path)
    root = next(e for e in events if e["name"] == "ops.sell_spmv_dd_f64")
    for child in ("ops.dd.split_x", "ops.dd.assemble", "ops.dd.join_y"):
        (e,) = [e for e in events if e["name"] == child]
        assert _inside(e, root)
    s = profiling.summary()
    assert s["ops.sell_spmv"]["count"] == s["ops.sell_spmv_dd_f64"]["count"] == 1
