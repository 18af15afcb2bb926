"""The port's sweep and tune layer against the JAX package's, on the CPU.

The tuner's host cost model (``autotune_sell(device="cpu")``) and its hack
size sweep give the JAX tuner's candidate names, picks, modeled seconds
(within 1e-12 relative) and padding ratios; every default candidate's
conversion gives the JAX conversion's bins (``np.array_equal``);
``sell_spmv``'s "auto", "sum" and "chain" bin assemblies equal the JAX
``sell_spmv_pallas``'s (interpret mode) on a matrix with ``add_into`` bins,
f32 at rtol 1e-6; "chain" refuses a core bin after an ``add_into`` bin,
and ``sell_spmv_launches`` counts each assembly's launches. The CLI with
``--device cpu`` writes one row per stage, resumes without duplicates, and
agrees with the JAX CLI on the same matrix in the columns that do not
depend on time; the CSV headers are the JAX
package's, and ``best_table`` renders the port's results as the JAX one
does. Inputs come from seeded generators.
"""

import csv
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.bench import cli as jcli
from sparsematrixvectormultiplication_tpu.bench import csv_report as jcsv
from sparsematrixvectormultiplication_tpu.bench import report as jreport
from sparsematrixvectormultiplication_tpu.formats.coo import (
    COOMatrix as JCOO)
from sparsematrixvectormultiplication_tpu.formats.csr import (
    CSRMatrix as JCSR)
from sparsematrixvectormultiplication_tpu.formats.sell import (
    SellMatrix as JSell)
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    device_put_sell as jax_device_put_sell,
    sell_spmv_pallas,
)
from sparsematrixvectormultiplication_tpu.tune import autotune as jtune
from sparsematrixvectormultiplication_tpu_torch.bench import cli
from sparsematrixvectormultiplication_tpu_torch.bench import csv_report
from sparsematrixvectormultiplication_tpu_torch.bench import report
from sparsematrixvectormultiplication_tpu_torch.bench.scale import (
    run_ladder_sweep)
from sparsematrixvectormultiplication_tpu_torch.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.sell import (
    SellMatrix)
from sparsematrixvectormultiplication_tpu_torch.io.mmio import (
    write_matrix_market)
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.tune import autotune as tune
from sparsematrixvectormultiplication_tpu_torch.utils import profiling

QUIET = {"log": lambda *a: None}
# the CLI's --kernels in the port's names, and the JAX stages they map to
PORT_KERNELS = "serial_csr,serial_hll,csr,ell,sell,hll,sell_sigma"
JAX_KERNELS = ("serial_csr,serial_hll,xla_csr,xla_ell,pallas_sell,"
               "pallas_hll,pallas_sell_sigma")


def _pair(make_jax, make_port):
    """The JAX and the port CSR of one seeded matrix."""
    j = make_jax()
    p = make_port()
    return JCSR.from_coo(j), CSRMatrix.from_coo(p)


def _random(nrows, ncols, density):
    import scipy.sparse as sp

    s = sp.random(nrows, ncols, density=density,
                  random_state=np.random.RandomState(1234), format="coo")
    return (lambda: JCOO(nrows, ncols, s.row, s.col, s.data),
            lambda: COOMatrix(nrows, ncols, s.row, s.col, s.data))


TUNE_MATRICES = {
    "banded": (lambda: jsyn.banded(2048, 10, 100, seed=3),
               lambda: syn.banded(2048, 10, 100, seed=3)),
    "random": _random(3000, 2500, 0.01),
}


@pytest.mark.parametrize("matrix", sorted(TUNE_MATRICES))
def test_autotune_sell_cost_model_matches_jax(matrix):
    jcsr, csr = _pair(*TUNE_MATRICES[matrix])
    mine = tune.autotune_sell(csr, device="cpu")
    theirs = jtune.autotune_sell(jcsr)
    assert [r[0] for r in mine.table] == [r[0] for r in theirs.table]
    assert len(mine.table) == 10
    assert mine.best.name == theirs.best.name
    assert mine.best == tune.SellCandidate(**dataclasses.asdict(theirs.best))
    assert mine.assembly == theirs.assembly == "auto"
    for (name, s, stats), (_, js, jstats) in zip(mine.table, theirs.table):
        assert s == pytest.approx(js, rel=1e-12), name
        assert stats["modeled"] == pytest.approx(jstats["modeled"], rel=1e-12)
        assert stats["padding_ratio"] == jstats["padding_ratio"], name
    assert mine.best_seconds == pytest.approx(theirs.best_seconds, rel=1e-12)


def test_autotune_hack_size_matches_jax():
    jcsr, csr = _pair(*TUNE_MATRICES["random"])
    best, rows = tune.autotune_hack_size(csr)
    jbest, jrows = jtune.autotune_hack_size(jcsr)
    assert best == jbest
    assert [(h, pad) for h, pad, _ in rows] == [(h, pad) for h, pad, _ in jrows]


def _bins_equal(a, b):
    assert len(a.bins) == len(b.bins)
    for x, y in zip(a.bins, b.bins):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype and np.array_equal(u, v), f.name
            else:
                assert u == v, f.name


@pytest.mark.parametrize("cand", [c.name for c in
                                  tune._default_candidates()])
def test_tuned_conversion_matches_jax(cand):
    c = {c.name: c for c in tune._default_candidates()}[cand]
    jcsr, csr = _pair(*TUNE_MATRICES["banded"])
    kw = dict(k_bins=c.k_bins, layout=c.layout, merge_bins=c.merge_bins)
    _bins_equal(SellMatrix.from_csr(csr, **kw), JSell.from_csr(jcsr, **kw))


@pytest.mark.parametrize("assembly", S.ASSEMBLIES)
def test_assembly_matches_jax(assembly):
    # wl with pile shedding: wl bins plus add_into k-major remainders
    coo = syn.banded(2048, 24, 64, seed=2)
    csr = CSRMatrix.from_coo(coo)
    sell = SellMatrix.from_csr(csr, layout="wl-shed")
    assert any(b.add_into for b in sell.bins) and len(sell.bins) > 1
    x = np.random.default_rng(5).standard_normal(csr.ncols).astype(np.float32)
    y = S.sell_spmv(S.device_put_sell(sell, device="cpu"),
                    S.device_put_x(x, csr.ncols, device="cpu"),
                    assembly).numpy()
    jsell = JSell.from_csr(JCSR.from_coo(jsyn.banded(2048, 24, 64, seed=2)),
                           layout="wl-shed")
    y_jax = np.asarray(sell_spmv_pallas(jax_device_put_sell(jsell),
                                        jnp.asarray(x), interpret=True,
                                        assembly=assembly))
    np.testing.assert_allclose(y, y_jax, rtol=1e-6,
                               atol=1e-6 * np.abs(y_jax).max())
    ref = csr.spmv(x.astype(np.float64))
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_chain_refuses_a_core_bin_after_an_add_into_bin():
    # the wl-shed SELL with its add_into bins moved to the front: "chain"
    # would store the core bins over their sums, "auto" and "sum" do not
    # depend on the bin order
    csr = CSRMatrix.from_coo(syn.banded(2048, 24, 64, seed=2))
    d = S.device_put_sell(SellMatrix.from_csr(csr, layout="wl-shed"),
                          device="cpu")
    d.bins = sorted(d.bins, key=lambda b: not b.add_into)
    x = np.random.default_rng(5).standard_normal(csr.ncols).astype(np.float32)
    xt = S.device_put_x(x, csr.ncols, device="cpu")
    with pytest.raises(ValueError, match="add_into"):
        S.sell_spmv(d, xt, "chain")
    ref = csr.spmv(x.astype(np.float64))
    for assembly in ("auto", "sum"):
        np.testing.assert_allclose(S.sell_spmv(d, xt, assembly).numpy(), ref,
                                   rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_spmv_launch_counts():
    csr = CSRMatrix.from_coo(syn.banded(2048, 24, 64, seed=2))
    d = S.device_put_sell(SellMatrix.from_csr(csr, layout="wl-shed"),
                          device="cpu")
    n = len(d.bins)
    assert n > 1
    # "auto" runs the launch plan: a launch per joint bin, and a zero fill
    # only where the core bins leave a group unwritten
    plan = d.plan
    assert [S.sell_spmv_launches(d, a) for a in S.ASSEMBLIES] == [
        len(plan.launches) + (plan.covered != d.num_groups), 1 + 3 * n,
        1 + n]
    assert S.sell_spmv_launches(d, "auto") < 1 + n
    d.bins = d.bins[:1]
    assert S.sell_spmv_launches(d, "sum") == 2


def test_unknown_assembly_refused():
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(syn.banded(1024, 4, 8)))
    with pytest.raises(ValueError, match="assembly"):
        S.sell_spmv(S.device_put_sell(sell, device="cpu"),
                    S.device_put_x(np.ones(1024), 1024, device="cpu"), "tree")


def test_tune_skip_entry_is_skipped(tmp_path, monkeypatch):
    skip = tmp_path / ".tune_skip"
    skip.write_text("# operator opt-out\ndefault-wl\n")
    monkeypatch.setattr(tune, "_SKIP_PATH", str(skip))
    _, csr = _pair(*TUNE_MATRICES["banded"])
    tr = tune.autotune_sell(csr, device="cpu")
    rows = {n: (s, st) for n, s, st in tr.table}
    assert rows["default-wl"] == (float("inf"), {"skipped": ".tune_skip"})
    assert np.isfinite(rows["default"][0]) and len(rows) == 10


def test_autotune_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the measured path runs")
    _, csr = _pair(*TUNE_MATRICES["banded"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.autotune_sell(csr)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _band_dir(tmp_path, name="a"):
    m = tmp_path / "mats"
    m.mkdir(exist_ok=True)
    coo = syn.banded(600, 5, 30, seed=1)
    write_matrix_market(str(m / f"{name}.mtx"), coo.nrows, coo.ncols,
                        coo.row, coo.col, coo.val)
    return m


def test_cli_end_to_end_matches_the_jax_cli(tmp_path):
    m = _band_dir(tmp_path)
    out, jout = tmp_path / "result", tmp_path / "jax_result"
    common = ["--matrix-dir", str(m), "--iterations", "2", "--rounds", "1",
              "--skip", "1"]
    rc = cli.main(common + ["--output-dir", str(out), "--device", "cpu",
                            "--kernels", PORT_KERNELS, "--autotune"], **QUIET)
    assert rc == 0
    names = ("spmv_results.csv", "spmv_results_openmp.csv",
             "spmv_results_cuda.csv", "spmv_tile_config.csv",
             "matrix_memory_stats.csv")
    for f in names:
        assert (out / f).exists(), f
    # resume: the matrix is in the checkpoint, nothing is duplicated
    rc = cli.main(["--matrix-dir", str(m), "--output-dir", str(out),
                   "--device", "cpu", "--resume"], **QUIET)
    assert rc == 0
    mine = _rows(out / "spmv_results.csv")
    assert len(mine) == 1 + len(PORT_KERNELS.split(","))

    assert jcli.main(common + ["--output-dir", str(jout), "--kernels",
                               JAX_KERNELS, "--autotune"]) == 0
    theirs = _rows(jout / "spmv_results.csv")
    of = dict(zip(JAX_KERNELS.split(","), PORT_KERNELS.split(",")))
    cols = [mine[0].index(c) for c in
            ("matrix_name", "rows", "cols", "nonzeros", "significant_diffs",
             "padding_ratio")]
    stage = mine[0].index("stage")
    by_stage = {r[stage]: r for r in mine[1:]}
    assert set(by_stage) == set(of.values())
    for r in theirs[1:]:
        got = by_stage[of[r[stage]]]
        assert [got[c] for c in cols] == [r[c] for c in cols], r[stage]
    # the tuner's pick and hack size, as the JAX CLI recorded them
    tiles, jtiles = _rows(out / "spmv_tile_config.csv"), _rows(
        jout / "spmv_tile_config.csv")
    assert [r[-2:] for r in tiles[1:]] == [r[-2:] for r in jtiles[1:]]
    # the port's results render as the JAX report renders them
    assert report.best_table([str(out)]) == jreport.best_table([str(out)])
    for f in names:
        assert _rows(out / f)[0] == _rows(jout / f)[0], f


def test_cli_takes_jax_stage_names(tmp_path):
    assert cli.stages_of(JAX_KERNELS) == cli.stages_of(PORT_KERNELS) == (
        "serial_hll", "csr", "ell", "sell", "hll", "sell_sigma")
    with pytest.raises(SystemExit):
        cli.main(["--kernels", "pallas_nope", "--device", "cpu",
                  "--output-dir", str(tmp_path)], **QUIET)


def test_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the sweep runs there")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--matrix-dir", str(_band_dir(tmp_path)), "--output-dir",
                  str(tmp_path / "r")], **QUIET)
    assert not (tmp_path / "r").exists()


def test_headers_are_the_jax_constants():
    for h in ("NATIVE_HEADER", "OPENMP_HEADER", "CUDA_HEADER",
              "MEMORY_STATS_HEADER", "TILE_HEADER"):
        assert getattr(csv_report, h) == getattr(jcsv, h), h
    assert len(csv_report.OPENMP_HEADER) == 33
    assert len(csv_report.CUDA_HEADER) == 32


def test_schema_drift_raises(tmp_path):
    p = str(tmp_path / "x.csv")
    csv_report._append_row(p, ["a", "b"], [1, 2])
    csv_report._append_row(p, ["a", "b"], [3, 4])
    with pytest.raises(ValueError, match="schema mismatch"):
        csv_report._append_row(p, ["a", "b", "c"], [1, 2, 3])
    assert _rows(p) == [["a", "b"], ["1", "2"], ["3", "4"]]


def test_unknown_suite_entry_exits(tmp_path):
    with pytest.raises(SystemExit, match="unknown suite entries"):
        cli.main(["--suite-entry", "no_such_matrix", "--device", "cpu",
                  "--output-dir", str(tmp_path)], **QUIET)


def test_failing_matrix_sets_exit_1_and_the_sweep_goes_on(tmp_path, capsys):
    m = _band_dir(tmp_path, "b_good")
    (m / "a_bad.mtx").write_text("%%MatrixMarket matrix coordinate real "
                                 "general\n3 3 1\n9 9 1.0\n")
    out = tmp_path / "r"
    lines = []
    rc = cli.main(["--matrix-dir", str(m), "--output-dir", str(out),
                   "--device", "cpu", "--iterations", "1", "--rounds", "1",
                   "--kernels", "sell", "--json"], log=lines.append)
    assert rc == 1
    assert "Traceback" in capsys.readouterr().err
    assert lines[-1].startswith("sweep done: 1 ok, 1 failed")
    assert json.loads(next(l for l in lines if l.startswith("{")))[
        "matrix"] == "b_good"
    assert open(out / ".sweep_checkpoint").read().split() == ["b_good"]


def test_ladder_sweep_splits_heavy_rows(tmp_path):
    csr = CSRMatrix.from_coo(syn.power_law(2048, avg_nnz_per_row=6, seed=5))
    assert int(csr.row_nnz().max()) > 256  # a real power-law head
    out = str(tmp_path / "ladders.csv")
    rows = run_ladder_sweep("pl_probe", csr, out, iterations=2, rounds=1,
                            device="cpu", **QUIET)
    table = _rows(out)
    assert table[0] == csv_report.NATIVE_HEADER
    assert [r[4] for r in table[1:]] == [f"sell@{k}" for k in
                                         tune.DEFAULT_LADDERS]
    assert len(rows) == len(tune.DEFAULT_LADDERS)
    col = table[0].index
    for r in table[1:]:
        assert r[col("significant_diffs")] == "0"
        assert r[col("rows")] == "2048"
        assert float(r[col("bytes_streamed_per_nnz")]) > 0
        assert r[col("pct_stream_bw")] == "nan"  # not measured on the CPU


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "t")), \
            profiling.annotate("spmv"):
        torch.ones(8).sum()
    with open(tmp_path / "t" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "spmv" for e in events)
    with profiling.profile_trace(None):
        pass
