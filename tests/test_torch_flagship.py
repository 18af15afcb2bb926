"""The flagship line (``bench/flagship.py``, ≙ bench.py) on the CPU.

Each matrix's function runs its stages at a small size from seed 1 with the
kernels' plain versions (``device="cpu"``) and is held against the JAX
``run_matrix`` with bench.py's stages (``pallas_sell`` in interpret mode, as
``tests/test_torch_harness.py`` runs it): the same nnz, SELL bins and
layouts, and no significant difference on either side. The JAX stage's
timer is stubbed out: its times are not compared, and each chain length it
times is another interpret-mode compile. The sizes keep each JAX kernel's
first compile to a few seconds: a wl bin of 3 groups (banded(3000, 60,
250)) or an sb-list bin of 20 (road_network(20_000)) takes 50-66 s, so
the banded matrix is cut to 2048 rows (k-major) and road to 2000 (sb-list
of 2 groups). The record's keys follow bench.py's arithmetic; a stage with
differences makes it invalid (exit 1); a failing matrix raises, and the
program exits 2 with an ``"error"`` line, as it does without CUDA.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest

import sparsematrixvectormultiplication_tpu.bench.harness as jharness
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu_torch.bench import flagship as F
from sparsematrixvectormultiplication_tpu_torch.bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"fem3d_cube": (6, 6, 6), "banded_adversarial": (2048, 60, 2500),
         "road_scattered": (2000,)}
RUNNERS = {"fem3d_cube": F.run_fem3d_cube,
           "banded_adversarial": F.run_banded_adversarial,
           "road_scattered": F.run_road_scattered}
# the layouts each small matrix converts to (the JAX conversion's too)
LAYOUTS = {"fem3d_cube": {"k-major"}, "banded_adversarial": {"k-major"},
           "road_scattered": {"sb-list"}}
GENERATE_S = {"fem3d_cube": 0.5, "banded_adversarial": 0.25,
              "road_scattered": 0.125}


def _quiet(*a):
    pass


def _run_small(name, layouts=None):
    return RUNNERS[name](F.make_matrix(name, *SIZES[name]), "cpu", _quiet,
                         layouts=layouts or LAYOUTS[name], iterations=1)


@pytest.fixture(scope="module")
def results():
    return {name: _run_small(name) for name in F.MATRICES}


def _record(results):
    return F.flagship_record(results, device="cpu", power_limit_w=None,
                             wall_s=1.5, generate_s=GENERATE_S, log=_quiet)


@pytest.mark.parametrize("name", list(F.MATRICES))
def test_flagship_matches_the_jax_harness(name, results, monkeypatch):
    monkeypatch.setattr(jharness, "time_device_fn_slope",
                        lambda fn, *a, **kw: (1.0, None))
    gen, _, stages, sell_layout = F.MATRICES[name][:4]
    kw = {"dof": 3} if gen == "fem_3d" else {}
    theirs = jharness.run_matrix(name, getattr(jsyn, gen)(
        *SIZES[name], **kw, seed=1), jharness.BenchConfig(
        iterations=1, skip=0, rounds=1, dtype="float32",
        kernels=("serial_csr", "pallas_sell"), sell_layout=sell_layout,
        flush_between_stages=False), log=_quiet)
    mine = results[name]
    assert mine.nnz == theirs.nnz
    assert tuple(mine.stages) == ("serial_csr", *stages)
    for stat in ("bin_layouts", "bin_ks", "padded_nnz"):
        assert (mine.format_stats["sell"][stat]
                == theirs.format_stats["sell"][stat]), stat
    assert {b.layout for b in mine.sell.bins} == LAYOUTS[name]
    assert theirs.stages["pallas_sell"].diff.significant_diffs == 0
    assert all(st.diff.significant_diffs == 0 for st in mine.stages.values())
    assert F.stage_failures(mine) == []
    if "sell_dd" in stages:
        assert mine.stages["sell_dd"].norm_err < F.DD_TOL
    assert all(mine.format_stats[f"upload_{s}_s"] >= 0 for s in stages)


def test_record_follows_bench_py(results):
    rec = _record(results)
    assert list(rec)[:17] == [
        "metric", "value", "unit", "vs_baseline", "valid", "mean_rel_err",
        "nnz", "time_ms", "fp64_dd_gflops", "fp64_dd_vs_baseline",
        "fp64_dd_max_rel_err", "bf16_gflops", "bf16_vs_baseline",
        "adversarial_banded_f32_gflops", "adversarial_banded_dd_gflops",
        "scattered_road_f32_gflops", "scattered_road_vs_ref_warp"]
    assert set(rec) - set(list(rec)[:17]) == {
        "device", "power_limit_w", "setup_s", "wall_s", "reps"}
    assert all(v is not None for k, v in rec.items() if k != "power_limit_w")
    fem, band, road = (results[n] for n in F.MATRICES)

    def gflops(res, stage):
        return 2 * res.nnz / res.stages[stage].seconds / 1e9

    assert rec["metric"] == "sell_f32_gflops_fem3d_51Mnnz"
    assert rec["valid"] is True
    assert rec["value"] == round(gflops(fem, "sell"), 3)
    assert rec["vs_baseline"] == round(gflops(fem, "sell") / 47.09, 4)
    assert rec["time_ms"] == round(fem.stages["sell"].seconds * 1e3, 3)
    assert rec["nnz"] == fem.nnz
    assert rec["mean_rel_err"] == fem.stages["sell"].diff.mean_rel_err
    assert rec["fp64_dd_gflops"] == round(gflops(fem, "sell_dd"), 3)
    assert rec["fp64_dd_vs_baseline"] == round(gflops(fem, "sell_dd") / 47.09,
                                               4)
    assert (rec["fp64_dd_max_rel_err"]
            == fem.stages["sell_dd"].diff.max_rel_err)
    assert rec["bf16_gflops"] == round(gflops(fem, "sell_bf16"), 3)
    assert rec["bf16_vs_baseline"] == round(gflops(fem, "sell_bf16") / 47.09,
                                            4)
    assert rec["adversarial_banded_f32_gflops"] == round(gflops(band, "sell"),
                                                         3)
    assert rec["adversarial_banded_dd_gflops"] == round(
        gflops(band, "sell_dd"), 3)
    assert rec["scattered_road_f32_gflops"] == round(gflops(road, "sell"), 3)
    assert rec["scattered_road_vs_ref_warp"] == round(
        gflops(road, "sell") / 2.59, 3)
    assert rec["reps"] == {n: {s: 1 for s in F.MATRICES[n][2]}
                           for n in F.MATRICES}
    for n, res in results.items():
        fs = res.format_stats
        assert rec["setup_s"][n] == {
            "generate": GENERATE_S[n],
            "convert": fs["convert_csr_s"] + fs["convert_sell_s"],
            "upload": sum(fs[f"upload_{s}_s"] for s in F.MATRICES[n][2])}
    json.dumps(rec)


@pytest.mark.parametrize("name, stage, field, value", [
    ("fem3d_cube", "sell_bf16", "significant_diffs", 3),
    ("fem3d_cube", "sell_dd", "norm_err", 1e-9),
    ("banded_adversarial", "sell_dd", "significant_diffs", 1),
    ("road_scattered", "sell", "significant_diffs", 2),
])
def test_a_stage_with_differences_is_not_valid(name, stage, field, value,
                                               results, monkeypatch, capsys):
    bad = dict(results)
    bad[name] = copy.copy(results[name])
    bad[name].stages = dict(bad[name].stages)
    st = bad[name].stages[stage]
    bad[name].stages[stage] = (
        dataclasses.replace(st, norm_err=value) if field == "norm_err" else
        dataclasses.replace(st, diff=dataclasses.replace(
            st.diff, significant_diffs=value)))
    assert len(F.stage_failures(bad[name])) == 1
    rec = _record(bad)
    assert rec["valid"] is False
    assert _record(results)["valid"] is True
    # the line is still printed, last on stdout, and the exit code is 1
    monkeypatch.setattr(F, "run", lambda: rec)
    assert F.main([]) == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["valid"] is False


def test_a_conversion_to_other_layouts_raises():
    with pytest.raises(RuntimeError, match="another kernel"):
        _run_small("road_scattered", layouts={"sb-major"})


def test_a_failing_road_stage_raises(monkeypatch, capsys):
    def broken(*a, **kw):
        raise RuntimeError("sb_list launch failed")

    monkeypatch.setattr(harness, "sell_spmv", broken)
    with pytest.raises(RuntimeError, match="sb_list launch failed"):
        _run_small("road_scattered")
    # through main: an error line, never null keys, and exit 2
    monkeypatch.setattr(F, "run", lambda: _run_small("road_scattered"))
    assert F.main([]) == 2
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "error"}
    assert "sb_list launch failed" in last["error"]


def test_program_without_cuda_exits_nonzero_with_an_error_line():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "sparsematrixvectormultiplication_tpu_torch"
         ".bench"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    last = json.loads(lines[-1])
    assert last["metric"] == F.METRIC and "is_available" in last["error"]
