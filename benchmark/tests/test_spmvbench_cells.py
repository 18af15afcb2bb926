"""Each cell's set-up, window, check and result line on the CPU at a tiny
size, through the package's plain versions; the controls and the faults
that ``correct`` has to catch; the command without a card; the trace's
reduction; and, on a card, one tiny cell through the CUDA kernels."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import core, spec, trace

PORT = "sparsematrixvectormultiplication_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "sparsematrixvectormultiplication_tpu"}
TINY = {"fem3d_cube": {"nx": 6, "ny": 6, "nz": 6, "dof": 3}}
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 5  # more than 32 signed bits hold


def tiny(name: str):
    cell = spec.find_cell(name)
    cell.config = dict(cell.config, params=TINY[cell.config["name"]],
                       layouts=None)
    cell.traffic = dict(cell.traffic, warmup=1, sample=3)
    return cell


def run(cell, trace_on=False, control=None, device="cpu", seed=SEED,
        seconds=0.05):
    return core.run_cell(cell, seed, seconds, trace_on, device,
                         time.perf_counter(), log=lambda *a: None,
                         control=control)


def _well_formed(line, cell, trace_on):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = cell.per_layer if trace_on else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    for name, m in line["metrics"].items():
        assert m["unit"] == next(x["unit"] for x in want
                                 if x["name"] == name)
        assert isinstance(m["value"], float | int)
    assert set(line["checks"]) == set(cell.limits)
    json.dumps(line)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu_at_a_tiny_size(name):
    cell = tiny(name)
    line = run(cell)
    assert line["correct"] is True, line["checks"]
    _well_formed(line, cell, False)
    assert "setup_s" in line["metrics"]
    assert len(line["metrics"]) == len(cell.end_to_end)
    traced = run(cell, trace_on=True)
    _well_formed(traced, cell, True)
    # no trace on the CPU: the device metrics are left out, not made up
    assert not [m for m in traced["metrics"] if "roofline" in m]
    assert "convert_s" in traced["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The package at the next lower precision (bf16 values for f32, the
    f32 kernels for double-double) fails the cell's limits."""
    cell = tiny(name)
    line = run(cell, control=cell.traffic["control"])
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _stale(fn):
    held = []

    def broken(*a, **k):
        out = fn(*a, **k)
        held[:] = held or [out]
        return held[0]  # the first answer, whatever was asked after
    return broken


def _altered(fn):
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        out.view(-1)[7] += 1.0
        return out
    return broken


def _half_rows(fn):
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return broken


def _half_rhs(fn):
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        out[:, out.shape[1] // 2:] = 0
        return out
    return broken


def _cg_unchanged(fn):
    def broken(matvec, b, *a, **k):
        return torch.zeros_like(b), 1, torch.zeros(())
    return broken


def _cg_altered(fn):
    def broken(*a, **k):
        x, iters, res = fn(*a, **k)
        x = x.clone()
        x[3] += 1.0
        return x, iters, res
    return broken


def _cg_one_short(fn):
    """The solve stopped one iteration before its stop test would."""
    def broken(*a, **k):
        _, iters, _ = fn(*a, **k)
        return fn(*a, **dict(k, maxiter=iters - 1))
    return broken


FAULTS = [
    ("fem3d_cube.spmv_f32", "sell_spmv", _stale),
    ("fem3d_cube.spmv_f32", "sell_spmv", _altered),
    ("fem3d_cube.spmv_f32", "sell_spmv", _half_rows),
    ("fem3d_cube.spmv_dd", "sell_spmv_dd_f64", _stale),
    ("fem3d_cube.spmv_dd", "sell_spmv_dd_f64", _altered),
    ("fem3d_cube.spmm_r16_f32", "sell_spmm", _half_rhs),
    ("fem3d_cube.spmm_r16_f32", "sell_spmm", _altered),
    ("fem3d_cube.pcg_jacobi_f32", "cg", _cg_unchanged),
    ("fem3d_cube.pcg_jacobi_f32", "cg", _cg_altered),
    ("fem3d_cube.pcg_jacobi_f32", "cg", _cg_one_short),
]


@pytest.mark.parametrize("name,entry,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, _, f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, name, entry, fault):
    """A run whose timed path is broken underneath the harness (an answer
    left unchanged, altered where it is made, half of it left out) comes
    out not correct."""
    import importlib

    port = importlib.import_module(PORT)
    monkeypatch.setattr(port, entry, fault(getattr(port, entry)))
    cell = tiny(name)
    cell.traffic = dict(cell.traffic, sample=50)
    line = run(cell, seconds=2.0 if fault is _stale else 0.05)
    if fault is _stale:  # the window asks for more than the first answer
        assert line["attempted"] >= 2
    assert line["correct"] is False
    assert line["failed"] >= 1


def test_layout_changes_plane_bytes_not_the_roofline_count(monkeypatch):
    """The roofline count depends on the configuration alone: a SELL
    forced to another layout moves other bytes and counts the same."""
    import importlib

    port = importlib.import_module(PORT)
    real = port.SellMatrix.from_csr.__func__
    counted, planes = set(), set()
    for layout in ("k-major", "sb-major", "wl"):
        monkeypatch.setattr(port.SellMatrix, "from_csr", classmethod(
            lambda cls, csr, _l=layout, **k: real(cls, csr, layout=_l, **k)))
        seen = {}

        def keep(r, _seen=seen):
            _seen["run"] = r
            return None

        monkeypatch.setattr(core, "read_metrics",
                            lambda r, m, _k=keep: _k(r) or {})
        run(tiny("fem3d_cube.spmv_f32"))
        r = seen["run"]
        from benchmark.reference import roofline

        counted.add(roofline.count(r.nnz, r.nrows, r.ncols, r.precision,
                                   r.rhs))
        planes.add(r.counters["plane_bytes"])
    assert len(counted) == 1 and len(planes) == 3


def test_conversion_to_other_layouts_fails_the_run():
    cell = tiny("fem3d_cube.spmv_f32")
    cell.config = dict(cell.config, layouts=["sg"])
    with pytest.raises(core.LayoutError):
        run(cell)


def test_command_exits_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "fem3d_cube.spmv_f32", "--seed", str(SEED), "--seconds", "1",
           "--trace", "0"]
    p = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 3 and p.stdout == ""
    bad = subprocess.run(cmd[:3] + ["no_such.cell"] + cmd[4:], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode == 2 and bad.stdout == ""
    # a directory with BENCHMARK.json and the benchmark alone
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    alone = subprocess.run(cmd, cwd=tmp_path, capture_output=True,
                           text=True, timeout=300)
    assert alone.returncode != 0 and alone.stdout == ""


def test_no_jax_is_reached_from_a_run():
    code = (
        "import sys, time\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark.tests.test_spmvbench_cells import tiny, run\n"
        "import benchmark.run\n"
        "for name in sys.argv[1:]:\n"
        "    assert run(tiny(name), trace_on=True)['correct']\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code,
                        "fem3d_cube.spmv_f32", "fem3d_cube.spmv_dd"],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))  # noqa: S307
    assert PORT in top and not top & FORBIDDEN


def test_forbidden_modules_are_named_by_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(spec.BENCH_DIR))
    try:
        import run as cli
    finally:
        sys.path.remove(str(spec.BENCH_DIR))
    assert PORT in sys.modules and cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert cli.forbidden_modules() == ["jax"]


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


def test_trace_reduction():
    events = [
        _ev("user_annotation", trace.WINDOW, 1000.0, 100.0),
        _ev("user_annotation", "cg", 1000.0, 90.0),
        _ev("user_annotation", "matvec", 1005.0, 10.0),
        _ev("kernel", "wl", 1010.0, 20.0),      # busy 1010-1030
        _ev("kernel", "axpy", 1025.0, 10.0),    # overlaps: busy to 1035
        _ev("gpu_memcpy", "copy", 1050.0, 5.0),
        _ev("kernel", "late", 1098.0, 10.0),    # clipped to the window
        _ev("kernel", "before", 900.0, 10.0),   # outside
        _ev("cpu_op", "aten::add", 1001.0, 2.0),
    ]
    out = trace.reduce_trace(events)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx((25 + 5 + 2) * 1e-6)
    assert out["device_s"] == pytest.approx((20 + 10 + 5 + 2) * 1e-6)
    assert out["ops"][0] == ["wl", pytest.approx(20e-6)]
    gaps = dict(out["gaps"])
    # every gap opens inside cg; the matvec span has closed by 1035
    assert gaps["cg"] == pytest.approx((10 + 15 + 43) * 1e-6)
    assert "matvec" not in gaps  # 1000 is before the matvec span opens
    assert trace.reduce_trace(events[:3]) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny(name)
    line = run(cell, trace_on=True, device="cuda")
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert [m for m in line["metrics"]
            if m.startswith(("launches_per_call", "iters_per_solve"))]
