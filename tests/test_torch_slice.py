"""The port's main path as a whole, on the CPU: run_matrix end to end, the
slice against the JAX package's own pipeline, and the import contract."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix as JSell
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    device_put_sell as jax_device_put_sell,
    sell_spmv_pallas,
)
from sparsematrixvectormultiplication_tpu_torch import (
    COOMatrix,
    CSRMatrix,
    SellMatrix,
    device_put_sell,
    device_put_x,
    run_matrix,
    sell_spmv,
)
from sparsematrixvectormultiplication_tpu_torch.bench.harness import BenchConfig
from sparsematrixvectormultiplication_tpu_torch.io.mmio import write_matrix_market
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("serial_csr", "sell", "sell_bf16", "sell_dd")


def test_slice_matches_jax_pipeline():
    """Same seed through both packages' generator -> CSR -> SELL "auto" ->
    upload -> SpMV; the JAX side runs its Pallas kernels in interpret mode.
    fem_3d(8,8,8) converts to one k-major and one wl bin."""
    x = np.random.default_rng(21).standard_normal(1536).astype(np.float32)
    jsell = JSell.from_csr(JCSR.from_coo(jsyn.fem_3d(8, 8, 8, dof=3, seed=0)))
    y_ref = np.asarray(sell_spmv_pallas(
        jax_device_put_sell(jsell, jnp.float32), jnp.asarray(x),
        interpret=True))
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(
        syn.fem_3d(8, 8, 8, dof=3, seed=0)))
    assert sorted(b.layout for b in sell.bins) == ["k-major", "wl"]
    y = sell_spmv(device_put_sell(sell, device="cpu"),
                  device_put_x(x, sell.ncols, device="cpu")).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(y_ref).max())


def _mtx_coo(tmp_path):
    coo = syn.banded(3000, 16, 200, seed=2)
    path = tmp_path / "b.mtx"
    write_matrix_market(path, coo.nrows, coo.ncols, coo.row, coo.col, coo.val)
    return COOMatrix.from_mtx(path)


MATRICES = {
    # entry point's matrix: short rows, so the heavy rows split into
    # segments that index_add_ reduces back
    "entry_banded": lambda tmp: syn.banded(8192, 24, 512, seed=0),
    "fem_mixed": lambda tmp: syn.fem_3d(8, 8, 8, dof=3, seed=1),
    "mtx": _mtx_coo,
}


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_run_matrix_on_cpu(matrix, tmp_path):
    coo = MATRICES[matrix](tmp_path)
    x = np.random.default_rng(3).standard_normal(coo.ncols)
    logs = []
    res = run_matrix(matrix, coo, BenchConfig(iterations=2, skip=1), x=x,
                     log=logs.append, device="cpu")
    assert tuple(res.stages) == STAGES
    for name in STAGES:
        st = res.stages[name]
        assert st.diff.significant_diffs == 0, (name, st.diff)
        assert st.seconds > 0 and st.gflops > 0
    assert res.sell is not None and res.nnz == coo.nnz
    assert any("sell_bf16" in m for m in logs)


def test_run_matrix_splits_heavy_rows():
    coo = syn.banded(8192, 24, 512, seed=0)
    res = run_matrix("entry", coo, BenchConfig(iterations=1, skip=0),
                     log=lambda m: None, device="cpu")
    assert res.format_stats["heavy_row_segments"] > 0
    assert res.sell.nrows > coo.nrows
    assert res.stages["sell"].diff.significant_diffs == 0


def test_failing_stage_raises(monkeypatch):
    """A stage's failure propagates: a conversion that yields a layout with
    no kernel stops run_matrix instead of being skipped."""
    from sparsematrixvectormultiplication_tpu_torch.bench import harness

    real = harness.SellMatrix.from_csr

    def bogus(csr, **kw):
        sell = real(csr, **kw)
        return dataclasses.replace(sell, bins=[
            dataclasses.replace(b, layout="hll") for b in sell.bins])

    monkeypatch.setattr(harness.SellMatrix, "from_csr", bogus)
    coo = syn.random_general(4096, 65536, 8 / 65536, seed=0)
    with pytest.raises(ValueError, match="unknown SELL bin layout 'hll'"):
        run_matrix("sg", coo, log=lambda m: None, device="cpu")


# matrix -> the layouts its "auto" conversion inside run_matrix must hold
LAYOUTS = {
    "banded_sb_major": (lambda: syn.banded(8192, 60, 2500, seed=1),
                        {"sb-major"}),
    "road": (lambda: syn.road_network(8000, seed=5),
             {"sg", "sb-list", "k-major"}),
    "uniform": (lambda: syn.random_general(20000, 20000, 2.5e-4, seed=8),
                {"sg", "k-major"}),
}


@pytest.mark.parametrize("matrix", sorted(LAYOUTS))
def test_run_matrix_runs_every_layout_on_cpu(matrix):
    make, layouts = LAYOUTS[matrix]
    coo = make()
    res = run_matrix(matrix, coo, BenchConfig(iterations=1, skip=0),
                     x=np.random.default_rng(6).standard_normal(coo.ncols),
                     log=lambda m: None, device="cpu")
    assert {b.layout for b in res.sell.bins} == layouts
    assert res.sell.row_perm is None
    if "sg" in layouts:
        assert any(b.add_into for b in res.sell.bins)
    for name in ("sell", "sell_bf16", "sell_dd"):
        assert res.stages[name].diff.significant_diffs == 0, name


def test_run_matrix_falls_back_to_sigma_like_jax():
    """A power-law matrix whose plain SELL pads more than 8x is rebuilt with
    SELL-sigma row sorting, bin for bin as the JAX harness rebuilds it; the
    kernel rows map back through the permutation and the segment map."""
    coo = syn.power_law(4000, 2, seed=6)
    logs = []
    res = run_matrix("pl", coo, BenchConfig(iterations=1, skip=0),
                     x=np.random.default_rng(7).standard_normal(coo.ncols),
                     log=logs.append, device="cpu")
    assert any("auto sigma" in m for m in logs)
    assert res.sell.row_perm is not None
    jcsr = JCSR.from_coo(jsyn.power_law(4000, 2, seed=6))
    jcsr_k, seg = jcsr.split_heavy_rows(16, strided=True)
    assert seg is not None and res.format_stats["heavy_row_segments"] > 0
    assert JSell.from_csr(jcsr_k).padding_ratio > 8
    want = JSell.from_csr(jcsr_k, sigma_sort=True)
    assert [(b.layout, b.k, b.n_groups) for b in res.sell.bins] == [
        (b.layout, b.k, b.n_groups) for b in want.bins]
    assert np.array_equal(res.sell.row_perm, want.row_perm)
    for name in ("sell", "sell_bf16", "sell_dd"):
        assert res.stages[name].diff.significant_diffs == 0, name


def _run_python(code, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax_or_nvcc():
    code = (
        "import pkgutil, sys, importlib\n"
        "import sparsematrixvectormultiplication_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from sparsematrixvectormultiplication_tpu_torch.ops import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'ml_dtypes', 'triton',\n"
        "        'sparsematrixvectormultiplication_tpu', 'probes')]\n"
        "assert not bad, bad\n"
        "assert _build.load.cache_info().currsize == 0\n"
        "for m in ('bench.bw_probe', 'bench.kernel_probe', 'bench.harness',\n"
        "          'formats.hll', 'formats.reorder', 'ops.hll', 'ops.xla',\n"
        "          'native.build'):\n"
        "    assert P.__name__ + '.' + m in sys.modules, m\n"
        "from sparsematrixvectormultiplication_tpu_torch.native import (\n"
        "    build as nb)\n"
        "assert not any(f.cache_info().currsize for f in (\n"
        "    nb.load_fast_csr, nb.load_fast_mmio, nb.load_fast_route,\n"
        "    nb.load_fast_bsr))\n"
        "print('ok')\n"
    )
    # no nvcc anywhere: PATH holds only the interpreter's directory
    proc = _run_python(code, ROOT, {"PATH": os.path.dirname(sys.executable),
                                    "CUDA_HOME": "/nonexistent"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
