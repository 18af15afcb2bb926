"""The port's device-count sweeps against the JAX package's, on the CPU.

``run_path_scale_sweep`` (paths sell, hll, pr, sell_cols, split),
``run_device_scale_sweep`` and ``run_spmm_device_scale_sweep`` run each
device count on spawned gloo CPU ranks (the plain versions); their
openmp-schema rows must equal the JAX sweeps' (on conftest's virtual CPU
devices, Pallas in interpret mode) in every column that does not depend on
time, and hold positive times where the JAX rows do. The CLI's
``--scale-sweep --force-cpu-devices 2`` runs the whole sweep on the CPU
and writes ``spmv_scale_devices.csv`` with the JAX header. Inputs come
from seeded generators.
"""

import csv

import pytest
import torch

from sparsematrixvectormultiplication_tpu.bench import scale as jscale
from sparsematrixvectormultiplication_tpu.formats.csr import (
    CSRMatrix as JCSR)
from sparsematrixvectormultiplication_tpu_torch.bench import cli
from sparsematrixvectormultiplication_tpu_torch.bench import scale
from sparsematrixvectormultiplication_tpu_torch.bench.csv_report import (
    OPENMP_HEADER)
from sparsematrixvectormultiplication_tpu_torch.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.io.mmio import (
    write_matrix_market)
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn

QUIET = {"log": lambda *a: None}
# the openmp-schema columns a device curve fills with times or rates
TIMED = {"parallel": (5, 7, 19, 21, 25, 29), "hll": (6, 9, 20, 23, 27, 31)}


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _jcsr(csr):
    return JCSR(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx, csr.values)


def _csr(kind):
    if kind == "banded":
        return CSRMatrix.from_coo(syn.banded(4096, 6, 64, seed=1))
    return CSRMatrix.from_coo(syn.road_network(8192, seed=2)) \
        .split_heavy_rows(1024)[0]


def _same_rows(mine, theirs, role="parallel"):
    """Equal in every column that does not depend on time; positive times
    where the JAX rows have them."""
    assert mine[0] == theirs[0] == OPENMP_HEADER
    assert len(mine) == len(theirs)
    timed = TIMED[role]
    for a, b in zip(mine[1:], theirs[1:]):
        assert [v for i, v in enumerate(a) if i not in timed] == \
            [v for i, v in enumerate(b) if i not in timed]
        for i in timed:
            assert (float(a[i]) > 0) == (float(b[i]) > 0), OPENMP_HEADER[i]


@pytest.mark.parametrize("path,kind", [
    ("sell", "banded"), ("hll", "banded"), ("sell_cols", "banded"),
    ("pr", "road"), ("split", "road")])
def test_path_scale_sweep_matches_jax(path, kind, tmp_path):
    csr = _csr(kind)
    out, jout = str(tmp_path / "scale.csv"), str(tmp_path / "jax.csv")
    results = scale.run_path_scale_sweep(
        "tiny", csr, out, path, device_counts=[2], iterations=2, rounds=1,
        device="cpu", **QUIET)
    assert [r[0] for r in results] == [2]
    for n, sec, gf, dm in results:
        assert dm.significant_diffs == 0 and sec > 0 and gf > 0
    jscale.run_path_scale_sweep("tiny", _jcsr(csr), jout, path,
                                device_counts=[2], iterations=2, rounds=1,
                                log=lambda m: None)
    role = "hll" if path == "hll" else "parallel"
    _same_rows(_rows(out), _rows(jout), role)
    assert _rows(out)[1][0] == f"tiny[{path}]"


def test_spmm_device_scale_sweep_matches_jax(tmp_path):
    csr = _csr("banded")
    out, jout = str(tmp_path / "spmm.csv"), str(tmp_path / "jax.csv")
    results = scale.run_spmm_device_scale_sweep(
        "tiny", csr, out, device_counts=[2], rhs=8, iterations=2, rounds=1,
        device="cpu", **QUIET)
    assert results[0][3].significant_diffs == 0
    jscale.run_spmm_device_scale_sweep("tiny", _jcsr(csr), jout,
                                       device_counts=[2], rhs=8,
                                       iterations=2, rounds=1,
                                       log=lambda m: None)
    _same_rows(_rows(out), _rows(jout))
    assert _rows(out)[1][0] == "tiny@spmm8"


def test_cli_scale_sweep_on_forced_cpu_devices(tmp_path):
    m = tmp_path / "mats"
    m.mkdir()
    coo = syn.banded(4096, 6, 64, seed=1)
    write_matrix_market(str(m / "band.mtx"), coo.nrows, coo.ncols, coo.row,
                        coo.col, coo.val)
    out = tmp_path / "result"
    # no --device cpu: --force-cpu-devices asks for the CPU on its own
    rc = cli.main(["--matrix-dir", str(m), "--output-dir", str(out),
                   "--kernels", "sell", "--iterations", "8", "--rounds", "1",
                   "--skip", "1", "--scale-sweep", "--force-cpu-devices", "2"],
                  **QUIET)
    assert rc == 0
    rows = _rows(out / "spmv_scale_devices.csv")
    ncol = rows[0].index("num_threads")
    assert [r[ncol] for r in rows[1:]] == ["1", "2"]
    jout = str(tmp_path / "jax.csv")
    csr = CSRMatrix.from_coo(coo)
    jscale.run_device_scale_sweep("band", _jcsr(csr), jout,
                                  device_counts=[1, 2], iterations=2,
                                  rounds=1, log=lambda m: None)
    _same_rows(rows, _rows(jout))


def test_sweeps_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the sweeps run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scale.run_device_scale_sweep("tiny", _csr("banded"),
                                     str(tmp_path / "x.csv"), **QUIET)
    assert not (tmp_path / "x.csv").exists()


def test_unknown_path_is_refused(tmp_path):
    with pytest.raises(ValueError, match="unknown path"):
        scale.run_path_scale_sweep("tiny", _csr("banded"),
                                   str(tmp_path / "x.csv"), "nope",
                                   device="cpu", **QUIET)


def test_counts_default_to_the_devices():
    cpu = torch.device("cpu")
    assert scale._device_counts(cpu, None, None) == [1]
    assert scale._device_counts(cpu, 8, None) == [1, 2, 4, 8]
    assert scale._device_counts(cpu, 6, None) == [1, 2, 4]
    assert scale._device_counts(cpu, 6, [3]) == [3]
