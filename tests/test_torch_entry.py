"""The port's entry programs (``entry.py``, ``demo.py``) and its API surface
against the JAX package, on the CPU.

``entry(device="cpu")`` is held against the JAX ``__graft_entry__.entry()``
(its Pallas kernel in interpret mode, as conftest forces) at the k-major f32
tolerance of ``tests/test_torch_sell.py``: rtol=1e-5, atol=1e-5*max|y_jax|,
both sum in f32 in another order. ``_dryrun_inputs(n)`` equals the JAX
dryrun's construction array for array; ``dryrun_multichip`` runs on 2 and 1
gloo CPU ranks (plain versions). The demo runs on a small seeded ``.mtx``.
"""

import os

import numpy as np
import pytest
import torch

import sparsematrixvectormultiplication_tpu as jpkg
import sparsematrixvectormultiplication_tpu_torch as P
from sparsematrixvectormultiplication_tpu.formats.coo import (
    COOMatrix as JCOO)
from sparsematrixvectormultiplication_tpu.models.synthetic import (
    banded as jbanded)
from sparsematrixvectormultiplication_tpu_torch import demo, entry, ops
from sparsematrixvectormultiplication_tpu_torch.io.mmio import (
    write_matrix_market)
from sparsematrixvectormultiplication_tpu_torch.models.synthetic import banded

RTOL = 1e-5
ATOL_REL = 1e-5


def test_entry_matches_jax_entry():
    import __graft_entry__ as graft

    jfn, jargs = graft.entry()
    y_jax = np.asarray(jfn(*jargs))
    fn, (dsell, x) = entry.entry(device="cpu")
    assert [b.layout for b in dsell.bins] == ["k-major"]
    assert x.device.type == "cpu"
    y = fn(dsell, x).numpy()
    assert y.shape == y_jax.shape == (8192,)
    np.testing.assert_allclose(y, y_jax, rtol=RTOL,
                               atol=ATOL_REL * np.abs(y_jax).max())


def _jax_dryrun_inputs(n):
    """``__graft_entry__.dryrun_multichip``'s construction (:79-81,
    :150-160) with the JAX package's generator and COOMatrix."""
    coo = jbanded(4096, 12, 256, seed=0)
    x = np.asarray(np.random.default_rng(0).standard_normal(coo.ncols),
                   np.float32)
    X = np.tile(x[:, None], (1, 8))
    rng = np.random.default_rng(3)
    ns = n * 1024
    coo_s = jbanded(ns, 3, 60, seed=3)
    nf = coo_s.row.size // 20
    coo_s = JCOO(
        ns, ns,
        np.concatenate([coo_s.row, rng.integers(0, ns, nf).astype(np.int32)]),
        np.concatenate([coo_s.col, rng.integers(0, ns, nf).astype(np.int32)]),
        np.concatenate([coo_s.val, rng.standard_normal(nf)]),
    )
    return {"coo": coo, "x": x, "X": X, "coo_split": coo_s,
            "x_split": rng.standard_normal(ns)}


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_inputs_equal_jax(n):
    ours, theirs = entry._dryrun_inputs(n), _jax_dryrun_inputs(n)
    assert ours.keys() == theirs.keys()
    for key in ("coo", "coo_split"):
        a, b = ours[key], theirs[key]
        assert (a.nrows, a.ncols) == (b.nrows, b.ncols)
        for f in ("row", "col", "val"):
            assert getattr(a, f).dtype == getattr(b, f).dtype, (key, f)
            assert np.array_equal(getattr(a, f), getattr(b, f)), (key, f)
    for key in ("x", "X", "x_split"):
        assert ours[key].dtype == theirs[key].dtype, key
        assert np.array_equal(ours[key], theirs[key]), key


def test_dryrun_multichip_two_cpu_ranks():
    logs = []
    summary = entry.dryrun_multichip(2, device_type="cpu", log=logs.append)
    assert [s["path"] for s in summary] == list(entry.DRYRUN_PATHS)
    for s in summary:
        assert s["status"] == "ok", s
        assert (s["backend"], s["ranks"]) == ("gloo", 2)
        assert s["rel_err"] <= 1e-4
        assert s["launches"] == {}   # CPU tensors never launch
    assert summary[-1]["mesh"] == (1, 2)
    assert logs[-1].endswith("(1x2 psum)")


def test_dryrun_multichip_one_rank_reports_2d_skipped():
    logs = []
    summary = entry.dryrun_multichip(1, device_type="cpu", log=logs.append)
    by = {s["path"]: s for s in summary}
    assert len(summary) == 8
    assert by["ell_2d"]["status"] == "skipped"
    assert "1x1" in by["ell_2d"]["reason"]
    assert all(s["status"] == "ok" for p, s in by.items() if p != "ell_2d")
    assert "psum)" not in logs[-1] and "2-D ELL skipped" in logs[-1]


@pytest.mark.parametrize("n, reason", [(1, "no column axis"),
                                       (5, "covers 4 of the 5"),
                                       (2, None), (4, None), (8, None)])
def test_mesh_2d_follows_jax(n, reason):
    rows = max(1, n // 2)
    mesh, why = entry._mesh_2d(n)
    assert mesh == (rows, n // rows)
    assert why is None if reason is None else reason in why


@pytest.fixture
def small_mtx(tmp_path):
    coo = banded(3000, 12, 100, seed=5)
    path = os.path.join(tmp_path, "small.mtx")
    write_matrix_market(path, coo.nrows, coo.ncols, coo.row, coo.col,
                        coo.val)
    return path


@pytest.mark.parametrize("call", ["entry", "dryrun", "demo"])
def test_entry_programs_raise_without_cuda(call, small_mtx):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = {"entry": lambda: entry.entry(),
           "dryrun": lambda: entry.dryrun_multichip(2),
           "demo": lambda: demo.main([small_mtx])}[call]
    with pytest.raises(RuntimeError, match="is_available"):
        run()


def test_demo_main_cpu(small_mtx):
    lines = []
    assert demo.main([small_mtx, "--device", "cpu"], log=lines.append) == 0
    tiers = [ln for ln in lines if "significant_diffs=" in ln]
    assert [ln.split(":")[0].split(" (")[0] for ln in tiers] == [
        "SELL f32", "SELL fp64dd", "BSR SpMM", "SELL bf16", "SELL SpMM",
        "auto matvec"]
    assert all("significant_diffs=0 " in ln for ln in tiers)
    assert any(ln.startswith("refinement (bf16 inner CG)") for ln in lines)
    assert any(ln.startswith("Chebyshev(4) PCG") for ln in lines)
    assert any(ln.startswith("PageRank") for ln in lines)
    assert lines[-1].startswith("SELL f32 time: not measured")


@pytest.mark.parametrize("diffs, residual, code", [
    ({"SELL f32": 0, "auto": 0}, 5e-12, 0),
    ({"SELL f32": 0, "auto": 0}, 1e-11, 0),
    ({"SELL f32": 0, "SELL bf16": 3}, 5e-12, 1),
    ({"SELL f32": 0}, 2e-11, 1),
    ({"SELL f32": 0}, float("nan"), 1),
])
def test_demo_exit_code(diffs, residual, code):
    assert demo.exit_code(diffs, residual) == code


def test_api_parity_with_jax():
    missing = [n for n in jpkg.__all__
               if n not in P.__all__ or not hasattr(P, n)]
    assert not missing
    for name in ("device_put_sell", "sell_spmv", "sell_spmv_dd_f64",
                 "device_put_bsr", "bsr_spmm", "pad_rhs",
                 "device_put_x_multi", "device_put_csr",
                 "csr_spmv", "device_put_sell_dd", "hll_to_sell",
                 "device_put_split", "DeviceCSR", "DeviceBSR"):
        assert name in ops.__all__ and hasattr(ops, name), name
    # the SELL SpMM function keeps to its module; the name stays the module's
    assert ops.sell_spmm.sell_spmm is P.sell_spmm
