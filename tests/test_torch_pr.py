"""The port's PR (permutation-routed) path on the CPU, against the JAX package.

* Host layer: the port's ``formats/pr_route.py`` and ``formats/pr.py`` give
  the JAX package's arrays (np.array_equal, dtypes included); the port's
  native router builds with g++ and gives the JAX router's products.
* Upload: the composed ``route`` plane equals the Beneš stages plus the
  final lane gather applied to an iota.
* SpMV: the plain versions against ``pr_spmv_pallas`` /
  ``pr_spmv_pallas_dd`` in interpret mode on the same host product, and
  against the fp64 oracle. Tolerances are the JAX tests' own
  (tests/test_pr.py:156, :245): f32 ``max|Δ| / max(1, |ref|) < 5e-6`` (sums
  in another order), dd ``< 1e-11``.
"""

import functools
import os

import numpy as np
import pytest
import torch

from test_torch_formats import _assert_same as _same

from sparsematrixvectormultiplication_tpu.formats import pr as jpr
from sparsematrixvectormultiplication_tpu.formats import pr_route as jroute
from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix as JCOO
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.ops.pallas_pr import (
    device_put_pr as jax_device_put_pr,
    pr_spmv_pallas,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_pr_dd import (
    device_put_pr_dd as jax_device_put_pr_dd,
    pr_spmv_pallas_dd,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    device_put_x as jax_device_put_x,
)
from sparsematrixvectormultiplication_tpu_torch import run_matrix
from sparsematrixvectormultiplication_tpu_torch.bench.harness import BenchConfig
from sparsematrixvectormultiplication_tpu_torch.formats import pr as ppr
from sparsematrixvectormultiplication_tpu_torch.formats import pr_route as proute
from sparsematrixvectormultiplication_tpu_torch.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.native import build as nbuild
from sparsematrixvectormultiplication_tpu_torch.ops import pr as P
from sparsematrixvectormultiplication_tpu_torch.ops import pr_dd as PD
from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
    combine_f64,
)
from sparsematrixvectormultiplication_tpu_torch.ops.sell import device_put_x
from sparsematrixvectormultiplication_tpu_torch.ops.sell_dd import (
    device_put_x_dd,
)

F32_REL = 5e-6   # max|Δ| / max(1, |ref|), tests/test_pr.py:156
DD_REL = 1e-11   # tests/test_pr.py:245


def _far_tile_coo():
    """Few, very scattered columns: slab gaps give far tiles
    (tests/test_pr.py:159-183)."""
    rng = np.random.default_rng(0)
    n, m = 600, 2_000_000
    return COOMatrix(n, m, rng.integers(0, n, 1600).astype(np.int32),
                     rng.integers(0, m, 1600).astype(np.int32),
                     rng.standard_normal(1600))


# tests/test_pr.py:102-107's cases, the far-tile case and the panel case
CASES = {
    "random": (lambda: syn.random_general(500, 400, 0.01, seed=2), None),
    "powerlaw": (lambda: syn.power_law(1500, 3, seed=3), None),
    "banded": (lambda: syn.banded(800, 5, 50, seed=4), None),
    "road": (lambda: syn.road_network(1200, seed=5), None),
    "far_tiles": (_far_tile_coo, None),
    "panels": (lambda: syn.random_general(3000, 2500, 0.01, seed=11), 512),
}
HOST_CASES = ("random", "powerlaw", "banded", "road", "panels")


@functools.cache
def _csrs(name):
    """The case's CSR in both packages, from the same arrays."""
    csr = CSRMatrix.from_coo(CASES[name][0]())
    return csr, JCSR(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                     csr.values)


def _build(mod, csr, name, native):
    target = CASES[name][1]
    if target is None:
        return mod.PRMatrix.from_csr(csr, native=native)
    return mod.PanelPRMatrix.from_csr(csr, native=native, target_rows=target)


@functools.cache
def _port_pr(name, native=False):
    return _build(ppr, _csrs(name)[0], name, native)


@functools.cache
def _jax_pr(name):
    # the JAX package's native router; test_host_product_matches_jax holds
    # the port's Python router to it array for array
    return _build(jpr, _csrs(name)[1], name, True)


def _x(n, seed=7):
    return np.random.default_rng(seed).standard_normal(n)


def _rel(y, ref):
    return float((np.abs(y - ref) / np.maximum(1.0, np.abs(ref))).max())


# ---- routing primitives and the native router ----


@pytest.mark.parametrize("n", [2, 8, 64, 512])
def test_benes_primitives_match_jax(n):
    rng = np.random.default_rng(n)
    assert proute.benes_stage_distances(n) == jroute.benes_stage_distances(n)
    for _ in range(3):
        perm = rng.permutation(n)
        masks = proute.benes_masks(perm)
        _same(masks, jroute.benes_masks(perm))
        a = rng.standard_normal((n, 3))
        _same(proute.apply_benes(a, masks), jroute.apply_benes(a, masks))
        out = proute.apply_benes(np.arange(n), masks)
        assert np.array_equal(out[perm], np.arange(n))


@pytest.mark.parametrize("deg", [2, 8, 32])
def test_edge_colouring_matches_jax(deg):
    rng = np.random.default_rng(deg)
    src = np.repeat(np.arange(24), deg)
    dst = rng.permutation(src.copy())
    _same(proute.edge_color_128(src, dst, 24, degree=deg),
          jroute.edge_color_128(src, dst, 24, degree=deg))


def _route_problem(n_rows, seed):
    pos = np.random.default_rng(seed).permutation(n_rows * 128)
    return np.repeat(np.arange(n_rows), 128), pos // 128, pos % 128, n_rows


def _moves_elements(src_row, dst_row, dst_lane, n_rows, out):
    """The routing semantics (tests/test_pr.py:58-70): every element placed
    at (src_row, src_lane) reaches (dst_row, dst_lane)."""
    src_lane, packed, final_lane = out
    vals = np.random.default_rng(7).standard_normal(n_rows * 128)
    a = np.zeros((n_rows, 128))
    a[src_row, src_lane] = vals
    for s, d in enumerate(proute.benes_stage_distances(n_rows)):
        a = np.where(((packed >> s) & 1).astype(bool),
                     a[np.arange(n_rows) ^ d], a)
    ref = np.zeros((n_rows, 128))
    ref[dst_row, dst_lane] = vals
    return np.array_equal(np.take_along_axis(a, final_lane.astype(np.int64),
                                             axis=1), ref)


def test_route_elements_matches_jax():
    prob = _route_problem(16, 0)
    out = proute.route_elements(*prob)
    _same(out, jroute.route_elements(*prob))
    assert _moves_elements(*prob, out)


def test_native_router_builds_and_matches_jax():
    """The port's router builds with g++ into build/native/ and gives the
    JAX package's native products (the same source, whose lanes are each
    routed by one thread)."""
    from sparsematrixvectormultiplication_tpu.native.build import (
        load_fast_route,
        run_fast_route,
    )

    lib = nbuild.library_path()
    assert lib.parent.parts[-2:] == ("build", "native")
    jlib = load_fast_route()
    assert jlib is not None, "the JAX package's router did not build"
    for n_rows, seed in ((32, 1), (256, 2)):
        prob = _route_problem(n_rows, seed)
        out = nbuild.run_fast_route(*prob)
        assert lib.exists()
        assert _moves_elements(*prob, out)
        _same(out, run_fast_route(jlib, *prob))


def test_native_router_raises_instead_of_falling_back(monkeypatch, tmp_path):
    prob = _route_problem(8, 3)
    with pytest.raises(RuntimeError, match="pr_route failed with code 2"):
        nbuild.run_fast_route(prob[0][:768], prob[1][:768], prob[2][:768], 6)
    monkeypatch.setattr(nbuild, "_BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", os.fspath(tmp_path / "no-such-compiler"))
    nbuild.load_fast_route.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="cannot be built"):
            ppr.PRMatrix.from_csr(_csrs("random")[0], native=True)
    finally:
        nbuild.load_fast_route.cache_clear()


# ---- host products ----


@pytest.mark.parametrize("name", HOST_CASES)
def test_host_product_matches_jax(name):
    """PRMatrix / PanelPRMatrix with the Python router (native=False) is
    array-equal to the JAX package's product, and so is the port's native
    product."""
    _same(_port_pr(name), _jax_pr(name))
    _same(_port_pr(name, native=True), _jax_pr(name))


def test_pr_from_csr_matches_jax():
    csr, jcsr = _csrs("random")
    _same(ppr.pr_from_csr(csr), jpr.pr_from_csr(jcsr))
    big = ppr.pr_from_csr(*_csrs("panels")[:1], target_rows=512)
    assert isinstance(big, ppr.PanelPRMatrix)
    _same(big, jpr.pr_from_csr(_csrs("panels")[1], target_rows=512))
    assert ppr.max_pr_rows(1_000_000) == jpr.max_pr_rows(1_000_000) == 1 << 14


# ---- the composed route ----


@pytest.mark.parametrize("name", ["powerlaw", "panels"])
def test_route_is_the_stages_on_an_iota(name):
    pr = _port_pr(name)
    d = P.device_put_pr(pr, device="cpu")
    for host, dev in zip(getattr(pr, "panels", (pr,)),
                         getattr(d, "panels", (d,))):
        iota = np.arange(host.n_rows * 128).reshape(host.n_rows, 128)
        bits = np.stack([(host.masks >> s) & 1
                         for s in range(host.n_stages)])
        # each lane is its own Beneš network
        routed = np.stack([proute.apply_benes(iota[:, l], bits[:, :, l])
                           for l in range(128)], axis=1)
        want = np.take_along_axis(routed, host.final_lane.astype(np.int64),
                                  axis=1)
        assert dev.route.dtype == torch.int32
        assert np.array_equal(dev.route.numpy(), want)


# ---- SpMV against the JAX kernels in interpret mode ----


@pytest.mark.parametrize("name", sorted(CASES))
def test_pr_spmv_plain_matches_jax_interpret(name):
    pr = _jax_pr(name)
    csr = _csrs(name)[0]
    x = _x(csr.ncols)
    y_jax = np.asarray(pr_spmv_pallas(jax_device_put_pr(pr),
                                      jax_device_put_x(x, csr.ncols),
                                      interpret=True), np.float64)
    d = P.device_put_pr(pr, device="cpu")  # the JAX host product
    before = P.pr_problem.launches
    y = P.pr_spmv_plain(d, device_put_x(x, csr.ncols, device="cpu"))
    assert P.pr_problem.launches == before
    y = y.numpy().astype(np.float64)
    assert y.shape == y_jax.shape
    assert _rel(y, y_jax) < F32_REL
    assert _rel(pr.unpermute(y), csr.spmv(x)) < F32_REL
    # the wrapper takes the plain version on CPU tensors
    xt = device_put_x(x, csr.ncols, device="cpu")
    y_w = P.pr_spmv(d, xt).numpy()
    assert np.array_equal(y_w, y.astype(np.float32))
    if not hasattr(d, "panels"):  # crop=False: all y_rows*128 outputs
        full = P.pr_spmv(d, xt, crop=False)
        assert full.numel() == d.y_rows * 128
        assert np.array_equal(full[: d.nrows].numpy(), y_w)


@pytest.mark.parametrize("name", ["powerlaw", "panels"])
def test_pr_spmv_dd_plain_matches_jax_interpret(name):
    pr = _jax_pr(name)
    csr = _csrs(name)[0]
    x = _x(csr.ncols, seed=8)
    xh = np.asarray(x, np.float32)
    xl = np.asarray(x - xh.astype(np.float64), np.float32)
    yh, yl = pr_spmv_pallas_dd(jax_device_put_pr_dd(pr),
                               jax_device_put_x(xh, csr.ncols),
                               jax_device_put_x(xl, csr.ncols),
                               interpret=True)
    y_jax = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    d = PD.device_put_pr_dd(_port_pr(name), device="cpu")
    y = combine_f64(*PD.pr_spmv_dd_plain(
        d, *device_put_x_dd(x, csr.ncols, device="cpu"))).numpy()
    ref = csr.spmv(x)
    assert _rel(y, y_jax) < DD_REL
    assert _rel(pr.unpermute(y), ref) < DD_REL
    assert np.abs(pr.unpermute(y) - ref).max() < 1e-13 * np.abs(ref).max()


def test_pr_dd_sums_where_f32_cancels():
    """Rows that cancel to ~1e-7 of their terms: the plain dd version keeps
    the fp64 oracle where f32 loses it."""
    coo, x = syn.cancelling_pairs(2048, seed=0)
    csr = CSRMatrix.from_coo(coo)
    pr = ppr.pr_from_csr(csr)
    ref = csr.spmv(x)
    y = combine_f64(*PD.pr_spmv_dd(PD.device_put_pr_dd(pr, device="cpu"),
                                   *device_put_x_dd(x, csr.ncols,
                                                    device="cpu"))).numpy()
    y32 = P.pr_spmv(P.device_put_pr(pr, device="cpu"),
                    device_put_x(x, csr.ncols, device="cpu")).numpy()
    scale = np.abs(ref).max()
    assert np.abs(pr.unpermute(y) - ref).max() < 1e-12 * scale
    assert np.abs(pr.unpermute(y32.astype(np.float64)) - ref).max() \
        >= 1e-6 * scale


def test_upload_accepts_either_package_and_checks_x():
    d_port = P.device_put_pr(_port_pr("road"), device="cpu")
    d_jax = P.device_put_pr(_jax_pr("road"), device="cpu")
    for f in ("md", "row_slab", "route", "val", "bin_table"):
        assert torch.equal(getattr(d_port, f), getattr(d_jax, f)), f
    for f in ("masks", "final_lane"):  # host arrays, read by the plain path
        assert isinstance(getattr(d_port, f), np.ndarray), f
        assert np.array_equal(getattr(d_port, f), getattr(d_jax, f)), f
    assert d_port.bins == d_jax.bins
    ncols = _csrs("road")[0].ncols
    with pytest.raises(ValueError, match="padded f32 table"):
        P.pr_spmv(d_port, torch.zeros(ncols))
    with pytest.raises(TypeError, match="pr_spmv_dd"):
        P.pr_spmv(PD.device_put_pr_dd(_port_pr("road"), device="cpu"),
                  device_put_x(np.ones(ncols), ncols, device="cpu"))
    with pytest.raises(ValueError, match="float32"):
        P.device_put_pr(_port_pr("road"), torch.bfloat16, device="cpu")


@pytest.mark.parametrize("stages", [("pr", "pr_dd"), ("pr_dd",)])
def test_run_matrix_pr_stages_on_cpu(stages):
    """dense_rows_mix has heavy rows: the PR y goes back to rows through
    seg_map[pr.row_perm] and an fp64 bincount. pr_dd reuses the pr stage's
    conversion, or converts on its own."""
    coo = syn.dense_rows_mix(1200, seed=9)
    res = run_matrix("pr", coo, BenchConfig(iterations=1, skip=0,
                                            stages=stages),
                     x=_x(coo.ncols), log=lambda m: None, device="cpu")
    assert tuple(res.stages) == ("serial_csr", *stages)
    assert res.format_stats["heavy_row_segments"] > 0
    assert (res.pr is not None) == ("pr" in stages) and res.sell is None
    for stage in stages:
        assert res.stages[stage].diff.significant_diffs == 0, stage
    assert res.stages["pr_dd"].norm_err < 1e-13


def test_run_matrix_rejects_unknown_stage():
    with pytest.raises(ValueError, match="unknown stages"):
        run_matrix("x", syn.banded(512, 4, 16), BenchConfig(stages=("hll",)),
                   log=lambda m: None, device="cpu")


def test_far_tile_case_reaches_the_per_row_class():
    """The far-tile case reaches the TPU kernel's per-row read class, and
    both packages read it into the same CSR."""
    assert (_jax_pr("far_tiles").tile_far == 2).any()
    coo = _far_tile_coo()
    j = JCOO(coo.nrows, coo.ncols, coo.row, coo.col, coo.val)
    _same(_csrs("far_tiles")[1], JCSR.from_coo(j))
