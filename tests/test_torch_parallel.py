"""The port's multi-device layer against the JAX package's ``parallel/``, on
the CPU.

Host arrays are held ``np.array_equal`` to the JAX package's: the
partitions of ``balanced_partition``; ``shard_ell_2d``'s re-layout; each
shard of ``build_spmd_sell``, ``shard_bsr``, ``build_spmd_pr``,
``build_spmd_split`` and ``build_spmd_sell_cols`` against the real part of
the JAX ``stacked`` arrays. The y of every sharded path is held against the
JAX path's (Pallas paths in interpret mode on conftest's 8 virtual CPU
devices): f32 paths within ``1e-5 * max|y_jax|``, the fp64 ELL paths at
``rtol = atol = 1e-11``. The port's side runs once per file, on 4 gloo CPU
ranks (``parallel/launch.py:spawn``, plain versions), each rank running
every path and handing back its y; every rank must return the same global
y. The JAX ``shard_sell_rows`` with ``sigma_sort`` misses ``A @ x``; the
port refuses it. Inputs come from seeded generators.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sparsematrixvectormultiplication_tpu.formats.bsr import (
    BSRMatrix as JBSR)
from sparsematrixvectormultiplication_tpu.formats.csr import (
    CSRMatrix as JCSR)
from sparsematrixvectormultiplication_tpu.formats.hll import (
    HLLMatrix as JHLL)
from sparsematrixvectormultiplication_tpu.parallel import multidevice as jmd
from sparsematrixvectormultiplication_tpu.parallel import scheduler as jsched
from sparsematrixvectormultiplication_tpu.parallel import sharding as jsh
from sparsematrixvectormultiplication_tpu.parallel import spmd_bsr as jbsr
from sparsematrixvectormultiplication_tpu.parallel import spmd_colsell as jcol
from sparsematrixvectormultiplication_tpu.parallel import spmd_pallas as jsp
from sparsematrixvectormultiplication_tpu.parallel import spmd_pr as jpr
from sparsematrixvectormultiplication_tpu.parallel import spmd_split as jspl
from sparsematrixvectormultiplication_tpu_torch.bench.scale import (
    ShardJob, for_rank, run_shard_jobs, shard_loads)
from sparsematrixvectormultiplication_tpu_torch.formats.bsr import BSRMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.hll import HLLMatrix
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.parallel import (
    launch, multidevice, scheduler, sharding, spmd_bsr, spmd_colsell,
    spmd_pallas, spmd_pr, spmd_split)

N = 4         # ranks and shards
F32 = 1e-5    # f32 paths: max|y - y_jax| <= F32 * max|y_jax|
F64 = 1e-11   # fp64 ELL paths: rtol = atol


def _jcsr(csr):
    return JCSR(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx, csr.values)


def _csr(coo):
    return CSRMatrix.from_coo(coo)


def _mesh(n, names=("rows",), shape=None):
    return jsh.make_mesh(n, names, shape=shape)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# matrices, and the JAX side of every comparison
# ---------------------------------------------------------------------------


def _cases():
    band = _csr(syn.banded(4096, 9, 300, seed=1))
    road = _csr(syn.road_network(8192, seed=2)).split_heavy_rows(1024)[0]
    cols = _csr(syn.banded(4096, 5, 120, seed=9))
    bsr_csr = _csr(syn.banded(2100, 9, 30, seed=6))  # 17 block-rows
    s = _rng(3)
    dense = np.where(s.random((3000, 2600)) < 0.01, s.standard_normal(
        (3000, 2600)), 0.0)
    r, c = np.nonzero(dense)
    ell = CSRMatrix.from_coo(COOMatrix(3000, 2600, r.astype(np.int32),
                                           c.astype(np.int32), dense[r, c]))
    # sg bins and add_into k-major bins of the far remainder
    scattered = _csr(syn.random_general(20000, 20000, 2.5e-4, seed=8))
    return dict(band=band, road=road, cols=cols, bsr=bsr_csr, ell=ell,
                scattered=scattered)


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Every path, built on the host, run once on N gloo CPU ranks; per
    path the N ranks' y and the jobs' records, and the host builds."""
    band, road, cols = cases["band"], cases["road"], cases["cols"]
    x = _rng(0).standard_normal(band.ncols)
    X = _rng(1).standard_normal((band.ncols, 4))
    Xb = _rng(8).standard_normal((cases["bsr"].ncols, 9)).astype(np.float32)
    xr = _rng(2).standard_normal(road.ncols)
    xc = _rng(4).standard_normal(cols.ncols)
    xe = _rng(5).standard_normal(cases["ell"].ncols)
    hll = HLLMatrix.from_csr(cases["ell"])
    builds = {
        "sell": (spmd_pallas.build_spmd_sell(band, N), x),
        "sell_sg": (spmd_pallas.build_spmd_sell(cases["scattered"], N),
                    _rng(9).standard_normal(cases["scattered"].ncols)),
        "sell_spmm": (spmd_pallas.build_spmd_sell(
            band, N, sell_kwargs={"layout": "k-major"}), X),
        "bsr": (spmd_bsr.shard_bsr(BSRMatrix.from_csr(cases["bsr"]), N), Xb),
        "pr": (spmd_pr.build_spmd_pr(road, N, target_rows=1 << 12), xr),
        "split": (spmd_split.build_spmd_split(road, N), xr),
        "sell_cols": (spmd_colsell.build_spmd_sell_cols(cols, N), xc),
        "ell_rows": (hll, xe),
        "ell_2d": (hll, xe),
        "ell_cols": (hll, xe),
    }
    paths = {"sell_sg": "sell"}
    meshes = {"sell_cols": ((N,), ("cols",)), "ell_cols": ((N,), ("cols",)),
              "ell_2d": ((2, 2), ("rows", "cols"))}
    names = list(builds)

    def jobs(r):
        return [ShardJob(paths.get(p, p), for_rank(builds[p][0], r),
                         builds[p][1],
                         *meshes.get(p, ((N,), ("rows",))),
                         check_plain=p == "sell",
                         reps=2 if p == "sell" else 0, detail=p == "sell")
                for p in names]

    out = launch.spawn(run_shard_jobs, N, device_type="cpu",
                       rank_args=[(jobs(r),) for r in range(N)],
                       timeout_s=300,
                       store_dir=str(tmp_path_factory.mktemp("store")))
    return {p: ([o[j] for o in out], builds[p]) for j, p in enumerate(names)}


def _same_on_every_rank(recs):
    for rec in recs[1:]:
        assert np.array_equal(rec["y"], recs[0]["y"])
    return recs[0]["y"].astype(np.float64)


def _near(y, y_jax, tol=F32):
    y_jax = np.asarray(y_jax, np.float64)
    assert y.shape == y_jax.shape
    assert np.abs(y - y_jax).max() <= tol * np.abs(y_jax).max()


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


def _skewed():
    w = np.ones(100, dtype=np.int64)
    w[10] = 1000
    return w


@pytest.mark.parametrize("weights,parts", [
    (np.ones(100, np.int64), 4), (_skewed(), 8),
    (np.array([5, 3, 2], np.int64), 10), (np.zeros(0, np.int64), 4),
    (np.ones(10, np.int64), 2)])
def test_balanced_partition_equals_jax(weights, parts):
    p, q = (m.balanced_partition(weights, parts) for m in (scheduler, jsched))
    for f in ("starts", "ends", "loads"):
        assert np.array_equal(getattr(p, f), getattr(q, f)), f
    assert p.imbalance == q.imbalance
    assert scheduler.partition_report(p, "rows") == \
        jsched.partition_report(q, "rows")


def test_balanced_partition_sweep_equals_jax():
    rng = _rng(11)
    for _ in range(200):
        n = int(rng.integers(0, 60))
        w = rng.integers(0, 50, n) * (rng.random(n) < 0.8)
        if rng.random() < 0.3 and n:
            w[int(rng.integers(0, n))] = int(rng.integers(100, 5000))
        parts = int(rng.integers(1, 12))
        compact = bool(rng.random() < 0.8)
        p = scheduler.balanced_partition(w, parts, compact=compact)
        q = jsched.balanced_partition(w, parts, compact=compact)
        for f in ("starts", "ends", "loads"):
            assert np.array_equal(getattr(p, f), getattr(q, f)), (w, parts)


# ---------------------------------------------------------------------------
# host arrays against the JAX stacked arrays
# ---------------------------------------------------------------------------


def test_ell_2d_relayout_equals_jax(cases):
    csr = cases["ell"]
    for shape in ((4, 2), (2, 4), (1, 8)):
        j = jsh.shard_ell_2d(JHLL.from_csr(_jcsr(csr)),
                             _mesh(8, ("rows", "cols"), shape))
        ja2, as2, rp, cp = sharding._relayout_2d(HLLMatrix.from_csr(csr),
                                                 *shape)
        assert np.array_equal(ja2, np.asarray(j.ja)), shape
        assert np.array_equal(as2, np.asarray(j.as_)), shape
        assert (rp, cp) == (j.rows_padded, j.cols_padded)


def _sell_shards_equal(port, jax_spmd):
    """Each shard's bins equal the real part of the JAX stacked bins."""
    st = jax_spmd.stacked
    trash = st.num_groups - 1
    assert np.array_equal(port.shard_rows, jax_spmd.shard_rows)
    assert port.local_rows == jax_spmd.local_rows
    if port.group_bounds is not None and jax_spmd.group_bounds is not None:
        assert np.array_equal(port.group_bounds, jax_spmd.group_bounds)
    for i, shard in enumerate(port.shards):
        want = []
        for jb in st.bins:
            gid = np.asarray(jb.group_ids[i])
            n = int((gid != trash).sum())
            if n:
                want.append((jb, n))
        assert len(shard.bins) == len(want), i
        for b, (jb, n) in zip(shard.bins, want):
            kb = int(jb.k) * 8
            assert (b.layout, int(b.k), int(b.span)) == (
                jb.layout, int(jb.k), int(jb.span))
            assert bool(b.add_into) == bool(jb.add_into)
            assert np.array_equal(b.group_ids, np.asarray(jb.group_ids[i, :n]))
            assert np.array_equal(b.ja, np.asarray(jb.ja[i, :n * kb]))
            assert np.array_equal(b.as_, np.asarray(jb.as_[i, :n * kb]))
            sl = np.asarray(jb.slab_list[i, :n])
            w = b.slab_list.shape[1]
            assert np.array_equal(b.slab_list, sl[:, :w])
            assert not sl[:, w:].any()
            assert np.array_equal(b.slab_count,
                                  np.asarray(jb.slab_count[i, :n]))


@pytest.mark.parametrize("case,kwargs", [
    ("band", {}), ("band", {"layout": "k-major"}), ("band", {"layout": "wl"}),
    ("road", {"layout": "sb-list"}), ("dense_rows", {}),
    ("scattered", {"layout": "sg"})])
def test_build_spmd_sell_shards_equal_jax(cases, case, kwargs):
    if case == "dense_rows":
        csr = _csr(syn.dense_rows_mix(9000, seed=3))
    elif case == "scattered":
        csr = cases["scattered"]
    else:
        csr = cases[case]
    port = spmd_pallas.build_spmd_sell(csr, N, sell_kwargs=kwargs)
    theirs = jsp.build_spmd_sell(_jcsr(csr), N, dtype=jnp.float64,
                                 sell_kwargs=kwargs)
    _sell_shards_equal(port, theirs)
    assert sum(s.nnz for s in port.shards) == csr.nnz
    if case == "scattered":
        assert any(b.add_into for s in port.shards for b in s.bins)


def test_more_shards_than_groups_pad_with_empty_shards():
    csr = _csr(syn.banded(2500, 5, 40, seed=2))  # 3 groups
    port = spmd_pallas.build_spmd_sell(csr, N)
    _sell_shards_equal(port, jsp.build_spmd_sell(_jcsr(csr), N,
                                                 dtype=jnp.float64))
    assert port.shards[-1].bins == [] and port.shard_rows[-1] == 0


def test_shard_bsr_equals_jax(cases):
    csr = cases["bsr"]
    port = spmd_bsr.shard_bsr(BSRMatrix.from_csr(csr), N)
    theirs = jbsr.shard_bsr(JBSR.from_csr(_jcsr(csr)), N)
    assert np.array_equal(port.shard_rows, theirs.shard_rows)
    assert port.local_rows == theirs.local_rows
    for i, s in enumerate(port.shards):
        assert np.array_equal(s.blocks.astype(np.float32),
                              np.asarray(theirs.stacked.blocks[i]))
        assert np.array_equal(s.block_cols,
                              np.asarray(theirs.stacked.block_cols[i]))
        assert s.n_block_rows * s.kb == s.blocks.shape[0]
    assert sum(shard_loads(port)) == csr.nnz


def _pr_panels_equal(panels, stacked, lead):
    """Each host panel's planes equal JAX's stacked leaves at ``lead(c)``."""
    for c, p in enumerate(panels):
        for f in ("val", "md", "masks", "final_lane", "tile_base",
                  "tile_far", "row_slab"):
            assert np.array_equal(np.asarray(getattr(p, f)),
                                  np.asarray(getattr(stacked, f))[lead(c)]), \
                (c, f)
        assert tuple(tuple(b) for b in p.bins) == tuple(
            tuple(b) for b in stacked.bins)


def test_build_spmd_pr_equals_jax(cases):
    csr = cases["road"]
    port = spmd_pr.build_spmd_pr(csr, N, target_rows=1 << 12)
    theirs = jpr.build_spmd_pr(_jcsr(csr), N, target_rows=1 << 12,
                               dtype=jnp.float64)
    assert (port.pps, port.y_len) == (theirs.pps, theirs.y_len)
    for a, b in zip(port.chunk_rows, theirs.chunk_rows):
        assert np.array_equal(a, b)
    for a, b in zip(port.y_pos, theirs.y_pos):
        assert np.array_equal(a, b)
    _pr_panels_equal(port.panels, theirs.stacked,
                     lambda c: (c // port.pps, c % port.pps))


def test_build_spmd_pr_grows_panels_per_shard():
    csr = _csr(syn.random_general(9000, 9000, 2e-3, seed=15))
    port = spmd_pr.build_spmd_pr(csr, 2, target_rows=1 << 10)
    theirs = jpr.build_spmd_pr(_jcsr(csr), 2, target_rows=1 << 10)
    assert port.pps == theirs.pps > 1
    assert port.panels[0].n_rows <= 1 << 10
    with pytest.raises(ValueError, match="union-ladder floor"):
        spmd_pr.build_spmd_pr(csr, 2, target_rows=1 << 7)


def test_build_spmd_split_equals_jax(cases):
    csr = cases["road"]
    port = spmd_split.build_spmd_split(csr, N)
    theirs = jspl.build_spmd_split(_jcsr(csr), N, dtype=jnp.float64)
    _sell_shards_equal(port.near, theirs.near)
    _pr_panels_equal(port.far, theirs.far, lambda c: c)


def test_build_spmd_split_refuses_empty_shards(cases):
    csr = cases["road"]  # 8 groups over 16 shards
    for build in (spmd_split.build_spmd_split, jspl.build_spmd_split):
        with pytest.raises(ValueError, match="non-empty"):
            build(csr if build is spmd_split.build_spmd_split
                  else _jcsr(csr), 16)


def test_build_spmd_sell_cols_equals_jax(cases):
    csr = cases["cols"]
    port = spmd_colsell.build_spmd_sell_cols(csr, N)
    theirs = jcol.build_spmd_sell_cols(_jcsr(csr), N, dtype=jnp.float64)
    assert (port.cols_per, port.r_loc) == (theirs.cols_per, theirs.r_loc)
    st = theirs.stacked
    trash = st.num_groups - 1
    for i, shard in enumerate(port.shards):
        want = [(jb, int((np.asarray(jb.group_ids[i]) != trash).sum()))
                for jb in st.bins]
        want = [(jb, n) for jb, n in want if n]
        assert [int(b.k) for b in shard.bins] == [int(jb.k) for jb, _ in want]
        for b, (jb, n) in zip(shard.bins, want):
            kb = int(jb.k) * 8
            assert b.layout == "k-major"
            assert np.array_equal(b.group_ids, np.asarray(jb.group_ids[i, :n]))
            assert np.array_equal(b.ja, np.asarray(jb.ja[i, :n * kb]))
            assert np.array_equal(b.as_, np.asarray(jb.as_[i, :n * kb]))
            assert np.array_equal(b.slab_count,
                                  np.asarray(jb.slab_count[i, :n]))


# ---------------------------------------------------------------------------
# y over 4 gloo CPU ranks against the JAX paths
# ---------------------------------------------------------------------------


def test_row_sharded_sell_matches_jax(ranks, cases):
    recs, (spmd, x) = ranks["sell"]
    csr = cases["band"]
    mesh = _mesh(N)
    y_jax = jsp.sell_spmv_spmd(jsp.build_spmd_sell(_jcsr(csr), N, mesh=mesh),
                               jnp.asarray(x, jnp.float32), mesh,
                               interpret=True)
    _near(_same_on_every_rank(recs), y_jax)
    # every rank's kernels (here their plain versions) against the plain
    # assembly, and the timings taken
    for rec in recs:
        assert rec["plain_max_abs_err"] == 0.0
        assert rec["local_s"] > 0 and rec["collective_s"] > 0
        assert rec["call_s"] > 0 and rec["wall_s"] > 0 and rec["bytes"] > 0


def test_row_sharded_sg_with_add_into_bins_matches_jax(ranks, cases):
    recs, (spmd, x) = ranks["sell_sg"]
    csr = cases["scattered"]
    assert {b.layout for s in spmd.shards if s for b in s.bins} == {
        "sg", "k-major"}
    mesh = _mesh(N)
    y_jax = jsp.sell_spmv_spmd(jsp.build_spmd_sell(_jcsr(csr), N, mesh=mesh),
                               jnp.asarray(x, jnp.float32), mesh,
                               interpret=True)
    _near(_same_on_every_rank(recs), y_jax)


def test_row_sharded_sell_spmm_matches_jax(ranks, cases):
    recs, (spmd, X) = ranks["sell_spmm"]
    csr = cases["band"]
    mesh = _mesh(N)
    Y_jax = jsp.sell_spmm_spmd(
        jsp.build_spmd_sell(_jcsr(csr), N, mesh=mesh,
                            sell_kwargs={"layout": "k-major"}),
        jnp.asarray(X, jnp.float32), mesh, interpret=True)
    Y = _same_on_every_rank(recs)
    Y_jax = np.asarray(Y_jax, np.float64)
    for j in range(X.shape[1]):
        _near(Y[:, j], Y_jax[:, j])


def test_bsr_spmm_matches_jax(ranks, cases):
    recs, (spmd, X) = ranks["bsr"]
    csr = cases["bsr"]
    mesh = _mesh(N)
    Y_jax = np.asarray(jbsr.bsr_spmm_spmd(
        jbsr.shard_bsr(JBSR.from_csr(_jcsr(csr)), N, mesh=mesh), X, mesh,
        interpret=True), np.float64)
    Y = _same_on_every_rank(recs)
    assert Y.shape == (csr.nrows, X.shape[1])
    for j in range(X.shape[1]):
        _near(Y[:, j], Y_jax[:, j])


def test_pr_matches_jax(ranks, cases):
    recs, (spmd, x) = ranks["pr"]
    csr = cases["road"]
    mesh = _mesh(N)
    y_jax = jpr.pr_spmv_spmd(jpr.build_spmd_pr(_jcsr(csr), N, mesh=mesh,
                                               target_rows=1 << 12),
                             x, mesh, interpret=True)
    _near(_same_on_every_rank(recs), y_jax)


def test_split_matches_jax(ranks, cases):
    recs, (spmd, x) = ranks["split"]
    csr = cases["road"]
    mesh = _mesh(N)
    y_jax = jspl.split_spmv_spmd(jspl.build_spmd_split(_jcsr(csr), N,
                                                       mesh=mesh),
                                 x, mesh, interpret=True)
    _near(_same_on_every_rank(recs), y_jax)


def test_col_sharded_sell_matches_jax(ranks, cases):
    recs, (spmd, x) = ranks["sell_cols"]
    csr = cases["cols"]
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(N), ("cols",))
    y_jax = jcol.sell_spmv_spmd_cols(
        jcol.build_spmd_sell_cols(_jcsr(csr), N, mesh=mesh), x, mesh,
        interpret=True)
    _near(_same_on_every_rank(recs), y_jax)


@pytest.mark.parametrize("path", ["ell_rows", "ell_2d", "ell_cols"])
def test_ell_paths_match_jax_in_fp64(ranks, cases, path):
    recs, (hll, x) = ranks[path]
    jhll = JHLL.from_csr(_jcsr(cases["ell"]))
    if path == "ell_rows":
        mesh = _mesh(N)
        y_jax = jsh.row_sharded_spmv(jsh.shard_ell_rows(jhll, mesh),
                                     jnp.asarray(x), mesh)
    elif path == "ell_2d":
        mesh = _mesh(N, ("rows", "cols"), (2, 2))
        y_jax = jsh.sharded_spmv_2d(jsh.shard_ell_2d(jhll, mesh),
                                    jnp.asarray(x), mesh)
    else:
        y_jax = jsh.col_sharded_spmv(jhll, jnp.asarray(x), _mesh(N, ("cols",)))
    y = _same_on_every_rank(recs)
    np.testing.assert_allclose(y, np.asarray(y_jax), rtol=F64, atol=F64)
    np.testing.assert_allclose(y, cases["ell"].spmv(x), rtol=F64, atol=F64)


# ---------------------------------------------------------------------------
# one process, several devices: multidevice.py
# ---------------------------------------------------------------------------


def test_multidevice_matches_jax(cases):
    csr = cases["band"]
    x = _rng(6).standard_normal(csr.ncols)
    md = multidevice.shard_sell_rows(csr, [torch.device("cpu")] * N)
    jmd_ = jmd.shard_sell_rows(_jcsr(csr), jax.devices()[:N],
                               dtype=jnp.float32)
    assert np.array_equal(md.row_starts, jmd_.row_starts)
    assert md.num_shards == jmd_.num_shards == N
    y = md.spmv(x)
    assert y.device == torch.device("cpu") and y.dtype == torch.float32
    _near(y.numpy().astype(np.float64), jmd_.spmv(x, interpret=True))


def test_multidevice_balances_nnz_as_jax():
    csr = _csr(syn.dense_rows_mix(20000, seed=3))
    md = multidevice.shard_sell_rows(csr, [torch.device("cpu")] * 8)
    theirs = jmd.shard_sell_rows(_jcsr(csr), jax.devices(),
                                 dtype=jnp.float64)
    assert np.array_equal(md.row_starts, theirs.row_starts)
    nnzs = [d.nnz for _, d in md.shards]
    assert nnzs == [d.nnz for _, d in theirs.shards]
    assert max(nnzs) < 3 * (sum(nnzs) / len(nnzs))


def test_shard_sell_rows_sigma_sorted_is_refused():
    """The JAX function joins each shard's y in its SELL-sorted row order;
    the port refuses the option (as both packages' build_spmd_sell do)."""
    csr = _csr(syn.random_general(3000, 3000, 0.003, seed=3))
    x = _rng(7).standard_normal(csr.ncols)
    ref = csr.spmv(x)
    bad = jmd.shard_sell_rows(_jcsr(csr), jax.devices()[:2],
                              dtype=jnp.float32,
                              sell_kwargs={"sigma_sort": True})
    err = np.abs(np.asarray(bad.spmv(x, interpret=True), np.float64)
                 - ref).max() / np.abs(ref).max()
    assert err > 0.5  # about 1.1: rows in the wrong places
    good = jmd.shard_sell_rows(_jcsr(csr), jax.devices()[:2],
                               dtype=jnp.float32)
    assert np.abs(np.asarray(good.spmv(x, interpret=True), np.float64)
                  - ref).max() / np.abs(ref).max() < 1e-6
    with pytest.raises(ValueError, match="sigma_sort"):
        multidevice.shard_sell_rows(csr, [torch.device("cpu")] * 2,
                                    sell_kwargs={"sigma_sort": True})
    for build in (spmd_pallas.build_spmd_sell, jsp.build_spmd_sell):
        with pytest.raises(ValueError, match="sigma_sort"):
            build(csr, 2, sell_kwargs={"sigma_sort": True})


def test_multidevice_needs_a_card_or_named_devices(cases):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default devices are GPUs")
    with pytest.raises(RuntimeError, match="devices="):
        multidevice.shard_sell_rows(cases["band"])


# ---------------------------------------------------------------------------
# ranks that fail or hang, and refusals
# ---------------------------------------------------------------------------


def test_a_failing_rank_raises_with_its_traceback(tmp_path):
    bad = ShardJob("no_such_path", None, np.zeros(1), (2,))
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed(.|\n)*"
                       "KeyError: 'no_such_path'"):
        launch.spawn(run_shard_jobs, 2, device_type="cpu", args=([bad],),
                     timeout_s=60, store_dir=str(tmp_path))


def test_a_hung_rank_is_killed(tmp_path, cases):
    # rank 1 runs no job and leaves: rank 0 waits in its mesh's collective
    job = ShardJob("ell_rows", HLLMatrix.from_csr(cases["band"]),
                   np.ones(cases["band"].ncols), (2,))
    with pytest.raises(RuntimeError, match="still ran|failed"):
        launch.spawn(run_shard_jobs, 2, device_type="cpu",
                     rank_args=[([job],), ([],)], timeout_s=8,
                     init_timeout_s=120, store_dir=str(tmp_path))


def test_init_from_env_joins_a_torchrun_group():
    """The environment torchrun sets for a 1-rank world, on localhost."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = ("import torch.distributed as dist\n"
            "from sparsematrixvectormultiplication_tpu_torch.parallel import "
            "launch\n"
            "dev = launch.init_from_env('cpu')\n"
            "print(dev, dist.get_backend(), dist.get_world_size())\n"
            "dist.destroy_process_group()\n")
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["cpu", "gloo", "1"]


def test_value_types_and_uploads_are_checked(cases):
    csr = cases["band"]
    with pytest.raises(ValueError, match="not supported"):
        spmd_pallas.build_spmd_sell(csr, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="upload"):
        spmd_pallas.sell_spmv_spmd(spmd_pallas.build_spmd_sell(csr, 2),
                                   np.ones(csr.ncols), None)
    assert launch.backend_for("cpu", 4) == "gloo"
    assert launch.backend_for("cuda", torch.cuda.device_count() + 1) == "gloo"
