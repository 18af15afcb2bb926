"""The SELL SpMV's launch plan (ops/sell.py), on the CPU.

At upload the bins that share a kernel and every scalar of its launch are
joined into one launch: the joint bin's planes are one allocation, each
member's a view of it, the members' blocks in order of their groups, fewest
first; the core launches store before the ``add_into`` ones add. Each row's
arithmetic is its bin's, so the joined plain versions equal the per-bin
plain runs bit for bit, f32, bf16 and dd. y takes no zero fill where the
core bins write every group; a ``skip_empty`` conversion keeps it, and its
uncovered rows are +0.

Column panels are rebased onto the whole x at upload: every column a bin
reads, pads included, lies inside the one x table, and the plan's slices
added by ``panel_reduce`` equal the panel-by-panel accumulation onto a
zeroed y (each panel uploaded on its own with its own x table, every bin
adding in order) bit for bit, a zero sum's sign included; a group that no
panel holds stays +0. Against the JAX ``sell_spmv_pallas`` and
``sell_spmv_pallas_dd`` in interpret mode the tolerances are the existing
tests': rtol=1e-5, atol=1e-5*max|y| in f32 and 1e-9*max|y| in dd. Inputs
come from seeded generators.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.formats.sell import (
    PanelSellMatrix as JPanel,
)
from sparsematrixvectormultiplication_tpu.formats.sell import (
    SellMatrix as JSell,
)
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops import doubledouble as jdd
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    device_put_sell as jax_device_put_sell,
    sell_spmv_pallas,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_sell_dd import (
    device_put_sell_dd as jax_device_put_sell_dd,
    sell_spmv_pallas_dd,
)
from sparsematrixvectormultiplication_tpu_torch import (
    COOMatrix,
    CSRMatrix,
    PanelSellMatrix,
    SellMatrix,
)
from sparsematrixvectormultiplication_tpu_torch.formats.sell import (
    slab_table_rows,
)
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
    dd_add_dd,
    split_f64,
)

PRECISIONS = ("f32", "bf16", "dd")
PLANES = ("ja", "as_", "as_hi", "as_lo", "as_pair")


def _two_bands():
    """Two bands of 24 entries a row and spans 8 and 20 slabs: two sb-major
    bins of one K, which join."""
    a = syn.banded(3072, 24, 300, seed=1)
    b = syn.banded(5120, 24, 1500, seed=2)
    return COOMatrix(8192, 8192, np.concatenate([a.row, b.row + 3072]),
                     np.concatenate([a.col, b.col + 3072]),
                     np.concatenate([a.val, b.val]))


# case -> (generator, SellMatrix.from_csr keywords, layouts)
CASES = {
    "fem": (lambda: syn.fem_3d(20, 20, 20, dof=3, seed=1), {},
            {"k-major", "wl"}),
    "banded": (_two_bands, {"layout": "sb-major", "merge_bins": False},
               {"sb-major"}),
    "road": (lambda: syn.road_network(20_000, seed=5),
             {"layout": "sb-list", "merge_bins": False}, {"sb-list"}),
    "uniform": (lambda: syn.random_general(30_000, 30_000, 2.5e-4, seed=3),
                {}, {"sg", "k-major"}),
}


@functools.cache
def _host(case):
    make, kw, layouts = CASES[case]
    csr = CSRMatrix.from_coo(make())
    sell = SellMatrix.from_csr(csr, **kw)
    assert {b.layout for b in sell.bins} == layouts
    assert len(sell.bins) > 1
    return csr, sell


def _upload(sell, precision, **kw):
    if precision == "dd":
        return D.device_put_sell_dd(sell, device="cpu", **kw)
    return S.device_put_sell(sell, {"f32": torch.float32,
                                    "bf16": torch.bfloat16}[precision],
                             device="cpu", **kw)


def _x(n, seed=7):
    return np.random.default_rng(seed).standard_normal(n)


def _tabs(x, ncols, precision):
    if precision == "dd":
        return D.device_put_x_dd(x, ncols, device="cpu")
    return (S.device_put_x(x, ncols, device="cpu"),)


def _per_bin(d, xs, precision):
    """The reference: every bin's plain version on its own, in bin order,
    the core bins storing and the ``add_into`` ones adding onto a zeroed
    y."""
    ys = [torch.zeros(d.num_groups * 1024) for _ in xs]
    write = D._write_plain_dd if precision == "dd" else S._write_plain
    for b in d.bins:
        write(b, *xs, *ys, b.add_into)
    return [y[: d.nrows] for y in ys]


def _spmv_plain(d, xs, precision):
    if precision == "dd":
        return list(D.sell_spmv_dd_plain(d, *xs))
    return [S.sell_spmv_plain(d, *xs)]


def _planes(b):
    return [getattr(b, f) for f in PLANES if getattr(b, f, None) is not None]


@pytest.mark.parametrize("precision", ["f32", "dd"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_joins_bins_that_share_a_launch(case, precision):
    _, sell = _host(case)
    d = _upload(sell, precision)
    plan = d.plan
    members = [m for j in plan.launches for m in j.members]
    # every bin in exactly one launch
    assert sorted(map(id, members)) == sorted(map(id, d.bins))
    assert len(plan.launches) < len(d.bins) or case == "uniform" \
        and precision == "dd"
    # the core launches first, then the add_into ones
    flags = [j.accumulate for j in plan.launches]
    assert flags == sorted(flags)
    for j in plan.launches:
        assert all(m.add_into == j.accumulate for m in j.members)
        # one kernel, every scalar of the launch shared
        key = S._launch_key(j.bin)
        assert all(S._launch_key(m) == key for m in j.members)
        # blocks: the members' groups in order, fewest first
        sizes = [m.n_groups for m in j.members]
        assert sizes == sorted(sizes) and j.bin.n_groups == sum(sizes)
        assert torch.equal(j.bin.group_ids,
                           torch.cat([m.group_ids for m in j.members]))
        if len(j.members) == 1:
            assert j.bin is j.members[0]
            continue
        # one allocation a plane, each member's a view of it, no plane
        # stored twice
        for whole, *parts in zip(_planes(j.bin),
                                 *(_planes(m) for m in j.members)):
            assert sum(p.nbytes for p in parts) == whole.nbytes
            at = 0
            for p in parts:
                assert p.untyped_storage().data_ptr() == \
                    whole.untyped_storage().data_ptr()
                assert p.data_ptr() == whole.data_ptr() + at
                at += p.nbytes
    assert S.plan_bytes(d) < sum(p.nbytes for b in d.bins
                                 for p in _planes(b)) // 20
    assert plan.covered == d.num_groups
    launches = (S.sell_spmv_launches(d) if precision != "dd"
                else D.sell_spmv_dd_launches(d))
    assert launches == len(plan.launches) + (
        precision == "dd" and any(D._pairs(b) for b in d.bins))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_joint_plain_equals_per_bin_plain(case, precision):
    csr, sell = _host(case)
    d = _upload(sell, precision)
    xs = _tabs(_x(csr.ncols), csr.ncols, precision)
    for got, want in zip(_spmv_plain(d, xs, precision),
                         _per_bin(d, xs, precision)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ["f32", "dd"])
@pytest.mark.parametrize("case", ["banded", "road"])
def test_int16_planes_join(case, precision):
    """sb_i16 planes stay padded: int16 sb-major bins join whatever their
    span (neither decode reads it), int16 sb-list bins only at one span."""
    csr, sell = _host(case)
    d = _upload(sell, precision, sb_i16=True)
    assert all(b.ja.dtype == torch.int16 for b in d.bins)
    spans = {b.span for b in d.bins}
    assert len(d.plan.launches) == (1 if case == "banded" else len(spans))
    xs = _tabs(_x(csr.ncols), csr.ncols, precision)
    for got, want in zip(_spmv_plain(d, xs, precision),
                         _per_bin(d, xs, precision)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ["f32", "dd"])
def test_skip_empty_keeps_the_zero_fill(precision):
    """A conversion that skips an empty group leaves its rows to the zero
    fill: they come back +0, and the launch count holds the fill."""
    coo = syn.banded(4096, 8, 64, seed=3)
    keep = (coo.row < 1024) | (coo.row >= 2048)
    csr = CSRMatrix.from_coo(COOMatrix(4096, 4096, coo.row[keep],
                                       coo.col[keep], coo.val[keep]))
    d = _upload(SellMatrix.from_csr(csr, skip_empty=True), precision)
    assert d.plan.covered == d.num_groups - 1
    xs = _tabs(_x(csr.ncols), csr.ncols, precision)
    ys = _spmv_plain(d, xs, precision)
    for y in ys:
        assert torch.equal(y[1024:2048], torch.zeros(1024))
        assert not torch.signbit(y[1024:2048]).any()
    for got, want in zip(ys, _per_bin(d, xs, precision)):
        assert torch.equal(got, want)
    fills = 2 if precision == "dd" else 1
    count = D.sell_spmv_dd_launches if precision == "dd" \
        else S.sell_spmv_launches
    assert count(d) == len(d.plan.launches) + fills
    full = _upload(SellMatrix.from_csr(csr), precision)
    assert full.plan.covered == full.num_groups
    assert count(full) == len(full.plan.launches)


def _sequential(parts, cover, n, dd=False):
    """The panel-by-panel accumulation: a zeroed y, each slice in order
    added onto its covered groups' rows as the kernels' accumulating store
    adds a bin's sums (y + sum; dd: dd_add_dd(y, sum))."""
    slices, ng = cover.shape
    ys = [torch.zeros(ng * 1024) for _ in parts]
    for s in range(slices):
        for g in range(ng):
            if cover[s, g]:
                rows = slice(g * 1024, (g + 1) * 1024)
                got = [p[s * n:(s + 1) * n][rows] for p in parts]
                if dd:
                    ys[0][rows], ys[1][rows] = dd_add_dd(
                        ys[0][rows], ys[1][rows], *got)
                else:
                    ys[0][rows] = ys[0][rows] + got[0]
    return ys


def test_panel_reduce_equals_the_sequential_accumulation():
    """Slices with -0 sums, NaN where no bin writes, and a group that no
    slice covers: y equals the sequential accumulation bit for bit, the
    -0 sums and the uncovered group +0."""
    rng = np.random.default_rng(11)
    slices, ng = 4, 3
    n = ng * 1024
    cover = torch.from_numpy(rng.integers(0, 2, (slices, ng))
                             .astype(np.uint8))
    cover[:, 2] = 0
    cover[0, :2] = 1
    parts = [torch.from_numpy(rng.standard_normal(slices * n)
                              .astype(np.float32)) for _ in range(2)]
    parts[1] *= 2.0**-30
    for p in parts:
        v = p.view(slices, ng, 1024)
        v[~cover.bool()] = float("nan")
        v[:, 0, :16] = -0.0  # -0 sums, covered in slice 0
    (want,) = _sequential(parts[:1], cover, n)
    got = S.panel_reduce_plain(parts[0], cover)
    assert torch.equal(got, want)
    assert not torch.signbit(got[:16]).any()
    assert torch.equal(got[2048:], torch.zeros(1024))
    y = torch.full((n,), float("nan"))
    S.panel_reduce(parts[0], cover, y)  # the CPU wrapper: the plain version
    assert torch.equal(y, want)
    want_dd = _sequential(parts, cover, n, dd=True)
    for got, want in zip(D.panel_reduce_plain_dd(*parts, cover), want_dd):
        assert torch.equal(got, want)
        assert not torch.signbit(got[:16]).any()


@functools.cache
def _panel_host(width):
    """fem_3d(10, 10, 10) in ``width``-column panels, 4096 rows (the last
    group empty in every panel); at width 384 cut to 2900 columns, so that
    the last panels' spare slabs lie past the flat x table's."""
    coo = syn.fem_3d(10, 10, 10, dof=3, seed=0)
    ncols = 3000 if width == 1024 else 2900
    keep = coo.col < ncols
    csr = CSRMatrix.from_coo(COOMatrix(4096, ncols, coo.row[keep],
                                       coo.col[keep], coo.val[keep]))
    return csr, PanelSellMatrix.from_csr(csr, max_panel_cols=width)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("width", [1024, 384])
def test_panels_equal_the_sequential_accumulation(width, precision):
    csr, psell = _panel_host(width)
    dps = _upload(psell, precision)
    assert len(psell.panels) >= 3
    if width == 384:
        assert dps.x_rows > slab_table_rows(csr.ncols) * 128
    # every column a rebased bin reads, pads included, inside the x table
    for p in dps.panels:
        for b in p.bins:
            _, cols, keep, _ = S._SLOTS[b.layout](b)
            if keep is not None:
                cols = cols[keep.expand_as(cols)]
            assert 0 <= int(cols.min()) and int(cols.max()) < dps.x_rows
    x = _x(csr.ncols, seed=9)
    if precision == "dd":
        halves = [torch.from_numpy(h) for h in split_f64(x)]
        got = D.panel_sell_spmv_dd_plain(dps, *halves)
        kern = D.panel_sell_spmv_dd(dps, *halves)
    else:
        halves = [torch.from_numpy(x.astype(np.float32))]
        got = (S.panel_sell_spmv_plain(dps, halves[0]),)
        kern = (S.panel_sell_spmv(dps, halves[0]),)
    # the reference: each panel uploaded on its own, its own x table, every
    # bin adding onto one zeroed y in order
    ys = [torch.zeros(dps.num_groups * 1024) for _ in halves]
    for p, panel in enumerate(psell.panels):
        c0, c1 = psell.bounds[p], psell.bounds[p + 1]
        d = _upload(panel, precision)
        tabs = [S.pack_x_table(h[c0:c1], c1 - c0) for h in halves]
        write = D._write_plain_dd if precision == "dd" else S._write_plain
        for b in d.bins:
            write(b, *tabs, *ys, True)
    assert not any(3 in b.group_ids.tolist() for p in dps.panels
                   for b in p.bins)
    for g, k, want in zip(got, kern, ys):
        assert torch.equal(g, want[: csr.nrows])
        assert torch.equal(k, want[: csr.nrows])
        assert torch.equal(g[3072:], torch.zeros(1024))
        assert not torch.signbit(g[3072:]).any()


@pytest.mark.parametrize("panels", [False, True], ids=["flat", "panels"])
def test_matches_pallas_interpret(panels):
    """fem_3d(10, 10, 10) forced to k-major (the JAX wl kernel takes minutes
    to run in interpret mode), flat and in 1536-column panels (two k-major
    bins of 2 groups, one joint launch), f32 and dd, against the JAX
    kernels in interpret mode."""
    jcsr = JCSR.from_coo(jsyn.fem_3d(10, 10, 10, dof=3, seed=0))
    csr = CSRMatrix.from_coo(syn.fem_3d(10, 10, 10, dof=3, seed=0))
    if panels:
        jsell = JPanel.from_csr(jcsr, max_panel_cols=1536, layout="k-major")
        sell = PanelSellMatrix.from_csr(csr, max_panel_cols=1536,
                                        layout="k-major")
    else:
        jsell = JSell.from_csr(jcsr, layout="k-major")
        sell = SellMatrix.from_csr(csr, layout="k-major")
    x = _x(csr.ncols, seed=4)
    x32 = x.astype(np.float32)
    jx = jnp.asarray(x32)
    y_jax = np.asarray(sell_spmv_pallas(
        jax_device_put_sell(jsell), jx if panels else jnp.asarray(
            np.asarray(S.device_put_x(x32, csr.ncols, device="cpu"))),
        interpret=True))[: csr.nrows]
    d = _upload(sell, "f32")
    assert len(d.plan.launches) == 1
    y = (S.panel_sell_spmv(d, torch.from_numpy(x32)) if panels else
         S.sell_spmv(d, S.device_put_x(x32, csr.ncols, device="cpu")))
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=1e-5,
                               atol=1e-5 * np.abs(y_jax).max())
    if panels:
        jh, jl = (jnp.asarray(h) for h in split_f64(x))
    else:
        jh, jl = (jnp.asarray(np.asarray(t)) for t in D.device_put_x_dd(
            x, csr.ncols, device="cpu"))
    y_jdd = np.asarray(jdd.combine_f64(*sell_spmv_pallas_dd(
        jax_device_put_sell_dd(jsell), jh, jl, interpret=True)))[: csr.nrows]
    y_dd = D.sell_spmv_dd_f64(_upload(sell, "dd"),
                              torch.from_numpy(x)).numpy()
    assert np.abs(y_dd - y_jdd).max() <= 1e-9 * np.abs(y_jdd).max()
