"""Synthetic matrix model families — generator + benchmark corpus.

Ports the capability of the reference's Python generator
(src/matrix_generator.py:41-132 ``MTXGenerator.generate_random_sparse_mtx``:
general/symmetric/pattern x real/integer, density-controlled, 1-based sorted
output) and extends it with the structural families of the SuiteSparse sweep
the reference benchmarks against (SURVEY §4.3 matrix list): banded FEM-like
matrices (cant/af_1_k101/Cube_Coup_dt0 class), power-law graphs
(webbase-1M class), road networks (roadNet-PA class), and diagonal-dominant
thermal-style matrices — so the bench suite exercises the same regimes
without network access to SuiteSparse.
"""

# Numpy host layer copied from
# sparsematrixvectormultiplication_tpu/models/synthetic.py, with the field
# SuiteEntry.make named for what it holds (the port must not import the JAX
# package); tests/test_torch_formats.py holds the two array-equal.

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..formats.coo import COOMatrix

__all__ = [
    "random_general",
    "random_symmetric",
    "random_pattern",
    "banded",
    "fem_3d",
    "power_law",
    "road_network",
    "diagonal_dominant",
    "dense_rows_mix",
    "cancelling_pairs",
    "BENCH_SUITE",
    "generate_suite",
    "write_suite",
]


def _dedup(nrows, ncols, row, col, val):
    key = row.astype(np.int64) * ncols + col.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    return COOMatrix(nrows, ncols, row[idx], col[idx], val[idx])


def random_general(nrows: int, ncols: int, density: float, seed: int = 0) -> COOMatrix:
    """Uniform random sparse matrix (≙ matrix_generator.py general/real)."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(round(nrows * ncols * density)))
    nnz = min(nnz, nrows * ncols)
    flat = rng.choice(nrows * ncols, size=nnz, replace=False) if nrows * ncols < 1 << 28 else None
    if flat is not None:
        row, col = np.divmod(flat, ncols)
    else:
        row = rng.integers(0, nrows, nnz)
        col = rng.integers(0, ncols, nnz)
    val = rng.uniform(-1.0, 1.0, row.size)
    return _dedup(nrows, ncols, row.astype(np.int32), col.astype(np.int32), val)


def random_symmetric(n: int, density: float, seed: int = 0) -> COOMatrix:
    """Symmetric random matrix, materialized fully expanded
    (≙ matrix_generator.py symmetric branch + parser expansion)."""
    base = random_general(n, n, density / 2, seed)
    # canonicalize to the lower triangle first so mirrored pairs agree
    lo = _dedup(n, n, np.maximum(base.row, base.col),
                np.minimum(base.row, base.col), base.val)
    off = lo.row != lo.col
    row = np.concatenate([lo.row, lo.col[off]])
    col = np.concatenate([lo.col, lo.row[off]])
    val = np.concatenate([lo.val, lo.val[off]])
    return _dedup(n, n, row, col, val)


def random_pattern(nrows: int, ncols: int, density: float, seed: int = 0) -> COOMatrix:
    """Pattern matrix: all values 1.0 (≙ matrix_generator.py pattern field)."""
    m = random_general(nrows, ncols, density, seed)
    return COOMatrix(nrows, ncols, m.row, m.col, np.ones_like(m.val))


def banded(n: int, nnz_per_row: int, bandwidth: int, seed: int = 0) -> COOMatrix:
    """FEM-class banded matrix: each row has ~nnz_per_row entries within
    +-bandwidth of the diagonal (Cube_Coup_dt0 / cant / ML_Laplace regime:
    long uniform rows, strong column locality)."""
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    col = row + rng.integers(-bandwidth, bandwidth + 1, size=row.size)
    np.clip(col, 0, n - 1, out=col)
    val = rng.standard_normal(row.size)
    return _dedup(n, n, row.astype(np.int32), col.astype(np.int32), val)


def fem_3d(nx: int, ny: int, nz: int, dof: int = 3, seed: int = 0) -> COOMatrix:
    """Realistic 3-D FEM stiffness pattern (Cube_Coup_dt0 / af_1_k101 class).

    Nodes on an nx x ny x nz grid with ``dof`` unknowns each; every node
    couples to its 27-neighborhood, so each row holds up to 27 *contiguous
    runs* of ``dof`` columns — the clustered column structure real FEM
    matrices have (unlike :func:`banded`, which draws columns uniformly at
    random inside the band and is an adversarial stress case for any
    locality-exploiting kernel)."""
    rng = np.random.default_rng(seed)
    nn = nx * ny * nz
    n = nn * dof
    # neighbor offsets in node space
    offs = np.array([
        dx + dy * nx + dz * nx * ny
        for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    ], dtype=np.int64)
    node = np.arange(nn, dtype=np.int64)
    x = node % nx
    y = (node // nx) % ny
    z = node // (nx * ny)
    rows_l, cols_l = [], []
    for k, (dz, dy, dx) in enumerate(
        [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    ):
        ok = (
            (x + dx >= 0) & (x + dx < nx)
            & (y + dy >= 0) & (y + dy < ny)
            & (z + dz >= 0) & (z + dz < nz)
        )
        src = node[ok]
        dst = src + offs[k]
        rows_l.append(src)
        cols_l.append(dst)
    nr = np.concatenate(rows_l)
    nc = np.concatenate(cols_l)
    # expand node coupling to dof x dof dense blocks
    di = np.arange(dof, dtype=np.int64)
    row, col = np.broadcast_arrays(
        nr[:, None, None] * dof + di[None, :, None],
        nc[:, None, None] * dof + di[None, None, :],
    )
    row = row.reshape(-1)
    col = col.reshape(-1)
    val = rng.standard_normal(row.size)
    return COOMatrix(n, n, row.astype(np.int32), col.astype(np.int32), val)


def power_law(n: int, avg_nnz_per_row: int, alpha: float = 2.1, seed: int = 0,
              max_row: int | None = None) -> COOMatrix:
    """Power-law (webbase-1M class): row degrees ~ Zipf(alpha), columns
    preferentially attached — the adversarial case for padded formats
    (reference result: HLL warp-shared collapses to 0.21 GFLOPS on
    webbase-1M, BASELINE.md)."""
    rng = np.random.default_rng(seed)
    deg = rng.zipf(alpha, size=n).astype(np.int64)
    cap = max_row or max(64, avg_nnz_per_row * 64)
    np.clip(deg, 1, cap, out=deg)
    scale = n * avg_nnz_per_row / deg.sum()
    deg = np.maximum(1, (deg * scale).astype(np.int64))
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    # preferential column attachment: square a uniform to bias to low ids,
    # then permute so "hubs" are scattered
    u = rng.random(row.size)
    col = (u * u * n).astype(np.int64)
    perm = rng.permutation(n)
    col = perm[np.clip(col, 0, n - 1)]
    val = rng.standard_normal(row.size)
    return _dedup(n, n, row.astype(np.int32), col.astype(np.int32), val)


def webbase_like(n: int, avg_nnz_per_row: int = 3, alpha: float = 2.1,
                 seed: int = 0) -> COOMatrix:
    """webbase-1M with its REAL structure: power-law row degrees plus the
    web graph's locality — ~70% of links stay within the page's domain
    neighborhood (crawl order clusters domains) and ~30% go to globally
    popular hub pages whose ids CLUSTER (hubs are crawled early).

    :func:`power_law` permutes its hub columns to destroy locality — a
    deliberately adversarial regime with ~1 distinct column-slab per entry
    per row-group, which no broadcast-based TPU kernel can serve below
    ~4 vector-ops/entry (docs/DESIGN.md round-3 facts). Real webbase is
    this matrix: the reference's 2.78/15.08 GFLOPS webbase-1M rows
    (result_cuda.csv:11) describe a graph WITH locality."""
    rng = np.random.default_rng(seed)
    deg = rng.zipf(alpha, size=n).astype(np.int64)
    np.clip(deg, 1, max(64, avg_nnz_per_row * 64), out=deg)
    scale = n * avg_nnz_per_row / deg.sum()
    deg = np.maximum(1, (deg * scale).astype(np.int64))
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    # local links: within the domain neighborhood of the source page
    local = row + rng.integers(-4000, 4001, size=row.size)
    # hub links: preferential attachment to low (early-crawled) ids
    u = rng.random(row.size)
    hub = (u * u * n).astype(np.int64)
    use_hub = rng.random(row.size) < 0.3
    col = np.where(use_hub, np.clip(hub, 0, n - 1),
                   np.clip(local, 0, n - 1))
    val = rng.standard_normal(row.size)
    return _dedup(n, n, row.astype(np.int32), col.astype(np.int32), val)


def road_network(n: int, seed: int = 0) -> COOMatrix:
    """roadNet-PA class: ~2-4 nnz/row, near-diagonal + a few long links."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 5, size=n)
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    local = row + rng.integers(-50, 51, size=row.size)
    far = rng.integers(0, n, size=row.size)
    use_far = rng.random(row.size) < 0.05
    col = np.where(use_far, far, np.clip(local, 0, n - 1))
    val = np.ones(row.size)
    return _dedup(n, n, row.astype(np.int32), col.astype(np.int32), val)


def diagonal_dominant(n: int, nnz_per_row: int = 7, seed: int = 0) -> COOMatrix:
    """thermal2-class: few nnz/row, clustered near diagonal."""
    return banded(n, nnz_per_row, max(8, n // 1000), seed)


def dense_rows_mix(n: int, seed: int = 0) -> COOMatrix:
    """dc1-class: mostly short rows plus a handful of dense rows —
    stresses the K-binning load balancer."""
    rng = np.random.default_rng(seed)
    base = banded(n, 5, 30, seed)
    hot = rng.choice(n, size=max(1, n // 2000), replace=False)
    hrow = np.repeat(hot.astype(np.int64), n // 50)
    hcol = rng.integers(0, n, size=hrow.size)
    row = np.concatenate([base.row.astype(np.int64), hrow])
    col = np.concatenate([base.col.astype(np.int64), hcol])
    val = np.concatenate([base.val, rng.standard_normal(hrow.size)])
    return _dedup(n, n, row.astype(np.int32), col.astype(np.int32), val)


def cancelling_pairs(n: int, pairs: int = 4, bandwidth: int = 64,
                     seed: int = 0):
    """A banded matrix whose rows cancel, and the x it is meant for (this
    port's own; the JAX package has no counterpart): the accuracy check of
    the double-double kernels.

    Every value and x entry is an integer multiple of 2^-12 (x in (0.75,
    1.25), values about as large, either sign), so every product is an
    integer multiple of 2^-24 of magnitude about 1 with up to 26 significant
    bits: exact in fp64 and as a double-double pair, rounded in f32. Row i
    holds ``pairs`` pairs ``v1*x[c1] - v2*x[c2]`` on distinct columns within
    ``bandwidth`` of i (wrapping), with v2 chosen so that each pair sums to a
    few units of 2^-24: each row sums to about 1e-7 of its terms. A dd SpMV
    then returns the fp64 product exactly, while an f32 SpMV misses by about
    |y| itself. Returns ``(COOMatrix, x)``."""
    rng = np.random.default_rng(seed)
    X = 4096 + rng.integers(-1024, 1025, n)                  # x = X / 4096
    offs = np.argsort(rng.random((n, 2 * bandwidth + 1)), axis=1)[:, :2 * pairs]
    cols = (np.arange(n)[:, None] + offs - bandwidth) % n    # distinct per row
    X1, X2 = X[cols[:, 0::2]], X[cols[:, 1::2]]
    # V1 * X1 - V2 * X2 with V2 = round(V1 * X1 / X2): keep the V1 of 512
    # tries whose pair residual is smallest
    best_v1 = np.zeros_like(X1)
    best_res = np.full(X1.shape, np.iinfo(np.int64).max)
    for v1 in 4096 + rng.permutation(np.arange(-1024, 1025))[:512]:
        res = np.abs(v1 * X1 - np.rint(v1 * X1 / X2).astype(np.int64) * X2)
        better = res < best_res
        best_v1[better], best_res[better] = v1, res[better]
    V2 = np.rint(best_v1 * X1 / X2).astype(np.int64)
    sign = rng.choice(np.array([-1, 1]), X1.shape)
    vals = np.empty(cols.shape, np.float64)
    vals[:, 0::2] = sign * best_v1 / 4096.0
    vals[:, 1::2] = -sign * V2 / 4096.0
    row = np.repeat(np.arange(n), 2 * pairs)
    return (COOMatrix(n, n, row, cols.reshape(-1), vals.reshape(-1)),
            X / 4096.0)


def kkt_saddle(grid: int = 89, constraint_frac: float = 0.5,
               couple: int = 6, seed: int = 0) -> COOMatrix:
    """nlpkkt80-class KKT saddle-point system (VERDICT r3 missing-1).

    The reference sweep's nlpkkt80 (result_openmp.csv) is the KKT matrix of
    a 3-D PDE-constrained optimization: symmetric 2x2 block structure

        [ H   J^T ]      H : state Hessian, 27-point grid coupling
        [ J   0   ]      J : constraint Jacobian, grid-local
                         0 : ZERO diagonal block — constraint rows have no
                             diagonal entry and touch only state columns

    The zero block is the structural signature no other suite matrix has:
    a contiguous row range whose column support lives entirely in the
    other partition, plus rows (states) that mix near-diagonal H columns
    with far J^T columns. Exercises the K-binner on a bimodal row-length
    mix (H rows ~27+couple, constraint rows ~couple)."""
    rng = np.random.default_rng(seed)
    # H: 27-point coupling on a grid^3 node set (dof=1)
    h = fem_3d(grid, grid, grid, dof=1, seed=seed)
    nh = h.nrows
    nc = int(nh * constraint_frac)
    n = nh + nc
    # J: each constraint row couples to `couple` grid-local states around
    # its anchor (constraint i anchored at state 2i for constraint_frac=.5)
    crow = np.repeat(np.arange(nc, dtype=np.int64), couple)
    anchor = (crow * (nh // max(nc, 1))).astype(np.int64)
    ccol = anchor + rng.integers(-40, 41, size=crow.size)
    np.clip(ccol, 0, nh - 1, out=ccol)
    cval = rng.standard_normal(crow.size)
    row = np.concatenate([
        h.row.astype(np.int64),          # H block
        crow + nh,                       # J rows (constraint partition)
        ccol,                            # J^T rows (state partition)
    ])
    col = np.concatenate([
        h.col.astype(np.int64),
        ccol,                            # J cols -> state partition
        crow + nh,                       # J^T cols -> constraint partition
    ])
    val = np.concatenate([h.val, cval, cval])
    return _dedup(n, n, row.astype(np.int32), col.astype(np.int32), val)


def copurchase_graph(n: int = 262_000, avg_deg: int = 5,
                     local_frac: float = 0.8, seed: int = 0) -> COOMatrix:
    """amazon0302-class co-purchase graph (VERDICT r3 missing-1).

    The reference sweep's amazon0302 (262k nodes, 1.23M edges, ~4.7/row)
    is a moderate-locality scale-free graph: product ids follow crawl
    order, so most co-purchase links land near the diagonal (same
    category crawled together) with a scale-free tail of popular products
    — between road_like (pure local, deg<=4) and powerlaw_web (zero
    locality) in the suite's locality spectrum."""
    rng = np.random.default_rng(seed)
    deg = np.maximum(1, rng.lognormal(mean=np.log(avg_deg), sigma=0.6,
                                      size=n)).astype(np.int64)
    np.clip(deg, 1, 40, out=deg)
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    local = row + rng.integers(-1000, 1001, size=row.size)
    # popular-product tail: preferential attachment to early (low) ids
    u = rng.random(row.size)
    popular = (u * u * n).astype(np.int64)
    use_local = rng.random(row.size) < local_frac
    col = np.where(use_local, np.clip(local, 0, n - 1),
                   np.clip(popular, 0, n - 1))
    val = np.ones(row.size)
    return _dedup(n, n, row.astype(np.int32), col.astype(np.int32), val)


def econ_sectors(n: int = 206_500, sector: int = 500, avg_nnz: int = 6,
                 cross_frac: float = 0.25, seed: int = 0) -> COOMatrix:
    """mac_econ_fwd500-class macroeconomic model (VERDICT r4 item 7).

    The reference sweep's mac_econ_fwd500 (206,500^2, 1.27M nnz ~6.2/row,
    result_cuda.csv) is a forward-simulation economic model: variables
    group into sector blocks; each short row couples mostly within its
    sector (block-local columns) with a minority of cross-sector links to
    arbitrary sectors. Signature regime: SHORT scattered rows with
    two-scale locality — between road_like (pure local) and powerlaw_web
    (none) — and a bimodal |col-row| distribution."""
    rng = np.random.default_rng(seed)
    deg = np.maximum(1, rng.poisson(avg_nnz - 1, size=n) + 1)
    np.clip(deg, 1, 44, out=deg)   # mac_econ max row nnz is 44
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    base = (row // sector) * sector
    local = base + rng.integers(0, sector, size=row.size)
    target_sector = rng.integers(0, n // sector, size=row.size)
    cross = target_sector * sector + rng.integers(0, sector, size=row.size)
    use_cross = rng.random(row.size) < cross_frac
    col = np.where(use_cross, cross, local)
    np.clip(col, 0, n - 1, out=col)
    val = rng.standard_normal(row.size)
    return _dedup(n, n, row.astype(np.int32), col.astype(np.int32), val)


def unstructured_fem(n_target: int = 121_000, avg_nnz: int = 22,
                     shuffle_frac: float = 0.35, seed: int = 0) -> COOMatrix:
    """cop20k_A-class unstructured-mesh FEM (VERDICT r4 item 7).

    The reference sweep's cop20k_A (121,192^2, 2.62M nnz ~21.7/row,
    result_cuda.csv) is an accelerator-cavity FEM on an unstructured
    tetrahedral mesh with a jumbled node numbering: neighbor couplings
    are mesh-local but the id ordering scatters a large fraction of
    columns far from the diagonal. Modeled as a 3-D 27-point operator
    whose node ids are partially shuffled (``shuffle_frac`` of nodes get
    random ids): the surviving local fraction keeps slab reuse alive
    while the shuffled tail stresses the gather path — the regime between
    fem3d_cube (perfect banding) and random_uniform."""
    rng = np.random.default_rng(seed)
    g = int(round(n_target ** (1 / 3)))
    base = fem_3d(g, g, g, dof=1, seed=seed)
    n = base.nrows
    perm = np.arange(n, dtype=np.int64)
    k = int(n * shuffle_frac)
    pick = rng.choice(n, size=k, replace=False)
    perm[np.sort(pick)] = pick[rng.permutation(k)]
    row = perm[base.row.astype(np.int64)]
    col = perm[base.col.astype(np.int64)]
    # thin to the target average row length (27-pt gives ~27/row)
    keep = rng.random(row.size) < min(1.0, avg_nnz / 27.0)
    keep |= row == col  # keep the diagonal
    return _dedup(n, n, row[keep].astype(np.int32),
                  col[keep].astype(np.int32), base.val[keep])


def cfd_multidof(nx: int = 180, ny: int = 180, dof: int = 5,
                 seed: int = 0) -> COOMatrix:
    """PR02R-class CFD Jacobian (VERDICT r4 item 7).

    The reference sweep's PR02R (161,070^2, 8.19M nnz ~50.8/row,
    result_cuda.csv; its best CUDA number is the WARP kernel at 43.89
    fp64 GF — long clustered rows) is a reacting-flow CFD Jacobian:
    multiple conserved quantities per cell give dense dof x dof blocks
    over a 2-D 9-point stencil — rows of ~45 tightly clustered entries.
    The structure class is the dd-headroom showcase: long rows, few
    distinct slabs per chunk."""
    rng = np.random.default_rng(seed)
    cells = nx * ny
    cid = np.arange(cells, dtype=np.int64)
    cx, cy = cid % nx, cid // nx
    neigh = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ox, oy = cx + dx, cy + dy
            ok = (ox >= 0) & (ox < nx) & (oy >= 0) & (oy < ny)
            neigh.append((cid[ok], (oy[ok] * nx + ox[ok])))
    ci = np.concatenate([a for a, _ in neigh])
    cj = np.concatenate([b for _, b in neigh])
    # expand to dof x dof dense blocks
    di = np.arange(dof, dtype=np.int64)
    row = (ci[:, None, None] * dof + di[None, :, None]).repeat(dof, axis=2)
    col = (cj[:, None, None] * dof + di[None, None, :]).repeat(dof, axis=1)
    row, col = row.ravel(), col.ravel()
    val = rng.standard_normal(row.size)
    return _dedup(cells * dof, cells * dof, row.astype(np.int32),
                  col.astype(np.int32), val)


@dataclass(frozen=True)
class SuiteEntry:
    name: str
    family: str
    make: object  # () -> COOMatrix


# The standing bench corpus: one entry per SuiteSparse regime in the
# reference sweep (names indicate the analogue).
BENCH_SUITE = [
    SuiteEntry("fem3d_cube", "3-D FEM 27-point x 3 dof (Cube_Coup_dt0-class)",
               lambda: fem_3d(60, 60, 60, dof=3, seed=1)),
    SuiteEntry("banded_fem_large", "random-in-band stress (adversarial)",
               lambda: banded(1_500_000, 80, 4000, seed=1)),
    SuiteEntry("banded_fem_medium", "banded (cant-class)",
               lambda: banded(250_000, 64, 1500, seed=2)),
    SuiteEntry("ml_laplace_like", "banded (ML_Laplace-class)",
               lambda: banded(400_000, 70, 2500, seed=3)),
    SuiteEntry("thermal_like", "diagonal (thermal2-class)",
               lambda: diagonal_dominant(1_200_000, 7, seed=4)),
    SuiteEntry("road_like", "graph (roadNet-PA-class)",
               lambda: road_network(1_000_000, seed=5)),
    SuiteEntry("powerlaw_web", "power-law, zero locality (adversarial)",
               lambda: power_law(1_000_000, 3, seed=6)),
    SuiteEntry("webbase_like", "power-law + web locality (webbase-1M-class)",
               lambda: webbase_like(1_000_000, 3, seed=9)),
    SuiteEntry("dense_rows_mix", "mixed (dc1-class)",
               lambda: dense_rows_mix(500_000, seed=7)),
    SuiteEntry("random_uniform", "uniform random (cage-class)",
               lambda: random_general(200_000, 200_000, 2.5e-4, seed=8)),
    SuiteEntry("kkt_like", "KKT saddle-point, zero diag block "
               "(nlpkkt80-class)",
               lambda: kkt_saddle(89, seed=10)),
    SuiteEntry("amazon_like", "co-purchase graph, moderate locality "
               "(amazon0302-class)",
               lambda: copurchase_graph(262_000, seed=11)),
    # realistic (clustered-column) FEM at the reference's Cube_Coup_dt0
    # size (127M nnz, result_cuda.csv:3) — the flagship kernel class
    # demonstrated at 100M+ scale (VERDICT r3 weak-3)
    SuiteEntry("fem3d_large", "3-D FEM 27-point x 3 dof, 127M nnz "
               "(Cube_Coup_dt0-size)",
               lambda: fem_3d(82, 82, 82, dof=3, seed=12)),
    SuiteEntry("econ_like", "sector-block economic model, short scattered "
               "rows (mac_econ_fwd500-class)",
               lambda: econ_sectors(206_500, seed=13)),
    SuiteEntry("cop20k_like", "unstructured-mesh FEM, shuffled node ids "
               "(cop20k_A-class)",
               lambda: unstructured_fem(121_000, seed=14)),
    SuiteEntry("cfd_like", "multi-dof CFD Jacobian, long clustered rows "
               "(PR02R-class)",
               lambda: cfd_multidof(180, 180, dof=5, seed=15)),
]


def generate_suite(entries=None):
    """Yield (name, family, COOMatrix) for the bench corpus."""
    for e in entries or BENCH_SUITE:
        yield e.name, e.family, e.make()


def write_suite(directory: str, entries=None):
    """Materialize the corpus as .mtx files (≙ the reference's
    matrix_for_test/ directory feeding main.c:25-44)."""
    import os

    from ..io.mmio import write_matrix_market

    os.makedirs(directory, exist_ok=True)
    paths = []
    for name, _family, coo in generate_suite(entries):
        p = os.path.join(directory, f"{name}.mtx")
        write_matrix_market(p, coo.nrows, coo.ncols, coo.row, coo.col, coo.val)
        paths.append(p)
    return paths
