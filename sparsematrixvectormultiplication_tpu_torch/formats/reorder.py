"""Bandwidth-reducing matrix reordering (reverse Cuthill–McKee).

The reference benchmarks every matrix exactly as stored on disk
(main.c:25-44) — it has no preprocessing stage.  Entry *locality* sets how
fast the SELL kernels stream a matrix: narrow-band matrices read x from a
small window, zero-locality ones gather it from anywhere.  A symmetric
permutation ``A' = P A Pᵀ`` is workload-equivalent SpMV — same nnz, same
FLOPs, ``y' = P y`` and ``x' = P x`` (with the harness's reference-
convention ``x = ones``, ``x`` is literally unchanged) — so reordering is
a legitimate preprocessing lever, the sparse-matrix analogue of choosing
a storage format.

Road-network-class graphs (roadNet-PA in the reference sweep,
result_cuda.csv:12) are near-planar: RCM collapses their ~O(n) scatter
to an O(√n) band, moving them from the scattered SG regime into the
banded streaming regime.

``rcm_permutation`` uses scipy's C implementation of reverse
Cuthill–McKee on the symmetrized pattern when scipy is importable (it is
a baked-in dependency of the test oracle already) and falls back to a
pure-numpy BFS otherwise.
"""

# Numpy host layer copied from
# sparsematrixvectormultiplication_tpu/formats/reorder.py (the port must not
# import the JAX package); tests/test_torch_reorder.py holds the two
# array-equal, on the scipy path and on the numpy fallback.

from __future__ import annotations

import numpy as np

from .csr import CSRMatrix

__all__ = [
    "bandwidth_stats",
    "rcm_permutation",
    "permute_csr",
    "reorder_rcm",
]


def bandwidth_stats(csr: CSRMatrix) -> dict:
    """Per-entry |col - row| distribution — the locality figure of merit.

    ``p98`` (not max) drives the auto decision: a handful of long-range
    entries land in the harness's heavy-row/remainder machinery anyway.
    """
    if csr.nnz == 0:
        return {"mean": 0.0, "p50": 0, "p98": 0, "max": 0}
    rows = np.repeat(
        np.arange(csr.nrows, dtype=np.int64), np.diff(csr.row_ptr)
    )
    d = np.abs(csr.col_idx.astype(np.int64) - rows)
    return {
        "mean": float(d.mean()),
        "p50": int(np.percentile(d, 50)),
        "p98": int(np.percentile(d, 98)),
        "max": int(d.max()),
    }


def _rcm_numpy(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Pure-numpy RCM on a symmetric pattern: BFS from a min-degree seed
    per component, neighbors visited in increasing-degree order, result
    reversed.  O(nnz log nnz); the scipy path is preferred at scale."""
    deg = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    seeds = np.argsort(deg, kind="stable")  # global min-degree first
    si = 0
    while pos < n:
        while si < len(seeds) and visited[seeds[si]]:
            si += 1
        root = seeds[si]
        visited[root] = True
        order[pos] = root
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            nbr = indices[indptr[u]:indptr[u + 1]]
            nbr = nbr[~visited[nbr]]
            if nbr.size:
                nbr = np.unique(nbr)  # unique also sorts; re-rank by degree
                nbr = nbr[np.argsort(deg[nbr], kind="stable")]
                visited[nbr] = True
                order[pos:pos + nbr.size] = nbr
                pos += nbr.size
    return order[::-1].copy()


def rcm_permutation(csr: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill–McKee permutation of the symmetrized pattern.

    Returns ``perm`` with the new→old convention: new row/col ``i`` is old
    row/col ``perm[i]``.  Requires a square matrix (symmetric two-sided
    permutations only make sense there)."""
    if csr.nrows != csr.ncols:
        raise ValueError("RCM reordering requires a square matrix")
    n = csr.nrows
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        a = sp.csr_matrix(
            (np.ones(csr.nnz, np.int8), csr.col_idx, csr.row_ptr),
            shape=(n, n),
        )
        a = a + a.T  # symmetrize the pattern
        perm = reverse_cuthill_mckee(a, symmetric_mode=True)
        return perm.astype(np.int64)
    except ImportError:  # pragma: no cover - scipy is baked in here
        pass
    # numpy fallback: symmetrize by hand
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.row_ptr))
    cols = csr.col_idx.astype(np.int64)
    r2 = np.concatenate([rows, cols])
    c2 = np.concatenate([cols, rows])
    order = np.lexsort((c2, r2))
    r2, c2 = r2[order], c2[order]
    keep = np.ones(r2.size, dtype=bool)
    keep[1:] = (r2[1:] != r2[:-1]) | (c2[1:] != c2[:-1])
    r2, c2 = r2[keep], c2[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r2, minlength=n), out=indptr[1:])
    return _rcm_numpy(indptr, c2, n)


def permute_csr(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Symmetric two-sided permutation ``P A Pᵀ`` (perm is new→old),
    vectorized: gather whole row slices in ``perm`` order, remap columns
    through the inverse permutation, re-sort columns within rows."""
    n = csr.nrows
    if csr.ncols != n:
        raise ValueError("permute_csr requires a square matrix")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)

    counts = np.diff(csr.row_ptr)[perm]
    new_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=new_ptr[1:])
    total = int(new_ptr[-1])
    # source entry index of each destination slot: row-start + offset-in-row
    offs = np.arange(total, dtype=np.int64) - np.repeat(new_ptr[:-1], counts)
    src = np.repeat(csr.row_ptr[perm], counts) + offs
    new_col = inv[csr.col_idx[src]]
    new_val = csr.values[src]
    # column-sort within each row (CSR invariant the converters rely on)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), counts)
    order = np.lexsort((new_col, row_ids))
    return CSRMatrix(
        n, n, new_ptr,
        np.ascontiguousarray(new_col[order], dtype=np.int32),
        np.ascontiguousarray(new_val[order]),
    )


def reorder_rcm(csr: CSRMatrix, mode: str = "rcm", min_gain: float = 2.0,
                log=None) -> tuple:
    """One-call preprocessing: returns ``(csr', perm, stats)``.

    mode="rcm"  — always apply.
    mode="auto" — apply only when the p98 bandwidth improves by at least
    ``min_gain``× (measured, not guessed: both distributions are computed
    on the actual matrix).  On no-gain or non-square input returns the
    original matrix with ``perm=None``.
    """
    stats: dict = {"mode": mode, "applied": False}
    if csr.nrows != csr.ncols:
        stats["reason"] = "non-square"
        return csr, None, stats
    import time

    t0 = time.perf_counter()
    before = bandwidth_stats(csr)
    perm = rcm_permutation(csr)
    csr_p = permute_csr(csr, perm)
    after = bandwidth_stats(csr_p)
    stats.update(
        seconds=time.perf_counter() - t0,
        bandwidth_before=before,
        bandwidth_after=after,
    )
    gain = before["p98"] / max(after["p98"], 1)
    stats["p98_gain"] = float(gain)
    if mode == "auto" and gain < min_gain:
        stats["reason"] = f"p98 gain {gain:.2f}x < {min_gain}x"
        if log:
            log(f"reorder: auto-skip ({stats['reason']})")
        return csr, None, stats
    stats["applied"] = True
    if log:
        log(f"reorder: rcm applied, p98 bandwidth {before['p98']} -> "
            f"{after['p98']} ({gain:.1f}x) in {stats['seconds']:.2f}s")
    return csr_p, perm, stats
