"""Host-side routing for the PR (permutation-routed) SpMV layout.

The PR layout decouples SpMV's gather from its scatter: products are
computed in column(-slab)-sorted order — where the x-gather is nearly free —
then moved to row-sorted order by a *precomputed permutation* executed as a
Beneš exchange network of TPU-fast primitives (lane gathers + sublane
rolls + masked selects). This file computes that routing at conversion
time; nothing here runs on the device.

Decomposition (classic 3-stage Clos, König/Hall):

1. The element movement ``source row -> dest row`` over the ``(n_rows,
   128)`` product array is a 128-regular bipartite multigraph (both sides
   padded to exactly 128 elements per row). A proper 128-edge-coloring
   assigns each element a *lane* such that lanes are distinct within every
   source row and every dest row (:func:`edge_color_128`, Euler-split
   recursion — degree must be a power of two).
2. Placing each element at (source row, lane) turns the movement into 128
   independent row-permutations, one per lane (no cross-lane movement).
3. Each per-lane row permutation is realized by one shared Beneš network
   over ``n_rows`` positions (2*log2(n_rows)-1 exchange stages at xor
   distances n/2..1..n/2); per-(row, lane) swap bits come from
   :func:`benes_masks` and are bit-packed into a single int32 plane
   (stage s = bit s), so the device kernel streams ONE mask array for all
   stages.

A final per-row lane gather (take_along_axis) moves every element from its
routing lane to its destination lane; the *initial* lane placement is free
(applied to the value/index arrays at conversion), so only ONE runtime
lane-gather pass is needed.

No reference-analogous component exists (the CUDA kernels gather through
the GPU's native per-lane load unit, cuda_src/csr_matrix_cuda.cu:151-196);
this is the TPU-native replacement for hardware gather on zero-locality
matrices (docs/DESIGN.md round-3 "diffuse floor").
"""

# Numpy host layer copied from
# sparsematrixvectormultiplication_tpu/formats/pr_route.py unchanged (the port
# must not import the JAX package); tests/test_torch_pr.py holds the two
# array-equal.

from __future__ import annotations

import numpy as np

__all__ = [
    "edge_color_128",
    "benes_masks",
    "benes_stage_distances",
    "apply_benes",
    "route_elements",
]


# ---------------------------------------------------------------------------
# bipartite edge coloring (Euler-split recursion)
# ---------------------------------------------------------------------------

def _euler_split(src: np.ndarray, dst: np.ndarray, eids: np.ndarray,
                 n_rows: int) -> np.ndarray:
    """One Euler split of a bipartite multigraph with all degrees even.

    ``src``/``dst`` are per-edge endpoint rows (0..n_rows) for the subset
    ``eids``; returns a 0/1 side per edge such that every node's edges
    split exactly in half. Walks closed trails (Hierholzer) and orients
    edges by traversal direction: L->R = 0, R->L = 1.
    """
    m = eids.size
    # incidence: node ids 0..n_rows-1 = source rows, n_rows..2*n_rows-1 = dest
    u = src
    v = dst + n_rows
    # CSR-style incidence over 2*n_rows nodes; each edge appears twice
    deg = np.bincount(u, minlength=2 * n_rows) + np.bincount(v, minlength=2 * n_rows)
    ptr = np.zeros(2 * n_rows + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    inc = np.empty(2 * m, dtype=np.int64)  # local edge index
    cur = ptr[:-1].copy()
    for e in range(m):
        inc[cur[u[e]]] = e
        cur[u[e]] += 1
    for e in range(m):
        inc[cur[v[e]]] = e
        cur[v[e]] += 1

    used = np.zeros(m, dtype=bool)
    side = np.zeros(m, dtype=np.int8)
    cursor = ptr[:-1].copy()

    for start_e in range(m):
        if used[start_e]:
            continue
        # walk a closed trail starting along edge start_e from its source node
        e = start_e
        node = u[e]
        while True:
            used[e] = True
            # orient: traversing from src side -> 0, from dst side -> 1
            if node == u[e]:
                side[e] = 0
                node = v[e]
            else:
                side[e] = 1
                node = u[e]
            # find next unused edge at `node`
            c = cursor[node]
            stop = ptr[node + 1]
            while c < stop and used[inc[c]]:
                c += 1
            cursor[node] = c
            if c == stop:
                break  # trail closed (even degrees guarantee node == start)
            e = inc[c]
    return side


def edge_color_128(src_row: np.ndarray, dst_row: np.ndarray, n_rows: int,
                   degree: int = 128) -> np.ndarray:
    """Proper ``degree``-edge-coloring of the (src_row, dst_row) bipartite
    multigraph. Every source row and every dest row must have exactly
    ``degree`` incident elements; ``degree`` must be a power of two.

    Returns per-element colors in ``[0, degree)`` — the routing lane.
    Pure-python reference; the native twin (fast_route.cpp) is used for
    real sizes.
    """
    n = src_row.size
    assert degree & (degree - 1) == 0, "degree must be a power of two"
    color = np.zeros(n, dtype=np.int32)
    levels = int(degree).bit_length() - 1
    src_row = np.asarray(src_row, dtype=np.int64)
    dst_row = np.asarray(dst_row, dtype=np.int64)
    groups = [np.arange(n, dtype=np.int64)]
    for level in range(levels):
        next_groups = []
        for eids in groups:
            side = _euler_split(src_row[eids], dst_row[eids], eids, n_rows)
            color[eids] = (color[eids] << 1) | side
            next_groups.append(eids[side == 0])
            next_groups.append(eids[side == 1])
        groups = next_groups
    return color


# ---------------------------------------------------------------------------
# Beneš network routing
# ---------------------------------------------------------------------------

def benes_stage_distances(n: int) -> list[int]:
    """Exchange distances of the 2*log2(n)-1 Beneš stages over n=2^p
    positions: n/2, n/4, ..., 2, 1, 2, ..., n/2."""
    p = int(n).bit_length() - 1
    assert 1 << p == n, "n must be a power of two"
    down = [n >> (k + 1) for k in range(p)]          # n/2 .. 1
    return down + down[-2::-1]                        # .. 2 .. n/2


def benes_masks(perm: np.ndarray) -> np.ndarray:
    """Swap-bit masks realizing ``perm`` on a Beneš network.

    ``perm[i]`` = destination position of the element initially at
    position ``i`` (a bijection over n = 2^p positions). Returns masks of
    shape ``(n_stages, n)`` uint8 where stage ``s`` performs
    ``A[i] = masks[s, i] ? A[i ^ d_s] : A[i]`` (masks symmetric within
    each pair). Classic recursive looping algorithm.
    """
    perm = np.asarray(perm, dtype=np.int64)
    n = perm.size
    p = int(n).bit_length() - 1
    assert 1 << p == n
    n_stages = 2 * p - 1 if p > 0 else 0
    masks = np.zeros((max(n_stages, 1), n), dtype=np.uint8)
    if p == 0:
        return masks[:0]

    # recursion over (level, base, size): route perm restricted to
    # positions [base, base+size) (which perm maps onto itself)
    # in-stage index = level, out-stage index = n_stages-1-level
    def route(level: int, base: int, size: int, sigma: np.ndarray):
        # sigma: local permutation over [0, size) (input pos -> output pos)
        if size == 2:
            # middle stage: single exchange at distance 1
            s = p - 1
            if sigma[0] == 1:
                masks[s, base] = masks[s, base + 1] = 1
            return
        h = size // 2
        s_in = level
        s_out = n_stages - 1 - level
        inv = np.empty(size, dtype=np.int64)
        inv[sigma] = np.arange(size)
        # assign each ELEMENT (named by input position) a subnet in {0,1}.
        # Constraints: input-pair partners (e, e^h) differ; output-pair
        # partners (same output pair) differ. Cycles alternate the two
        # constraint types; walk them.
        sub = np.full(size, -1, dtype=np.int8)
        for seed in range(size):
            if sub[seed] >= 0:
                continue
            e, s = seed, 0
            while sub[e] < 0:
                sub[e] = s
                e2 = e ^ h                        # input-pair partner
                if sub[e2] < 0:
                    sub[e2] = 1 - s
                e = inv[sigma[e2] ^ h]            # e2's output-pair partner
                # e must take the opposite of e2's subnet = s
        # swap bits: a[P] = subnet of the element at input position P (<h);
        # b[Q] = subnet of the element whose OUTPUT position is Q (<h)
        a = sub[:h]
        b = sub[inv[:h]]
        masks[s_in, base:base + h] = a
        masks[s_in, base + h:base + size] = a
        masks[s_out, base:base + h] = b
        masks[s_out, base + h:base + size] = b
        # sub-permutations over mid positions: element e sits at mid slot
        # e%h of subnet sub[e] and must exit at slot sigma[e]%h
        lo_perm = np.empty(h, dtype=np.int64)
        hi_perm = np.empty(h, dtype=np.int64)
        idx = np.arange(size)
        lo_mask = sub == 0
        lo_perm[idx[lo_mask] % h] = sigma[lo_mask] % h
        hi_perm[idx[~lo_mask] % h] = sigma[~lo_mask] % h
        route(level + 1, base, h, lo_perm)
        route(level + 1, base + h, h, hi_perm)

    route(0, 0, n, perm)
    return masks


def apply_benes(a: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Reference executor: apply the exchange stages to array ``a`` along
    axis 0 (mirrors the device kernel's roll+select implementation)."""
    a = a.copy()
    n = a.shape[0]
    for s, d in enumerate(benes_stage_distances(n)):
        idx = np.arange(n)
        partner = a[idx ^ d]
        swap = masks[s].astype(bool)
        a = np.where(swap[(...,) + (None,) * (a.ndim - 1)], partner, a)
    return a


# ---------------------------------------------------------------------------
# full element routing (color + per-lane Beneš + final lane gather)
# ---------------------------------------------------------------------------

def route_elements(src_row: np.ndarray, dst_row: np.ndarray, dst_lane: np.ndarray,
                   n_rows: int):
    """Compute the full PR routing for elements with fixed source rows and
    fixed destination (row, lane) positions.

    Every source row and every dest row must host exactly 128 elements.
    Returns ``(src_lane, packed_masks, final_lane_idx)``:

    * ``src_lane`` (n,) int32 — the lane each element must be placed at in
      its source row (applied to the value/index arrays at conversion).
    * ``packed_masks`` (n_rows, 128) int32 — bit ``s`` = swap bit of Beneš
      stage ``s`` for that (row, lane). Requires n_stages <= 32, i.e.
      n_rows <= 2^16.
    * ``final_lane_idx`` (n_rows, 128) int32 — per dest row, the routing
      lane holding the element whose destination lane is ``l``:
      ``out[r, l] = routed[r, final_lane_idx[r, l]]`` (take_along_axis).
    """
    n = src_row.size
    assert n == n_rows * 128, "rows must be exactly full on both sides"
    color = edge_color_128(src_row, dst_row, n_rows)
    p = int(n_rows).bit_length() - 1
    assert 1 << p == n_rows, "n_rows must be a power of two"
    n_stages = 2 * p - 1 if p > 0 else 0
    assert n_stages <= 32, "mask bit-packing holds at most 32 stages"

    packed = np.zeros((n_rows, 128), dtype=np.int64)
    final_lane = np.empty((n_rows, 128), dtype=np.int32)
    src_lane = np.asarray(color, dtype=np.int32)

    # per-lane permutations
    order = np.argsort(color, kind="stable")
    for lane in range(128):
        eids = order[lane * n_rows:(lane + 1) * n_rows]
        # element at source row src_row[e] must reach dest row dst_row[e]
        perm = np.empty(n_rows, dtype=np.int64)
        perm[src_row[eids]] = dst_row[eids]
        if n_stages:
            masks = benes_masks(perm)
            packed[:, lane] = _pack_stage_bits(masks)
        # after routing, lane `lane` of dest row dst_row[e] holds element e;
        # its destination lane is dst_lane[e]
        final_lane[dst_row[eids], dst_lane[eids]] = lane
    return src_lane, packed.astype(np.int32), final_lane


def _pack_stage_bits(masks: np.ndarray) -> np.ndarray:
    """(n_stages, n) uint8 -> (n,) int64 with bit s = stage s."""
    out = np.zeros(masks.shape[1], dtype=np.int64)
    for s in range(masks.shape[0]):
        out |= masks[s].astype(np.int64) << s
    return out
