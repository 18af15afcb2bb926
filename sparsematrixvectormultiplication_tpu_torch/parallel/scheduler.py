"""nnz-balanced work partitioning — the framework's load-balance layer.

The reference's thread schedulers, promoted to device shards:

* ``prepare_thread_distribution`` (src/csr_matrix.c:167-266): greedy sweep
  assigning contiguous row ranges so each OpenMP thread gets
  ~``ceil(total_nnz / num_threads)`` nnz, unused threads compacted.
* ``prepare_thread_distribution_hll`` (src/hll_matrix.c:410-540): the same
  greedy balance over HLL blocks weighted by padded block area.

The same algorithm balances the *device shards* of row-sharding
(parallel/multidevice.py, parallel/spmd_pallas.py). The partitioning is
identical maths: contiguous prefix ranges with greedy target filling.
"""

# Numpy host layer copied from
# sparsematrixvectormultiplication_tpu/parallel/scheduler.py (the port must not
# import the JAX package); tests/test_torch_parallel.py holds the two equal.

from __future__ import annotations

import numpy as np

__all__ = ["balanced_partition", "Partition", "partition_report"]


class Partition:
    """Contiguous ranges ``[starts[i], ends[i])`` with per-range loads."""

    def __init__(self, starts, ends, loads):
        self.starts = np.asarray(starts, dtype=np.int64)
        self.ends = np.asarray(ends, dtype=np.int64)
        self.loads = np.asarray(loads, dtype=np.int64)

    @property
    def num_parts(self) -> int:
        return int(self.starts.size)

    @property
    def imbalance(self) -> float:
        """max/mean load ratio (1.0 = perfect)."""
        if self.num_parts == 0 or self.loads.sum() == 0:
            return 1.0
        return float(self.loads.max() / max(self.loads.mean(), 1e-30))

    def __iter__(self):
        return iter(zip(self.starts.tolist(), self.ends.tolist(), self.loads.tolist()))


def balanced_partition(weights: np.ndarray, num_parts: int, *,
                       compact: bool = True) -> Partition:
    """Greedy contiguous partition of ``weights`` into ``num_parts`` ranges.

    ≙ reference csr_matrix.c:196 (target = ceil(total/num)), :202-225 (greedy
    sweep), :228-238 (compaction of unused parts). Caps parts at the number of
    items (≙ csr_matrix.c:173 thread cap).
    """
    weights = np.asarray(weights, dtype=np.int64)
    n = weights.size
    num_parts = max(1, min(int(num_parts), max(n, 1)))
    total = int(weights.sum())
    if n == 0:
        return Partition([0], [0], [0])

    target = -(-total // num_parts) if total else -(-n // num_parts)
    starts, ends, loads = [], [], []
    cur_start, cur_load = 0, 0
    parts_left = num_parts
    cum = 0
    for i in range(n):
        cur_load += int(weights[i])
        cum += int(weights[i])
        # close the range when the target is met, keeping enough items for
        # the remaining parts
        remaining_items = n - (i + 1)
        remaining_parts = num_parts - len(starts) - 1
        if (cur_load >= target and remaining_parts > 0 and remaining_items >= remaining_parts) or (
            remaining_items == remaining_parts and remaining_parts > 0
        ):
            starts.append(cur_start)
            ends.append(i + 1)
            loads.append(cur_load)
            cur_start, cur_load = i + 1, 0
            # re-target on the remainder for better tail balance
            target = -(-(total - cum) // max(remaining_parts, 1)) if total - cum > 0 else 1
    starts.append(cur_start)
    ends.append(n)
    loads.append(cur_load)

    if compact:
        keep = [k for k in range(len(starts)) if ends[k] > starts[k]]
        starts = [starts[k] for k in keep]
        ends = [ends[k] for k in keep]
        loads = [loads[k] for k in keep]
    return Partition(starts, ends, loads)


def partition_report(p: Partition, label: str = "partition") -> str:
    """Distribution report (≙ the printed report of csr_matrix.c:240-262)."""
    lines = [f"{label}: {p.num_parts} parts, imbalance {p.imbalance:.3f}"]
    for i, (s, e, l) in enumerate(p):
        lines.append(f"  part {i}: items [{s},{e}) load {l}")
    return "\n".join(lines)
