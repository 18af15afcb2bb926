"""What a product has to move and compute, and the least time for it.

The count depends on the configuration and the traffic alone, never on the
layout the package picks, so every implementation is held to the same work:

* bytes = nnz * v + R * (nrows + ncols) * w: each stored value read once
  (v bytes at the cell's precision), each entry of x read once and each
  entry of y written once (w bytes). Column indices count nothing, since
  an implementation may compress them away;
* operations = 2 * nnz * R, a double-double product counted as one
  multiply and one add, as the reference project counts it.

The least time is the larger of bytes over the card's memory bandwidth and
operations over its float32 rate (``peaks.json``).
"""

from __future__ import annotations

import json
from pathlib import Path

VALUE_BYTES = {"f32": 4, "bf16": 2, "dd": 8}
VECTOR_BYTES = {"f32": 4, "bf16": 4, "dd": 8}


def count(nnz: int, nrows: int, ncols: int, precision: str,
          r: int = 1) -> tuple:
    """``(bytes, operations)`` of one product of R right-hand sides."""
    nbytes = nnz * VALUE_BYTES[precision] \
        + r * (nrows + ncols) * VECTOR_BYTES[precision]
    return nbytes, 2 * nnz * r


def peaks(kind: str) -> dict | None:
    """The card's row of ``peaks.json`` by its name, or None."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    return table.get(kind)


def least_seconds(nbytes: int, operations: int, peak: dict) -> float:
    return max(nbytes / peak["hbm_bytes_per_s"],
               operations / peak["flops_per_s"])
