"""Device times of the SELL SpMM kernels, bin by bin and R by R.

Run on a machine with a CUDA card::

    python -m sparsematrixvectormultiplication_tpu_torch.bench.spmm_sweep \\
        [--rhs 1,4,8,16,32] [--matrices headline,band64,banded_adversarial]

Matrices (the smoke's phases of the same names): ``headline`` is
``fem_3d(60, 60, 60, dof=3, seed=1)``, bench.py's fem3d_cube, whose SELL is
all wl bins; ``band64`` is ``banded(250_000, 64, 64, seed=11)`` and
``banded_adversarial`` ``banded(250_000, 60, 2500, seed=1)``, both
converted with ``layout="k-major"``. For each matrix and R it times
(``device_time_fn``, calls back to back) each bin's kernel on the packed x
table of :func:`~..ops.sell_spmm.pack_x_multi`, and ``sell_spmm`` on a
contiguous ``(ncols, R)`` f32 X as a solver passes it, packing included
where the package packs. It prints the card's name and power limit, then
one JSON line per bin and R and one per matrix and R for ``sell_spmm``:
device ms; the bound, the larger of the bytes the bin must move (its real
entries' values and indices, a 2-byte code in wl, 4 B in k-major; each
distinct x row it reads and each y row it writes, R f32 each) over 3.35
TB/s and its 2 FLOP per entry and R over 67 TFLOP/s; and the share of the
bound. The kernels are held against their plain versions by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``, not here.

The script calls only entry points the package has had since the SpMM
kernels were ported, so the same file also times an older checkout of the
package put first on ``PYTHONPATH`` (run it by path) beside the current one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from sparsematrixvectormultiplication_tpu_torch import CSRMatrix, SellMatrix
from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
    banded,
    fem_3d,
)
from sparsematrixvectormultiplication_tpu_torch.ops import _build
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_spmm as SM
from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
    device_time_fn,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
F32_FLOP_PER_S = 67e12     # H100 SXM f32 peak outside the tensor cores
# name -> (generator, SELL layout)
MATRICES = {
    "headline": (lambda: fem_3d(60, 60, 60, dof=3, seed=1), "auto"),
    "band64": (lambda: banded(250_000, 64, 64, seed=11), "k-major"),
    "banded_adversarial": (lambda: banded(250_000, 60, 2500, seed=1),
                           "k-major"),
}


def bin_counts(b) -> tuple:
    """The bin's real entries, the distinct x rows they read and the y rows
    they write."""
    shape, cols, keep, _ = S._SLOTS[b.layout](b)
    real = b.as_.reshape(shape) != 0
    if keep is not None:
        real = real & keep
    rows = real.reshape(b.n_groups, -1, 8, 128) if b.layout == "k-major" \
        else None
    if rows is not None:  # k-major: (g, k, i, j) -> rows (g, i, j)
        n_y = int(rows.any(1).sum())
    else:  # wl: a row has entries where its length is not 0
        n_y = int((b.row_len > 0).sum())
    return int(real.sum()), int(torch.unique(cols[real]).numel()), n_y


def bound(nnz: int, n_x: int, n_y: int, rhs: int, value_bytes: int,
          col_bytes: int) -> tuple:
    """``(ms, bound_by)``: the least time of the bin's SpMM at ``rhs``."""
    moved = nnz * (value_bytes + col_bytes) + rhs * 4 * (n_x + n_y)
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * nnz * rhs / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def sweep(name: str, rhs_list, dev) -> None:
    make, layout = MATRICES[name]
    t0 = time.perf_counter()
    csr = CSRMatrix.from_coo(make())
    d = S.device_put_sell(SellMatrix.from_csr(csr, layout=layout),
                          device=dev)
    print(f"[{name}] {csr.nrows} rows, {csr.nnz} nnz; bins "
          f"{[(b.layout, b.k, b.n_groups) for b in d.bins]}; set-up "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    counts = [bin_counts(b) for b in d.bins]
    gen = torch.Generator(device=dev).manual_seed(0)
    for rhs in rhs_list:
        X = torch.randn(csr.ncols, rhs, device=dev, generator=gen)
        xt = SM.pack_x_multi(X, csr.ncols)
        y = SM._rhs_buffer(d.num_groups * 1024, rhs, dev)
        for i, (b, (nnz, n_x, n_y)) in enumerate(zip(d.bins, counts)):
            kernel = SM._KERNEL[b.layout]
            ms = device_time_fn(kernel, b, xt, y, device=dev) * 1e3
            lo, by = bound(nnz, n_x, n_y, rhs, b.as_.element_size(),
                           2 if b.layout == "wl" else 4)
            print(json.dumps({
                "matrix": name, "bin": i, "layout": b.layout, "k": b.k,
                "groups": b.n_groups, "nw": b.nw, "L": b.span, "rhs": rhs,
                "nnz": nnz, "ms": ms, "bound_ms": lo, "bound_by": by,
                "share": lo / ms}), flush=True)
        ms = device_time_fn(SM.sell_spmm, d, X, device=dev) * 1e3
        print(json.dumps({"matrix": name, "sell_spmm_raw_x": True,
                          "rhs": rhs, "ms": ms}), flush=True)
        del X, xt, y
    del d
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--rhs", "--matrices"}:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("spmm_sweep: torch.cuda.is_available() is false: the sweep "
              "times the CUDA kernels", file=sys.stderr)
        return 1
    rhs_list = [int(r) for r in opts.get("--rhs", "1,4,8,16,32").split(",")]
    names = opts.get("--matrices", ",".join(MATRICES)).split(",")
    dev = torch.device("cuda", 0)
    _build.load()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip(), flush=True)
    for name in names:
        sweep(name, rhs_list, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
