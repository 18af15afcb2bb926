"""Device times of whole SELL SpMVs, f32, bf16 and double-double, of this
package and, in the same process and on the same card, of an older checkout.

Run on a machine with a CUDA card::

    python -m sparsematrixvectormultiplication_tpu_torch.bench.spmv_ab \\
        [--parent DIR] [--matrices headline,banded,...] [--rounds N]

``--parent DIR`` names an unpacked older checkout (``DIR`` holds its
``sparsematrixvectormultiplication_tpu_torch``): its package is imported
under another name, builds its own kernels under ``DIR/build``, and the
turns run parent, this, this, parent on the same host matrices (converted
once, by this package). The SpMVs, converted with ``SellMatrix.from_csr``'s
defaults as the harness's ``sell`` stages convert them:

* ``headline`` ``fem_3d(60, 60, 60, dof=3, seed=1)``, ``banded``
  ``banded(250_000, 60, 2500, seed=1)``, ``road``
  ``road_network(1_200_000, seed=1)``: the flagship line's three matrices;
* ``entry`` ``banded(8192, 24, 512, seed=0)`` and ``mixed`` ``fem_3d(20,
  20, 20, dof=3, seed=1)``, ``uniform`` ``random_general(200_000, 200_000,
  2.5e-4, seed=8)``: the smoke's phases of those names;
* ``panels`` ``fem_3d(10, 10, 10, dof=3, seed=0)`` in 1024-column panels
  (``panel_sell_spmv``), the smoke's panel phase.

One JSON line per turn, matrix and value type on stdout: the SpMV's device
time (``device_time_fn``, calls back to back, the best of ``--rounds``),
the kernel launches one call made (the SELL wrappers' and panel_reduce's
counts), the launches the tree's ``sell_spmv_launches`` /
``sell_spmv_dd_launches`` reports where it takes the object, the bins, the
matrix's bound (every entry's value and 4-byte column, every column read
and every row of y, per x table, over 3.35 TB/s), cuSPARSE's CSR SpMV on
the same matrix (``torch.sparse_csr_tensor @ x``, int32 indices; f32 for
the f32 and bf16 rows, fp64 for dd), a yardstick the package never calls,
the upload's peak device bytes beyond what was allocated before it
(``max_memory_allocated``), the plan's own tables where the tree has one,
and the norm-scaled error against the fp64 oracle. A table of the turns
goes to stderr.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.sell import PanelSellMatrix, SellMatrix
from ..models.synthetic import banded, fem_3d, random_general, road_network
from ..utils.timing import MAX_QUEUED_LAUNCHES, device_time_fn

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
PKG = "sparsematrixvectormultiplication_tpu_torch"
MATRICES = {
    "headline": lambda: fem_3d(60, 60, 60, dof=3, seed=1),
    "banded": lambda: banded(250_000, 60, 2500, seed=1),
    "road": lambda: road_network(1_200_000, seed=1),
    "entry": lambda: banded(8192, 24, 512, seed=0),
    "mixed": lambda: fem_3d(20, 20, 20, dof=3, seed=1),
    "uniform": lambda: random_general(200_000, 200_000, 2.5e-4, seed=8),
    "panels": lambda: fem_3d(10, 10, 10, dof=3, seed=0),
}
PRECISIONS = ("f32", "bf16", "dd")


def _tree(name: str, root: Path | None):
    """The ``ops.sell`` and ``ops.sell_dd`` modules of this package, or of
    the package under ``root`` imported as ``name``."""
    if root is None:
        pkg = PKG
    else:
        pkg = name
        spec = importlib.util.spec_from_file_location(
            name, root / PKG / "__init__.py",
            submodule_search_locations=[str(root / PKG)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return (importlib.import_module(f"{pkg}.ops.sell"),
            importlib.import_module(f"{pkg}.ops.sell_dd"))


def _bound_ms(csr, value_bytes: int, tables: int) -> float:
    n_x = int(np.unique(csr.col_idx).size)
    moved = csr.nnz * (value_bytes + 4) + (n_x + csr.nrows) * 4 * tables
    return moved / HBM_BYTES_PER_S * 1e3


def _cusparse_ms(csr, x, dtype, dev) -> float:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.row_ptr.astype(np.int32)),
            torch.from_numpy(csr.col_idx.astype(np.int32)),
            torch.from_numpy(csr.values).to(dtype), size=csr.shape,
            device=dev, check_invariants=False)
        xv = torch.from_numpy(x).to(dtype).to(dev)
        return device_time_fn(lambda: A @ xv, device=dev) * 1e3


def _launch_counters(S, D) -> list:
    ws = [*S._KERNEL.values(), *D._KERNEL_DD.values()]
    return ws + [w for w in (getattr(S, "panel_reduce", None),
                             getattr(D, "panel_reduce_dd", None)) if w]


def _spmv(S, D, host, x, precision, dev, panels: bool):
    """Upload ``host`` with tree (S, D), returning the device object, its
    upload peak and the SpMV's call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    if precision == "dd":
        d = D.device_put_sell_dd(host, device=dev)
    else:
        d = S.device_put_sell(host, torch.bfloat16 if precision == "bf16"
                              else torch.float32, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    if precision == "dd":
        halves = [torch.from_numpy(h).float().to(dev) for h in (
            x, x - x.astype(np.float32).astype(np.float64))]
        if panels:
            return d, peak, lambda: D.panel_sell_spmv_dd(d, *halves)
        tabs = [S.pack_x_table(h, host.ncols) for h in halves]
        return d, peak, lambda: D.sell_spmv_dd(d, *tabs)
    xf = torch.from_numpy(x.astype(np.float32)).to(dev)
    if panels:
        return d, peak, lambda: (S.panel_sell_spmv(d, xf),)
    tab = S.pack_x_table(xf, host.ncols)
    return d, peak, lambda: (S.sell_spmv(d, tab),)


def _api_launches(S, D, d, precision):
    try:
        return (D.sell_spmv_dd_launches(d) if precision == "dd"
                else S.sell_spmv_launches(d))
    except (AttributeError, TypeError):  # a tree that counts no panels
        return None


def run(matrices, parent: Path | None, rounds: int, dev, emit, log):
    trees = {"this": _tree("this", None)}
    order = ["this"]
    if parent is not None:
        trees["parent"] = _tree("spmv_ab_parent", parent)
        order = ["parent", "this", "this", "parent"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    table = {}
    for name in matrices:
        csr = CSRMatrix.from_coo(MATRICES[name]())
        panels = name == "panels"
        host = (PanelSellMatrix.from_csr(csr, max_panel_cols=1024) if panels
                else SellMatrix.from_csr(csr))
        x = np.random.default_rng(0).standard_normal(csr.ncols)
        ref = csr.spmv(x)
        ref32 = csr.spmv(x.astype(np.float32).astype(np.float64))
        lib = {dt: _cusparse_ms(csr, x, dt, dev)
               for dt in (torch.float32, torch.float64)}
        n_bins = (sum(len(p.bins) for p in host.panels) if panels
                  else len(host.bins))
        for turn, tree in enumerate(order):
            S, D = trees[tree]
            counters = _launch_counters(S, D)
            for precision in PRECISIONS:
                d, peak, call = _spmv(S, D, host, x, precision, dev, panels)
                before = sum(w.launches for w in counters)
                y = call()
                torch.cuda.synchronize()
                launched = sum(w.launches for w in counters) - before
                got = (y[0].double() + y[1].double() if precision == "dd"
                       else y[0].double()).cpu().numpy()
                want = ref if precision == "dd" else ref32
                err = float(np.abs(got - want).max() / np.abs(want).max())
                api = _api_launches(S, D, d, precision)
                reps = max(1, min(20, MAX_QUEUED_LAUNCHES // max(
                    api or launched + 3, 1)))
                ms = min(device_time_fn(call, device=dev, reps=reps)
                         for _ in range(rounds)) * 1e3
                plan = getattr(d, "plan", None)
                rec = {
                    "tree": tree, "turn": turn, "matrix": name,
                    "precision": precision, "ms": ms,
                    "kernel_launches": launched, "launches": api,
                    "bins": n_bins, "bound_ms": _bound_ms(
                        csr, {"f32": 4, "bf16": 2, "dd": 8}[precision],
                        2 if precision == "dd" else 1),
                    "cusparse_ms": lib[torch.float64 if precision == "dd"
                                       else torch.float32],
                    "upload_peak_bytes": peak,
                    "plan_bytes": S.plan_bytes(d) if plan is not None
                    else None,
                    "norm_err": err, "card": smi}
                emit(json.dumps(rec))
                table.setdefault((name, precision), []).append(
                    (tree, ms, launched))
                del d, call, y
                torch.cuda.empty_cache()
    for (name, precision), turns in table.items():
        log(f"{name:9s} {precision:4s} " + "  ".join(
            f"{tree} {ms:.4f} ms ({n} launches)" for tree, ms, n in turns))
    log(smi)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--parent", "--matrices", "--rounds"}:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("spmv_ab times the card: no CUDA device", file=sys.stderr)
        return 2
    names = opts.get("--matrices", ",".join(MATRICES)).split(",")
    unknown = set(names) - set(MATRICES)
    if unknown:
        print(f"unknown matrices {sorted(unknown)}", file=sys.stderr)
        return 2
    parent = Path(opts["--parent"]).resolve() if "--parent" in opts else None
    run(names, parent, int(opts.get("--rounds", 3)),
        torch.device("cuda", 0), lambda line: print(line, flush=True),
        lambda m: print(m, file=sys.stderr, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
