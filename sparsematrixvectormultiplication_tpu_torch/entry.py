"""The entry points (≙ the JAX repo's ``__graft_entry__.py``).

* :func:`entry` returns ``(fn, args)``: one SELL SpMV forward step, the
  k-major kernel on ``banded(8192, 24, 512)`` with x = 1;
* :func:`dryrun_multichip` runs one step of each sharded path of
  ``parallel/`` on ``n`` ranks (``parallel.launch.spawn``) and checks each
  rank's y against the fp64 host y.

Both run on the card unless the caller asks for the CPU (``device="cpu"``,
``device_type="cpu"``), where the wrappers run the kernels' plain versions;
without CUDA they raise. From the command line::

    python -m sparsematrixvectormultiplication_tpu_torch.entry [n] [--device cpu]

runs ``dryrun_multichip(n)`` (default 8): one NCCL rank a card where there
are ``n`` cards, else gloo ranks sharing them.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip", "device_or_raise", "DRYRUN_PATHS",
           "main"]

RTOL = ATOL = 1e-4  # the JAX dryrun's allclose, against the fp64 host y

# path -> the public function of parallel/ it runs, in the JAX dryrun's order
DRYRUN_PATHS = {
    "ell_rows": "row_sharded_spmv",
    "sell_rows": "sell_spmv_spmd",
    "bsr_spmm": "bsr_spmm_spmd",
    "sell_spmm": "sell_spmm_spmd",
    "pr": "pr_spmv_spmd",
    "split": "split_spmv_spmd",
    "sell_cols": "sell_spmv_spmd_cols",
    "ell_2d": "sharded_spmv_2d",
}
# the kernel groups (bench.scale's launch counters) each path must launch on
# the card; the ELL paths are plain PyTorch
_KERNEL_GROUPS = {"sell_rows": ("sell",), "bsr_spmm": ("bsr",),
                  "sell_spmm": ("spmm",), "pr": ("pr",),
                  "split": ("sell", "pr"), "sell_cols": ("sell",)}


def device_or_raise(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    (the entry points never carry on on the CPU unless asked to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: torch.cuda.is_available() is "
                           "false; pass device='cpu' for the plain versions "
                           "on the CPU")
    return device


def entry(device="cuda"):
    """Returns ``(fn, (dsell, x))``: ``fn`` is ``ops.sell.sell_spmv``, the
    SELL of ``banded(8192, 24, 512, seed=0)`` (one k-major bin) uploaded
    with f32 values and x = 1 as its padded x table."""
    from .formats.csr import CSRMatrix
    from .formats.sell import SellMatrix
    from .models.synthetic import banded
    from .ops.sell import device_put_sell, device_put_x, sell_spmv

    device = device_or_raise(device)
    coo = banded(8192, 24, 512, seed=0)
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(coo))
    dsell = device_put_sell(sell, dtype=torch.float32, device=device)
    x = device_put_x(np.ones(coo.ncols, np.float32), coo.ncols, device=device)
    return sell_spmv, (dsell, x)


def _dryrun_inputs(n: int) -> dict:
    """The JAX dryrun's inputs for ``n`` devices, from its seeds: the
    banded matrix, x (f32) and X (x tiled to 8 columns), and the split
    path's band-plus-tail matrix and its x."""
    from .formats.coo import COOMatrix
    from .models.synthetic import banded

    coo = banded(4096, 12, 256, seed=0)
    x = np.random.default_rng(0).standard_normal(coo.ncols).astype(np.float32)
    X = np.tile(x[:, None], (1, 8))
    rng = np.random.default_rng(3)
    ns = n * 1024
    band = banded(ns, 3, 60, seed=3)
    nf = band.row.size // 20
    coo_s = COOMatrix(
        ns, ns,
        np.concatenate([band.row, rng.integers(0, ns, nf).astype(np.int32)]),
        np.concatenate([band.col, rng.integers(0, ns, nf).astype(np.int32)]),
        np.concatenate([band.val, rng.standard_normal(nf)]),
    )
    return {"coo": coo, "x": x, "X": X, "coo_split": coo_s,
            "x_split": rng.standard_normal(ns)}


def _mesh_2d(n: int) -> tuple:
    """The JAX dryrun's 2-D mesh, and why it does not run (None if it
    does): rows x cols with rows = max(1, n // 2)."""
    rows = max(1, n // 2)
    cols = n // rows
    if cols == 1:
        return (rows, cols), (f"n={n} gives a {rows}x{cols} mesh: no column "
                              "axis to reduce over")
    if rows * cols != n:
        return (rows, cols), (f"a {rows}x{cols} mesh covers {rows * cols} "
                              f"of the {n} ranks")
    return (rows, cols), None


def _rel_err(y, ref) -> float:
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300))


def _dryrun_rank(device, paths) -> list:
    """One rank of :func:`dryrun_multichip`: each ``(name, job, y_ref)``
    through ``bench.scale.run_shard_jobs``, its y (column 0 of an SpMM)
    held against ``y_ref`` with the JAX dryrun's allclose. Returns per path
    the rank's y, backend and launches."""
    from .bench.scale import run_shard_jobs

    out = []
    recs = run_shard_jobs(device, [job for _, job, _ in paths])
    for (name, _, ref), rec in zip(paths, recs):
        y = rec["y"][:, 0] if rec["y"].ndim == 2 else rec["y"]
        if y.shape != ref.shape:
            raise RuntimeError(f"dryrun path {name} ({DRYRUN_PATHS[name]}): "
                               f"y of shape {y.shape}, the fp64 host y's "
                               f"{ref.shape}")
        if not np.allclose(y, ref, rtol=RTOL, atol=ATOL):
            raise RuntimeError(
                f"dryrun path {name} ({DRYRUN_PATHS[name]}): y differs from "
                f"the fp64 host y beyond rtol=atol={RTOL} (max|y - y_ref| / "
                f"max|y_ref| {_rel_err(y, ref):.3e})")
        out.append({"y": rec["y"], "backend": rec["backend"],
                    "launches": rec["launches"]})
    return out


def dryrun_multichip(n_devices: int, device_type: str = "cuda", *,
                     log=print) -> list:
    """One step of each sharded path of ``parallel/`` on ``n_devices``
    spawned ranks, on the JAX dryrun's inputs (:func:`_dryrun_inputs`):
    row-sharded ELL, row-sharded SELL, BSR SpMM and k-major SELL SpMM over
    8 columns, PR panels, the locality split, column-sharded SELL and the
    2-D ELL on the JAX dryrun's rows x cols mesh. The backend is
    ``launch.backend_for``'s: NCCL when every rank has a card of its own,
    gloo for CPU ranks and ranks sharing a card.

    Every rank holds each path's y against the fp64 host y (rtol = atol =
    1e-4, column 0 of an SpMM) and raises where it differs; every rank must
    return the same y, and on the card each path but the ELL ones must
    launch its kernels. Returns one dict per path in the JAX order:
    ``path``, ``function``, ``status`` ("ok" or "skipped"), and for a path
    that ran ``backend``, ``ranks``, ``mesh``, ``rel_err`` (max|y - y_ref| /
    max|y_ref|) and ``launches`` (the ranks' summed kernel launches, keyed
    as ``bench.scale`` counts them), for one that did not its ``reason``.
    The 2-D ELL path runs only where the mesh has a column axis and covers
    every rank, and is reported as skipped otherwise."""
    from .bench.scale import ShardJob, for_rank
    from .formats.bsr import BSRMatrix
    from .formats.csr import CSRMatrix
    from .formats.hll import HLLMatrix
    from .parallel.launch import backend_for, spawn
    from .parallel.spmd_bsr import shard_bsr
    from .parallel.spmd_colsell import build_spmd_sell_cols
    from .parallel.spmd_pallas import build_spmd_sell
    from .parallel.spmd_pr import build_spmd_pr
    from .parallel.spmd_split import build_spmd_split

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices {n_devices} < 1")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device type {device_type!r}: cuda or cpu")
    if device_type == "cuda":
        device_or_raise("cuda")
        from .ops import _build

        _build.load()   # built once here; the ranks only load it
    inp = _dryrun_inputs(n)
    csr = CSRMatrix.from_coo(inp["coo"])
    hll = HLLMatrix.from_coo(inp["coo"])
    csr_s = CSRMatrix.from_coo(inp["coo_split"])
    x, X = inp["x"], inp["X"]
    y_ref = csr.spmv(x.astype(np.float64))
    mesh2, why_not_2d = _mesh_2d(n)
    jobs = {
        "ell_rows": ShardJob("ell_rows", hll, x, (n,), dtype=torch.float32),
        "sell_rows": ShardJob("sell", build_spmd_sell(csr, n), x, (n,)),
        "bsr_spmm": ShardJob("bsr", shard_bsr(BSRMatrix.from_csr(csr), n),
                             X, (n,)),
        "sell_spmm": ShardJob("sell_spmm", build_spmd_sell(
            csr, n, sell_kwargs={"layout": "k-major"}), X, (n,)),
        "pr": ShardJob("pr", build_spmd_pr(csr, n, target_rows=1 << 13), x,
                       (n,)),
        "split": ShardJob("split", build_spmd_split(csr_s, n, slab_dist=1),
                          inp["x_split"], (n,)),
        "sell_cols": ShardJob("sell_cols", build_spmd_sell_cols(csr, n), x,
                              (n,), ("cols",)),
    }
    if why_not_2d is None:
        jobs["ell_2d"] = ShardJob("ell_2d", hll, x, mesh2, ("rows", "cols"),
                                  dtype=torch.float32)
    refs = {name: y_ref for name in jobs}
    refs["split"] = csr_s.spmv(inp["x_split"])
    backend = backend_for(device_type, n)
    out = spawn(_dryrun_rank, n, device_type=device_type, timeout_s=600,
                rank_args=[([(name, dataclasses.replace(
                    job, obj=for_rank(job.obj, r)), refs[name])
                    for name, job in jobs.items()],) for r in range(n)])

    where = (torch.cuda.get_device_name(0) if device_type == "cuda"
             else "cpu")
    summary = []
    for name, function in DRYRUN_PATHS.items():
        if name not in jobs:
            summary.append({"path": name, "function": function,
                            "status": "skipped", "reason": why_not_2d})
            log(f"dryrun_multichip({n}) {function}: skipped ({why_not_2d})")
            continue
        j = list(jobs).index(name)
        recs = [o[j] for o in out]
        if any(not np.array_equal(r["y"], recs[0]["y"]) for r in recs):
            raise RuntimeError(f"dryrun path {name} ({function}): the ranks "
                               "returned different y")
        if {r["backend"] for r in recs} != {backend}:
            raise RuntimeError(f"dryrun path {name}: ran on "
                               f"{sorted({r['backend'] for r in recs})}, not "
                               f"{backend}")
        launches = {}
        for r in recs:
            for key, v in r["launches"].items():
                launches[key] = launches.get(key, 0) + v
        if device_type == "cuda":
            idle = [g for g in _KERNEL_GROUPS.get(name, ())
                    if not any(v for (grp, _), v in launches.items()
                               if grp == g)]
            if idle:
                raise RuntimeError(f"dryrun path {name} ({function}): no "
                                   f"{'/'.join(idle)} kernel was launched")
        y = recs[0]["y"]
        err = _rel_err(y[:, 0] if y.ndim == 2 else y, refs[name])
        mesh = jobs[name].mesh_shape
        summary.append({"path": name, "function": function, "status": "ok",
                        "backend": backend, "ranks": n, "mesh": mesh,
                        "rel_err": err, "launches": launches})
        log(f"dryrun_multichip({n}) {function}: OK on {n} {backend} "
            f"rank(s), mesh {'x'.join(map(str, mesh))}, every rank the same "
            f"y, max|y - y_ref| / max|y_ref| {err:.3e}; launches "
            f"{ {f'{g} {k}': v for (g, k), v in sorted(launches.items())} }")
    ran = [s["function"] for s in summary if s["status"] == "ok"]
    log(f"dryrun_multichip({n}): OK on {where} ({n} {backend} rank(s)): "
        f"{' + '.join(ran)}"
        + (f"; 2-D ELL skipped ({why_not_2d})" if why_not_2d else
           f" ({mesh2[0]}x{mesh2[1]} psum)"))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m sparsematrixvectormultiplication_tpu_torch.entry",
        description="dryrun_multichip(n): one step of every sharded path "
                    "on n ranks")
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="ranks (default 8)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; ranks beyond the cards share them "
                        "over gloo) or cpu (gloo CPU ranks, plain versions)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    # the package's module, not __main__: spawned ranks import the rank
    # function by its module's name
    from sparsematrixvectormultiplication_tpu_torch.entry import main as _main

    sys.exit(_main())
