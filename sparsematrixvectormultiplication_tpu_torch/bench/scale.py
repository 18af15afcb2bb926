"""Scaling-axis sweeps — the reference's thread-count dimension on GPUs.

The reference sweeps OpenMP thread counts {2,4,8,16,32,40} per matrix and
reports speedup/efficiency columns (main.c:18,172-459; 33-column CSV
src/utility.c:114-120). The axes here:

* **device count** — the sharded paths of ``parallel/`` over 1..N ranks
  (:func:`run_device_scale_sweep`, :func:`run_path_scale_sweep`,
  :func:`run_spmm_device_scale_sweep`); speedup/efficiency against the
  1-rank time, one openmp-schema row per count (``num_threads`` = the
  device count). Each count spawns its ranks (``parallel/launch.py``): one
  per GPU with NCCL, or gloo CPU ranks (``device="cpu"``, the plain
  versions) where no multi-GPU machine is at hand.
* **K-bin ladder** — the launch-configuration axis (finer bins = less
  padding, more kernel launches); one native-schema row per ladder
  (:func:`run_ladder_sweep`; ≙ the reference's logged block-size choices,
  cuda_src/utility.cu:236).

:func:`run_shard_jobs` is what every rank runs: it uploads its shard of a
host-built sharded matrix (:class:`ShardJob`), computes the global y
through the path's public function and, when asked, times the rank's own
kernels, the collective and the whole call.
"""

# Ported from sparsematrixvectormultiplication_tpu/bench/scale.py (the port
# must not import the JAX package).

from __future__ import annotations

import dataclasses
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..formats.bsr import BSRMatrix
from ..formats.csr import CSRMatrix
from ..formats.hll import HLLMatrix
from ..formats.sell import SellMatrix
from ..ops import bsr as _bsr
from ..ops import pr as _pr
from ..ops import sell_spmm as _spmm
from ..ops.bsr import bsr_spmm, pad_rhs
from ..ops.sell import (_KERNEL, device_put_sell, device_put_x, sell_spmv,
                        sell_spmv_launches, sell_spmv_plain)
from ..ops.sell_spmm import device_put_x_multi, sell_spmm
from ..parallel import sharding as _sh
from ..parallel.launch import spawn
from ..parallel.spmd_bsr import SpmdBSR, bsr_spmm_spmd, shard_bsr
from ..parallel.spmd_colsell import (SpmdColSell, _local_cols,
                                     build_spmd_sell_cols, pack_x_cols,
                                     sell_spmv_spmd_cols)
from ..parallel.spmd_pallas import (SpmdSell, build_spmd_sell,
                                    sell_spmm_spmd, sell_spmv_spmd)
from ..parallel.spmd_pr import (SpmdPR, _local_pr, _unpermute, build_spmd_pr,
                                pr_spmv_spmd)
from ..parallel.spmd_split import (SpmdSplit, _local_split, build_spmd_split,
                                   split_spmv_spmd)
from ..tune.autotune import DEFAULT_LADDERS
from ..utils.metrics import calculate_flops
from ..utils.timing import MAX_QUEUED_LAUNCHES, device_time_fn, time_fn
from ..utils.validation import (DEFAULT_ABS_TOL, DEFAULT_REL_TOL,
                                difference_metrics, sampled_spmm_metrics)
from .csv_report import (NATIVE_HEADER, OPENMP_HEADER, _append_row, _fmt,
                         _stream_columns)
from .harness import DTYPES, device_bytes, quantize_bf16

__all__ = ["run_device_scale_sweep", "run_spmm_device_scale_sweep",
           "run_path_scale_sweep", "run_ladder_sweep", "ShardJob",
           "run_shard_jobs", "for_rank", "shard_loads", "SHARD_PATHS"]


def run_ladder_sweep(
    name: str,
    csr: CSRMatrix,
    out_csv: str,
    *,
    dtype=torch.float32,
    iterations: int = 32,
    rounds: int = 2,
    x: np.ndarray | None = None,
    log=print,
    device="cuda",
):
    """Time ``sell`` under each K-bin ladder of ``DEFAULT_LADDERS`` on
    ``device``; append one native-schema row per ladder to ``out_csv`` with
    stage ``sell@<ladder>``, the bytes of the tensors the SpMV ran on and,
    on a CUDA device, their share of the card's copy rate. Returns
    ``[(ladder, seconds, gflops, DiffMetrics)]``.

    The time is the best of ``rounds`` device times of ``iterations`` calls
    back to back (the CPU: host medians). A ladder whose conversion raises
    ``ValueError`` or ``MemoryError`` costs its row; a launch error raises.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ladder_sweep times on a CUDA device and none "
                           "is available; pass device='cpu' to run on the "
                           "CPU")
    if x is None:
        x = np.ones(csr.ncols, dtype=np.float64)
    y_ref = csr.spmv(x)
    if dtype == torch.bfloat16:  # the oracle of the bf16-rounded values
        y_ref = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                          quantize_bf16(csr.values)).spmv(x)
    xt = device_put_x(x, csr.ncols, device=device)
    dt_name = {v: k for k, v in DTYPES.items()}[dtype]
    arith = {"float32": "fp32", "bfloat16": "bf16"}[dt_name]

    # the harness's heavy-row split: rows past the cap would make K > 1024
    # bins, which the JAX sweep once fed the kernels unsplit
    nrows_nat = csr.nrows
    med_nnz = float(np.median(csr.row_nnz())) if nrows_nat else 0.0
    split_cap = 16 if med_nnz <= 24 else 256
    csr, seg_map = csr.split_heavy_rows(split_cap, strided=split_cap < 256)
    if seg_map is not None:
        log(f"[{name}] ladders: split heavy rows {nrows_nat} -> {csr.nrows} "
            f"(cap {split_cap})")

    def _to_natural(y_k):
        if seg_map is None:
            return y_k[:nrows_nat]
        return np.bincount(np.asarray(seg_map), weights=y_k,
                           minlength=nrows_nat)[:nrows_nat]

    def _seconds(dsell):
        if device.type == "cuda":
            reps = max(1, min(iterations,
                              MAX_QUEUED_LAUNCHES
                              // sell_spmv_launches(dsell)))
            return min(device_time_fn(sell_spmv, dsell, xt, device=device,
                                      reps=reps) for _ in range(rounds))
        return min(time_fn(sell_spmv, dsell, xt, device=device,
                           reps=iterations) for _ in range(rounds))

    out = []
    for ladder, k_bins in DEFAULT_LADDERS.items():
        t0 = time.perf_counter()
        try:
            sell = SellMatrix.from_csr(csr, k_bins=k_bins)
        except (ValueError, MemoryError) as e:
            log(f"[{name}] ladder {ladder}: conversion refused: "
                f"{type(e).__name__}: {str(e)[:300]}")
            continue
        conv_s = time.perf_counter() - t0
        dsell = device_put_sell(sell, dtype, device=device)
        y = sell_spmv(dsell, xt)
        nbytes = device_bytes(dsell, xt, y)
        y = y.cpu().numpy().astype(np.float64)
        dm = difference_metrics(y_ref, _to_natural(y[: csr.nrows]))
        sec = _seconds(dsell)
        gf = calculate_flops(csr.nnz, sec) / 1e9
        log(f"[{name}] sell@{ladder}: {sec*1e3:.4f} ms = {gf:.3f} GFLOPS "
            f"on {device} (pad {sell.padding_ratio:.2f}, {len(sell.bins)} "
            f"bins, {nbytes} B, sig_diffs={dm.significant_diffs}; "
            f"conversion {conv_s:.1f} s)")
        per_nnz, pct = _stream_columns(nbytes, csr.nnz, sec,
                                       device.type == "cuda")
        _append_row(
            out_csv, NATIVE_HEADER,
            [name, nrows_nat, csr.ncols, csr.nnz, f"sell@{ladder}",
             dt_name, arith, _fmt(sec), f"{gf:.6f}", "",
             f"{dm.mean_rel_err:.15e}", dm.significant_diffs,
             f"{dm.max_abs_err:.15e}", f"{dm.max_rel_err:.15e}",
             f"{sell.padding_ratio:.6f}", per_nnz, pct],
        )
        out.append((ladder, sec, gf, dm))
        del sell, dsell
    return out


# ---------------------------------------------------------------------------
# the device-count axis: what each rank runs, and the sweeps over it
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Path:
    """A sharded path, in the pieces a rank times apart: ``upload(obj,
    mesh, dtype)`` -> this rank's state; ``prep(state, x, mesh)`` -> x on
    its device in the kernels' layout; ``local(state, xd)`` -> its own
    result, no collective; ``collect(state, y_loc, mesh)`` -> the global
    result; ``public(obj, state, x, mesh)``: the path's public function,
    from a host x to the global result."""

    upload: object
    prep: object
    local: object
    collect: object
    public: object


def _dev(mesh):
    return _sh._mesh_device(mesh)


def _group(mesh, st):
    return _sh._axis(mesh, st.axis)[2]


def _ell_x(st, x, mesh):
    return _sh._x_on(x, _dev(mesh), st.as_.dtype if st.as_.dtype
                     == torch.float64 else torch.float32)


SHARD_PATHS = {
    "sell": _Path(
        lambda o, m, dt: o.upload(m),
        lambda st, x, m: device_put_x(x, st.ncols, device=_dev(m)),
        lambda st, xd: sell_spmv(st.local, xd),
        lambda st, y, m: _sh._gather_rows(y, st.shard_rows, _group(m, st)),
        lambda o, st, x, m: sell_spmv_spmd(st, x, m)),
    "sell_spmm": _Path(
        lambda o, m, dt: o.upload(m),
        lambda st, x, m: device_put_x_multi(np.asarray(x), st.ncols,
                                            device=_dev(m)),
        lambda st, xd: sell_spmm(st.local, xd),
        lambda st, y, m: _sh._gather_rows(y, st.shard_rows, _group(m, st)),
        lambda o, st, x, m: sell_spmm_spmd(st, x, m)),
    "pr": _Path(
        lambda o, m, dt: o.upload(m),
        lambda st, x, m: device_put_x(x, st.ncols, device=_dev(m)),
        _local_pr,
        lambda st, y, m: _unpermute(st, _sh._gather_rows(
            y, [st.pps * st.y_len] * st.n_shards, _group(m, st))),
        lambda o, st, x, m: pr_spmv_spmd(st, x, m)),
    "split": _Path(
        lambda o, m, dt: o.upload(m),
        lambda st, x, m: device_put_x(x, st.ncols, device=_dev(m)),
        _local_split,
        lambda st, y, m: _sh._gather_rows(y, st.near.shard_rows,
                                          _group(m, st)),
        lambda o, st, x, m: split_spmv_spmd(st, x, m)),
    "sell_cols": _Path(
        lambda o, m, dt: o.upload(m),
        pack_x_cols,
        _local_cols,
        lambda st, y, m: _sh._sum_over(y, _group(m, st)),
        lambda o, st, x, m: sell_spmv_spmd_cols(st, x, m)),
    "bsr": _Path(
        lambda o, m, dt: o.upload(m),
        lambda st, x, m: pad_rhs(x, st.ncols, st.local.blocks.dtype,
                                 device=_dev(m)),
        lambda st, xd: bsr_spmm(st.local, xd),
        lambda st, y, m: _sh._gather_rows(y, st.shard_rows, _group(m, st)),
        lambda o, st, x, m: bsr_spmm_spmd(st, x, m)),
    "ell_rows": _Path(
        lambda o, m, dt: _sh.shard_ell_rows(o, m, dtype=dt),
        _ell_x,
        _sh._local_rows_ell,
        _sh._collect_rows_ell,
        lambda o, st, x, m: _sh.row_sharded_spmv(st, x, m)),
    "ell_2d": _Path(
        lambda o, m, dt: _sh.shard_ell_2d(o, m, dtype=dt),
        _sh._x_slice_2d,
        _sh._local_2d,
        _sh._collect_2d,
        lambda o, st, x, m: _sh.sharded_spmv_2d(st, x, m)),
    "ell_cols": _Path(
        lambda o, m, dt: _sh.shard_ell_2d(o, m, dtype=dt),
        _sh._x_slice_2d,
        _sh._local_2d,
        _sh._collect_2d,
        lambda o, st, x, m: _sh.col_sharded_spmv(o, x, m, dtype=st.as_.dtype)),
}


@dataclass(frozen=True)
class ShardJob:
    """One sharded path for every rank of a :func:`run_shard_jobs` call.

    ``obj`` is the host build (``build_spmd_sell(..., mesh=None)`` and its
    siblings; an ``HLLMatrix`` for the ELL paths), or its rank's part
    (:func:`for_rank`); ``x`` the host x, or X for ``sell_spmm`` and
    ``bsr``; ``dtype`` the ELL paths' value type (None: the host's).
    ``reps > 0`` times the whole call (``call_s``: device time behind
    NCCL, else the median of ``reps`` calls, the best of ``rounds``);
    ``detail`` also times, with the ranks in turn, each rank's own kernels
    (``local_s``), then together the collective alone (``collective_s``)
    and the host wall of one call (``wall_s``). ``check_plain`` (``sell``)
    holds the rank's kernels against their plain versions."""

    path: str
    obj: object
    x: np.ndarray
    mesh_shape: tuple
    mesh_dims: tuple = ("rows",)
    dtype: object = None
    reps: int = 0
    rounds: int = 1
    detail: bool = False
    check_plain: bool = False


def for_rank(obj, r: int):
    """A host build with every shard but rank ``r``'s dropped: what rank
    ``r`` of a :func:`run_shard_jobs` call needs of it."""
    def keep(items, own):
        return [v if i in own else None for i, v in enumerate(items)]

    if isinstance(obj, SpmdSplit):
        return dataclasses.replace(obj, near=for_rank(obj.near, r),
                                   far=keep(obj.far, (r,)))
    if isinstance(obj, SpmdPR):
        return dataclasses.replace(obj, panels=keep(
            obj.panels, range(r * obj.pps, (r + 1) * obj.pps)))
    if isinstance(obj, (SpmdSell, SpmdBSR, SpmdColSell)):
        return dataclasses.replace(obj, shards=keep(obj.shards, (r,)))
    return obj


def shard_loads(obj) -> list:
    """The entries each shard of a host build holds."""
    if isinstance(obj, SpmdSplit):
        return [a + int(p.nnz) for a, p in zip(shard_loads(obj.near),
                                               obj.far)]
    if isinstance(obj, SpmdPR):
        return [sum(int(p.nnz) for p in obj.panels[i:i + obj.pps])
                for i in range(0, len(obj.panels), obj.pps)]
    return [int(s.nnz) for s in obj.shards]


def _counters() -> dict:
    """Every kernel wrapper's launch count in this process."""
    c = {("sell", lay): w.launches for lay, w in _KERNEL.items()}
    c.update({("sell accumulating", lay): w.accumulating
              for lay, w in _KERNEL.items()})
    c.update({("spmm", lay): w.launches for lay, w in (
        ("k-major", _spmm.k_major_spmm_bin), ("wl", _spmm.wl_spmm_bin))})
    c["pr", "pr"] = _pr.pr_problem.launches - _pr.pr_problem.launches_bf16
    c["pr", "pr_bf16"] = _pr.pr_problem.launches_bf16
    c.update({("bsr", r): w.launches for r, w in _bsr.ROUTES.items()})
    return c


def _held_bytes(st) -> int:
    """Bytes of the tensors a rank's state holds on its device."""
    return device_bytes(st, getattr(st, "ja", None), getattr(st, "as_", None))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_job(job: ShardJob, path: _Path, st, mesh, device) -> dict:
    """The timings of :class:`ShardJob` (``reps > 0``)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    xd = path.prep(st, job.x, mesh)

    def whole():
        return path.collect(st, path.local(st, xd), mesh)

    out = {}
    if job.detail:
        # the ranks in turn: the others wait at the barrier, off the card
        for turn in range(world):
            if turn == rank:
                out["local_s"] = (
                    device_time_fn(path.local, st, xd, device=device,
                                   reps=job.reps)
                    if device.type == "cuda" else
                    time_fn(path.local, st, xd, device=device, reps=job.reps))
            dist.barrier()
        scratch = torch.zeros_like(path.local(st, xd))
        _sync(device)
        dist.barrier()
        out["collective_s"] = time_fn(path.collect, st, scratch, mesh,
                                      device=device, reps=job.reps)
    # a whole call: device time where the collective stays on the card
    # (NCCL); gloo copies through the host, so there the call's time
    on_card = device.type == "cuda" and dist.get_backend() == "nccl"
    best = []
    for _ in range(job.rounds):
        dist.barrier()
        best.append(device_time_fn(whole, device=device, reps=job.reps)
                    if on_card else
                    time_fn(whole, device=device, reps=job.reps))
    out["call_s"] = min(best)
    if job.detail:
        walls = []
        for _ in range(job.reps):
            dist.barrier()
            t0 = time.perf_counter()
            whole()
            _sync(device)
            walls.append(time.perf_counter() - t0)
        out["wall_s"] = statistics.median(walls)
    return out


def run_shard_jobs(device: torch.device, jobs) -> list:
    """What every rank of a :func:`..parallel.launch.spawn` call runs: for
    each :class:`ShardJob`, a mesh over the whole group, this rank's shard
    uploaded, the global y through the path's public function, and the
    job's timings and checks. Returns per job a dict: ``y`` (numpy),
    ``bytes`` held on the device, ``launches`` (the kernel launches the
    job made, by wrapper), ``backend`` and the timings."""
    out = []
    for job in jobs:
        path = SHARD_PATHS[job.path]
        mesh = _sh.make_mesh(int(np.prod(job.mesh_shape)), job.mesh_dims,
                             job.mesh_shape, device_type=device.type)
        before = _counters()
        st = path.upload(job.obj, mesh, job.dtype)
        y = path.public(job.obj, st, job.x, mesh)
        res = {"y": y.cpu().numpy(), "bytes": _held_bytes(st),
               "backend": dist.get_backend()}
        if job.check_plain:
            if job.path != "sell":
                raise ValueError("check_plain holds the sell path's kernels")
            xd = path.prep(st, job.x, mesh)
            got, want = sell_spmv(st.local, xd), sell_spmv_plain(st.local, xd)
            res["plain_max_abs_err"] = float((got - want).abs().max()) \
                if got.numel() else 0.0
            res["plain_scale"] = float(want.abs().max()) if want.numel() \
                else 0.0
        if job.reps:
            res.update(_time_job(job, path, st, mesh, device))
        res["launches"] = {k: v - before[k] for k, v in _counters().items()
                           if v != before[k]}
        out.append(res)
        del st
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _write_scale_rows(out_csv, label, csr, results, work, role="parallel"):
    """openmp-schema rows for a device-scale curve (num_threads = device
    count; ``work`` = flops numerator/2, nnz for SpMV or nnz*B for SpMM).
    Shared by all device sweeps so the 33-column mapping lives once.

    ``role`` picks the reference column family the curve fills:
    ``"parallel"`` (the CSR-kernel columns) or ``"hll"`` (time_parallel_hll
    / flops_parallel_hll / speedup_hll / efficiency_hll). Paths with no
    reference analogue (pr, split) use the parallel columns under a
    ``[path]``-suffixed label."""
    t1 = results[0][1] if results else 0.0
    # column indices per role: (t1, sec, err_rel, err_abs, flops_t1,
    # flops, speedup, efficiency) in the 33-column reference layout
    idx = {"parallel": (5, 7, 11, 12, 19, 21, 25, 29),
           "hll": (6, 9, 13, 14, 20, 23, 27, 31)}[role]
    for n, sec, gf, dm in results:
        sp = t1 / sec if sec > 0 else 0.0
        row = [label, csr.nrows, csr.ncols, csr.nnz, n] + [_fmt(0.0)] * 28
        row[idx[0]] = _fmt(t1)
        row[idx[1]] = _fmt(sec)
        row[idx[2]] = _fmt(dm.mean_rel_err)
        row[idx[3]] = _fmt(dm.mean_abs_err)
        row[idx[4]] = _fmt(calculate_flops(work, t1) if t1 > 0 else 0.0)
        row[idx[5]] = _fmt(gf * 1e9)
        row[idx[6]] = _fmt(sp)
        row[idx[7]] = _fmt(sp / n)
        _append_row(out_csv, OPENMP_HEADER, row)


def _device_counts(device: torch.device, n_devices, device_counts) -> list:
    """The counts of a sweep: as given, else 1, 2, 4, ... up to the
    devices (the GPUs; CPU ranks: ``n_devices``, default 1)."""
    if device_counts:
        return list(device_counts)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    return [n for n in (1, 2, 4, 8, 16, 32) if n <= n_devices]


def _sweep(name, tag, device, counts, make_job, validate, work, log) -> list:
    """Per device count: build the job on the host, run it on that many
    spawned ranks (each handed its own shard), validate rank 0's y, and
    take the slowest rank's call time; ``[(n, seconds, gflops,
    DiffMetrics)]``."""
    results = []
    for n in counts:
        t0 = time.perf_counter()
        job = make_job(n)
        conv_s = time.perf_counter() - t0
        ranks = spawn(run_shard_jobs, n, device_type=device.type,
                      rank_args=[([dataclasses.replace(
                          job, obj=for_rank(job.obj, r))],)
                          for r in range(n)])
        dm = validate(ranks[0][0]["y"])
        sec = max(r[0]["call_s"] for r in ranks)
        gf = calculate_flops(work, sec) / 1e9
        log(f"[{name}] {tag} x{n} {device.type} ranks: {sec*1e3:.4f} ms = "
            f"{gf:.3f} GFLOPS, sig_diffs={dm.significant_diffs} "
            f"(host build {conv_s:.1f} s)")
        results.append((n, sec, gf, dm))
    return results


def _sweep_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the device-count sweep runs on GPUs and "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu' for CPU ranks")
    return device


def run_path_scale_sweep(
    name: str,
    csr: CSRMatrix,
    out_csv: str,
    path: str,
    *,
    device_counts=None,
    n_devices: int | None = None,
    dtype=torch.float32,
    iterations: int = 16,
    rounds: int = 2,
    x: np.ndarray | None = None,
    log=print,
    device="cuda",
):
    """Device-scale curve for one shard path: ``"sell"`` (row-sharded
    SELL), ``"hll"`` (row-sharded ELL: the reference CSV's hll column
    family), ``"pr"`` (panel-sharded PR), ``"sell_cols"`` (column-sharded
    SELL + all_reduce) or ``"split"`` (the locality-split composite). One
    openmp-schema row per device count, labeled ``name[path]``; the time
    of a count is its slowest rank's whole call."""
    device = _sweep_device(device)
    if x is None:
        x = np.ones(csr.ncols, dtype=np.float64)
    y_ref = csr.spmv(x)
    builds = {
        "sell": lambda n: ShardJob("sell", build_spmd_sell(csr, n, dtype=dtype),
                                   x, (n,)),
        "pr": lambda n: ShardJob("pr", build_spmd_pr(csr, n, dtype=dtype),
                                 x, (n,)),
        "split": lambda n: ShardJob("split", build_spmd_split(
            csr, n, dtype=dtype), x, (n,)),
        "sell_cols": lambda n: ShardJob("sell_cols", build_spmd_sell_cols(
            csr, n, dtype=dtype), x, (n,), ("cols",)),
    }
    if path == "hll":
        hll = HLLMatrix.from_csr(csr)
        builds["hll"] = lambda n: ShardJob("ell_rows", hll, x, (n,),
                                           dtype=dtype)
    if path not in builds:
        raise ValueError(f"unknown path {path!r}")

    def make_job(n):
        return dataclasses.replace(builds[path](n), reps=iterations,
                                   rounds=rounds)

    def validate(y):
        return difference_metrics(y_ref, np.asarray(y, np.float64)[
            : csr.nrows], DEFAULT_ABS_TOL, DEFAULT_REL_TOL)

    results = _sweep(name, f"spmd_{path}", device,
                     _device_counts(device, n_devices, device_counts),
                     make_job, validate, csr.nnz, log)
    _write_scale_rows(out_csv, f"{name}[{path}]", csr, results, csr.nnz,
                      role="hll" if path == "hll" else "parallel")
    return results


def run_device_scale_sweep(
    name: str,
    csr: CSRMatrix,
    out_csv: str,
    *,
    device_counts=None,
    n_devices: int | None = None,
    dtype=torch.float32,
    iterations: int = 16,
    rounds: int = 2,
    x: np.ndarray | None = None,
    log=print,
    device="cuda",
):
    """Time the row-sharded SELL SpMV at 1..N ranks; write one
    openmp-schema row per device count (num_threads column = device count
    — the documented column mapping for the device axis)."""
    device = _sweep_device(device)
    if x is None:
        x = np.ones(csr.ncols, dtype=np.float64)
    y_ref = csr.spmv(x)

    def make_job(n):
        return ShardJob("sell", build_spmd_sell(csr, n, dtype=dtype), x,
                        (n,), reps=iterations, rounds=rounds)

    def validate(y):
        return difference_metrics(y_ref, np.asarray(y, np.float64),
                                  DEFAULT_ABS_TOL, DEFAULT_REL_TOL)

    results = _sweep(name, "spmd_sell", device,
                     _device_counts(device, n_devices, device_counts),
                     make_job, validate, csr.nnz, log)
    _write_scale_rows(out_csv, name, csr, results, csr.nnz)
    return results


def run_spmm_device_scale_sweep(
    name: str,
    csr: CSRMatrix,
    out_csv: str,
    *,
    device_counts=None,
    n_devices: int | None = None,
    rhs: int = 128,
    dtype=torch.float32,
    iterations: int = 16,
    rounds: int = 2,
    log=print,
    device="cuda",
):
    """Device-scale curve for the BSR SpMM (parallel/spmd_bsr.py):
    block-rows shard uniformly with no collective but the final gather.
    Same openmp-schema rows as :func:`run_device_scale_sweep`; the flops
    columns count the full ``2*nnz*rhs`` SpMM work, validated on sampled
    columns against the fp64 oracle."""
    device = _sweep_device(device)
    bsr = BSRMatrix.from_csr(csr)
    X = np.random.default_rng(0).standard_normal(
        (csr.ncols, rhs), dtype=np.float32)

    def make_job(n):
        return ShardJob("bsr", shard_bsr(bsr, n, dtype=dtype), X, (n,),
                        reps=iterations, rounds=rounds)

    results = _sweep(name, f"spmd_bsr_spmm B={rhs}", device,
                     _device_counts(device, n_devices, device_counts),
                     make_job, lambda Y: sampled_spmm_metrics(csr, X, Y),
                     csr.nnz * rhs, log)
    _write_scale_rows(out_csv, f"{name}@spmm{rhs}", csr, results,
                      csr.nnz * rhs)
    return results
