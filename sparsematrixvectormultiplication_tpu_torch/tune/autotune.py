"""Autotuner — SELL ladder, layout and bin assembly, and HLL hack size,
picked by measurement.

The reference's launch configuration layer is
``cudaOccupancyMaxPotentialBlockSize``, which picks CUDA block sizes at run
time (main_cuda.cu:149,212,293,413,545,613), with the chosen dims logged to
CSV (write_block_result_to_csv, cuda_src/utility.cu:236-261). Here the
tunables are the SELL K-bin ladder, a forced layout (or the converter's
cost model, "auto"), bin merging, the bin assembly of ``sell_spmv`` and the
HLL hack size.

:func:`autotune_sell` on a CUDA device converts, uploads and times every
candidate with ``utils.timing.device_time_fn``. On the CPU, which the caller
asks for with ``device="cpu"``, it prices each candidate with the host cost
model of ``formats/sell.py`` (the constants its merge policy uses), as the
JAX tuner does off the TPU, so the CPU tests hold the two tuners to the same
picks. A candidate that a host-side guard refuses costs one table row: a
conversion that raises ``ValueError`` or ``MemoryError``, the upload cap, or
a name listed in ``.tune_skip``. Nothing around a launch is caught: after a
launch error the CUDA context is lost, and a caught one would hide a broken
kernel.
"""

# Ported from sparsematrixvectormultiplication_tpu/tune/autotune.py (the
# port must not import the JAX package).

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.hll import HLLMatrix
from ..formats.sell import (_LAUNCH_S, _PALLAS_BW, _VREG_OP_S,
                            DEFAULT_K_BINS, SellMatrix)
from ..ops.sell import (device_put_sell, device_put_x, sell_spmv,
                        sell_spmv_launches)
from ..utils.timing import MAX_QUEUED_LAUNCHES, device_time_fn

__all__ = ["DEFAULT_LADDERS", "SellCandidate", "TuneResult", "autotune_sell",
           "autotune_hack_size"]

# K-bin ladders to try: finer ladders cut padding, coarser ladders cut the
# number of kernel launches (one per bin).
DEFAULT_LADDERS = {
    "default": DEFAULT_K_BINS,
    "pow2": (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
    "fine": tuple(range(8, 1032, 8)),
    "coarse": (8, 32, 128, 512, 2048),
}


@dataclass
class SellCandidate:
    name: str
    k_bins: tuple
    layout: str = "auto"
    merge_bins: bool = True


@dataclass
class TuneResult:
    best: SellCandidate
    best_seconds: float
    table: list = field(default_factory=list)  # (name, seconds, stats) rows
    assembly: str = "auto"  # measured bin-assembly choice for the winner


def _default_candidates() -> list:
    """The 10 default candidates: each ladder under the cost model's
    layouts, then the default ladder with each layout forced and unmerged."""
    return [SellCandidate(n, kb) for n, kb in DEFAULT_LADDERS.items()] + [
        SellCandidate("default-kmajor", DEFAULT_K_BINS, "k-major"),
        SellCandidate("default-sbmajor", DEFAULT_K_BINS, "sb-major"),
        SellCandidate("default-sblist", DEFAULT_K_BINS, "sb-list"),
        # forced wl relaxes the fill guard to 8x (formats/sell.py), so
        # moderately banded groups get a measured shot at wl
        SellCandidate("default-wl", DEFAULT_K_BINS, "wl"),
        # wl with pile shedding (one slot per slab; the overflow goes to an
        # add_into remainder, formats/sell.py _from_csr_wl_shed)
        SellCandidate("default-wlshed", DEFAULT_K_BINS, "wl-shed"),
        SellCandidate("default-nomerge", DEFAULT_K_BINS, merge_bins=False),
    ]


# tune on a row-prefix subsample beyond this: each candidate re-converts
# and re-uploads the matrix
_TUNE_NNZ_CAP = 20_000_000

# candidates whose f32 planes (4 B column + 4 B value a slot) exceed this
# are not converted or uploaded: padding that large already disqualifies
# them, and converting them costs minutes of host time
_TUNE_UPLOAD_CAP_BYTES = 600 * 1024 * 1024

# operator opt-out: candidate names listed here (one per line, '#'
# comments) are skipped without conversion or upload; read per call, so a
# running sweep can be steered between matrices
_SKIP_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".tune_skip")


def _tune_sample(csr: CSRMatrix, x):
    """Group-aligned row prefix of ~_TUNE_NNZ_CAP nnz (tuning measures
    RELATIVE candidate cost; a structurally-representative prefix ranks
    identically at a fraction of the conversion/upload time)."""
    if csr.nnz <= _TUNE_NNZ_CAP:
        return csr, x
    cut_rows = int(np.searchsorted(csr.row_ptr, _TUNE_NNZ_CAP))
    cut_rows = max(1024, (cut_rows // 1024) * 1024)
    cut_rows = min(cut_rows, csr.nrows)
    p1 = int(csr.row_ptr[cut_rows])
    sub = CSRMatrix(cut_rows, csr.ncols,
                    csr.row_ptr[: cut_rows + 1].copy(),
                    csr.col_idx[:p1], csr.values[:p1])
    return sub, x


def _skip_names() -> set:
    try:
        with open(_SKIP_PATH) as f:
            return {ln.strip() for ln in f
                    if ln.strip() and not ln.startswith("#")}
    except FileNotFoundError:
        return set()


def _device_seconds(dsell, xt, device, reps: int, assembly="auto") -> float:
    """Best of two ``device_time_fn`` rounds of one SpMV (reps capped by
    ``MAX_QUEUED_LAUNCHES`` over ``sell_spmv_launches``)."""
    reps = max(1, min(reps, MAX_QUEUED_LAUNCHES
                      // max(sell_spmv_launches(dsell, assembly), 1)))
    return min(device_time_fn(sell_spmv, dsell, xt, assembly, device=device,
                              reps=reps) for _ in range(2))


def autotune_sell(
    csr: CSRMatrix,
    x=None,
    candidates=None,
    dtype=torch.float32,
    reps: int = 10,
    log=None,
    *,
    device="cuda",
) -> TuneResult:
    """Time each (ladder, layout) candidate's SpMV on ``device``; return the
    winner, the table and the bin assembly measured for it.

    On a CUDA device each candidate is converted, uploaded and timed; then
    the winner (of more than one bin) is timed with ``assembly="sum"``
    against "auto". ``device="cpu"`` prices each candidate with the host
    cost model instead (no upload, no timing). Matrices beyond ~20M nnz tune
    on a group-aligned row-prefix subsample (see _tune_sample)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("autotune_sell measures on a CUDA device and none "
                           "is available; pass device='cpu' for the host "
                           "cost model")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device}: a CUDA device or the CPU")
    measured = device.type == "cuda"
    if candidates is None:
        candidates = _default_candidates()
    if x is None:
        x = np.ones(csr.ncols)
    csr, x = _tune_sample(csr, x)
    xt = device_put_x(x, csr.ncols, device=device) if measured else None

    # pre-conversion padding estimate (K-bin pad from the row-nnz profile,
    # no conversion): scattered power-law shapes pad 60x+, and CONVERTING
    # such a candidate costs minutes before the upload cap can refuse it
    nnz_rows = np.diff(csr.row_ptr).astype(np.int64)
    padded_rows_n = -(-csr.nrows // 1024) * 1024
    prof = np.zeros(padded_rows_n, np.int64)
    prof[: csr.nrows] = nnz_rows
    kg_prof = prof.reshape(-1, 1024).max(axis=1)

    def _est_padded(k_bins):
        edges = np.asarray(sorted(set(int(e) for e in k_bins)), np.int64)
        idx = np.minimum(np.searchsorted(edges, np.maximum(kg_prof, 1),
                                         side="left"), edges.size - 1)
        K = np.maximum(edges[idx], np.maximum(kg_prof, 1))
        return int(K.sum()) * 1024

    skip_names = _skip_names()
    table = []
    best = best_dev = None
    best_sec = float("inf")
    for cand in candidates:
        if cand.name in skip_names:
            if log:
                log(f"[tune] {cand.name} skipped: listed in .tune_skip")
            table.append((cand.name, float("inf"), {"skipped": ".tune_skip"}))
            continue
        if measured:
            est_bytes = _est_padded(cand.k_bins) * 8
            if est_bytes > _TUNE_UPLOAD_CAP_BYTES:
                if log:
                    log(f"[tune] {cand.name} skipped: est device arrays "
                        f"{est_bytes / 2**20:.0f} MiB > upload cap")
                table.append((cand.name, float("inf"),
                              {"skipped": f"est {est_bytes>>20} MiB"}))
                continue
        t0 = time.perf_counter()
        try:
            sell = SellMatrix.from_csr(csr, k_bins=cand.k_bins,
                                       layout=cand.layout,
                                       merge_bins=cand.merge_bins)
        except (ValueError, MemoryError) as e:
            if log:
                log(f"[tune] {cand.name} refused by the conversion: "
                    f"{type(e).__name__}: {str(e)[:200]}")
            table.append((cand.name, float("inf"), {"error": str(e)[:300]}))
            continue
        conv_s = time.perf_counter() - t0
        stats = sell.memory_stats()
        stats["convert_s"] = conv_s
        if measured:
            dev_bytes = int(stats["padded_nnz"]) * 8  # f32 ja+as planes
            if dev_bytes > _TUNE_UPLOAD_CAP_BYTES:
                if log:
                    log(f"[tune] {cand.name} skipped: device arrays "
                        f"{dev_bytes / 2**20:.0f} MiB > upload cap "
                        f"{_TUNE_UPLOAD_CAP_BYTES / 2**20:.0f} MiB")
                table.append((cand.name, float("inf"),
                              {"skipped": f"upload {dev_bytes>>20} MiB"}))
                continue
            dsell = device_put_sell(sell, dtype, device=device)
            sec = _device_seconds(dsell, xt, device, reps)
        else:
            # host cost model: the constants of the converter's merge
            # policy (formats/sell.py)
            passes = sum(b.cost_passes for b in sell.bins)
            stream = stats["bytes_total"]
            sec = max(passes * _VREG_OP_S, stream / _PALLAS_BW) \
                + len(sell.bins) * _LAUNCH_S
        stats["measured" if measured else "modeled"] = sec
        table.append((cand.name, sec, stats))
        if log:
            log(f"[tune] {cand.name}: {sec*1e3:.4f} ms "
                f"{'measured' if measured else 'modeled'}, "
                f"pad={stats['padding_ratio']:.2f}, "
                f"bins={stats['num_bins']}, layouts="
                f"{'+'.join(sorted(set(stats['bin_layouts'])))}")
        if sec < best_sec:
            best, best_sec = cand, sec
            best_dev = dsell if measured else None
        del sell

    # assembly A/B on the winner: "sum" gives every bin its own zeroed y
    # (no bin waits on another's stores); "auto" stores core bins into one
    # y and adds add_into bins onto it
    assembly = "auto"
    if best_dev is not None and len(best_dev.bins) > 1:
        s_sum = _device_seconds(best_dev, xt, device, reps, "sum")
        if log:
            log(f"[tune] assembly: auto {best_sec*1e3:.4f} ms vs "
                f"sum {s_sum*1e3:.4f} ms")
        if s_sum < best_sec:
            assembly = "sum"
    return TuneResult(best=best, best_seconds=best_sec, table=table,
                      assembly=assembly)


def autotune_hack_size(
    coo_or_csr,
    sizes=(8, 16, 32, 64, 128),
    x=None,
    log=None,
):
    """HLL hack-size sweep: returns (best_size, [(size, padded_ratio,
    host_spmv_seconds), ...]).

    Ranks by padded area (the true ELLPACK work measure the reference's HLL
    scheduler balances by, SURVEY §2.1); the host SpMV time is recorded
    beside it."""
    csr = coo_or_csr if isinstance(coo_or_csr, CSRMatrix) else CSRMatrix.from_coo(coo_or_csr)
    if x is None:
        x = np.ones(csr.ncols)
    csr, x = _tune_sample(csr, x)
    rows = []
    best = None
    best_area = float("inf")
    for h in sizes:
        hll = HLLMatrix.from_csr(csr, hack_size=h)
        st = hll.memory_stats()
        t0 = time.perf_counter()
        hll.spmv(x)
        sec = time.perf_counter() - t0
        rows.append((h, st["padding_ratio"], sec))
        if log:
            log(f"[tune] hack={h}: pad={st['padding_ratio']:.3f}, host spmv {sec*1e3:.1f} ms")
        if st["padded_nnz"] < best_area:
            best, best_area = h, st["padded_nnz"]
    return best, rows
