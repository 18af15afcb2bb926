"""Build and load the hand-written CUDA kernels.

The sources in ``csrc/`` have a plain C interface. At first use each is
compiled with ``nvcc`` for ``sm_90a``, all at once in parallel processes, and
the objects are linked into one shared library under ``build/kernels/`` at
the root of the checkout, named by a hash of the sources and flags, and
loaded with :mod:`ctypes`. Importing this module compiles nothing and needs
no ``nvcc``; only :func:`load` does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["load", "library_path", "build_log"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_HEADERS = ("sell_common.cuh", "dd.cuh")
_SOURCES = ("sell_k_major.cu", "sell_wl.cu", "sell_sb.cu", "sell_sg.cu",
            "pr.cu", "sell_spmm.cu", "bsr.cu", "bw_probe.cu",
            "kernel_probe.cu", "panel_reduce.cu", "dd_split_join.cu",
            "row_map.cu", "cg_step.cu")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_F64 = ctypes.c_double
# C entry -> argument types; every entry returns cudaGetLastError() as an int
# but those of _RESTYPES.
# The k-major and sb dd entries take, in place of (as, x, y), the hi/lo
# planes (as_hi, as_lo, x_hi, x_lo, y_hi, y_lo); the wl, sg and compacted
# sb-list dd entries (as2, x2, y_hi, y_lo): (hi, lo) value pairs and an
# interleaved x table.
_DD = (_P,) * 6
_ENTRIES = {
    # group_ids, ja, as, x, y, n_groups, K, lanes, accumulate, stream
    **{f"sell_k_major_{v}": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P)
       for v in ("f32", "bf16")},
    "sell_k_major_dd": (_P, _P, *_DD, _I64, _I32, _I32, _I32, _P),
    # group_ids, slabs, plane_off, row_len, codes, as, x, y, n_groups, NW,
    # accumulate, stream
    **{f"sell_wl_{v}": (*(_P,) * 8, _I64, _I32, _I32, _P)
       for v in ("f32", "bf16")},
    "sell_wl_dd": (*(_P,) * 9, _I64, _I32, _I32, _P),
    # group_ids, table, ja, as, x, y, n_groups, K, ck, span, accumulate, stream
    **{f"sell_{lay}_{v}_{i}": (_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                               _I32, _P)
       for lay, i in (("sb_major", "i32"), ("sb_major", "i16"),
                      ("sb_list", "i16")) for v in ("f32", "bf16")},
    **{f"sell_{lay}_dd_{i}": (_P, _P, _P, *_DD, _I64, _I32, _I32, _I32, _I32,
                              _P)
       for lay, i in (("sb_major", "i32"), ("sb_major", "i16"),
                      ("sb_list", "i16"))},
    # compacted sb-list and sg: group_ids, plane_off, row_table, ja, as, x,
    # y, n_groups, accumulate, stream; dd: as2, x2, y_hi, y_lo
    **{f"sell_{lay}_{v}": (*(_P,) * 7, _I64, _I32, _P)
       for lay in ("sb_list", "sg") for v in ("f32", "bf16")},
    "sell_sb_list_dd": (*(_P,) * 8, _I64, _I32, _P),
    # compacted k-major dd: group_ids, plane_off, row_table, ja, as_hi,
    # as_lo, x_hi, x_lo, y_hi, y_lo, n_groups, accumulate, stream
    "sell_k_major_dd_list": (*(_P,) * 4, *_DD, _I64, _I32, _P),
    # padded sg, dd: group_ids, table, counts, ja, as2, x2, y_hi, y_lo,
    # scratch, n_groups, T, stride, slots, chunks, accumulate, stream
    "sell_sg_dd": (*(_P,) * 9, _I64, _I32, _I32, _I32, _I32, _I32, _P),
    # column panels' slices into y: parts, cover, y, n_groups, slices,
    # stream; dd: parts_hi, parts_lo, cover, y_hi, y_lo, ...
    "panel_reduce_f32": (_P, _P, _P, _I64, _I32, _P),
    "panel_reduce_dd": (*(_P,) * 5, _I64, _I32, _P),
    # the dd SpMV's x split and y join: x, ncols, rows, pair, hi, lo, stream;
    # hi, lo, y, n, stream
    "dd_prepare_x": (_P, _I64, _I64, _P, _P, _P, _P),
    "dd_join_y": (_P, _P, _P, _I64, _P),
    # a sorted SELL's y into the caller's row order: src, ptr, pos, y, n,
    # stream; dd: src_hi, src_lo, ptr, pos, y_hi, y_lo, n, stream
    "row_gather_f32": (_P, _P, _P, _P, _I64, _P),
    "row_gather_dd": (*(_P,) * 6, _I64, _P),
    # CG's vector work (solvers/cg.py): the workspace's bytes for an entry
    # size, a pinned word's device address, the stop flag once written;
    # b, ax, minv, r, p, work, flag, n, tol, stream; p, ap, work, n, stream;
    # x, r, ap, p, minv, work, flag, n, stream; r, minv, p, work, n, stream
    "cg_work_bytes": (_I32,),
    "cg_flag_pointer": (_P,),
    "cg_flag": (_P, _P),
    **{f"cg_init_{v}": (*(_P,) * 7, _I64, _F64, _P) for v in ("f32", "f64")},
    **{f"cg_alpha_{v}": (_P, _P, _P, _I64, _P) for v in ("f32", "f64")},
    **{f"cg_step_{v}": (*(_P,) * 7, _I64, _P) for v in ("f32", "f64")},
    **{f"cg_dir_{v}": (*(_P,) * 4, _I64, _P) for v in ("f32", "f64")},
    # bins, n_bins, dst_col, dst_val, x, y, n_groups, stream; dd: dst_val
    # holds (hi, lo) pairs, then x_hi, x_lo, y_hi, y_lo
    **{f"pr_spmv_{v}": (_P, _I32, _P, _P, _P, _P, _I64, _P)
       for v in ("f32", "bf16")},
    "pr_spmv_dd": (_P, _I32, _P, *(_P,) * 5, _I64, _P),
    # SpMM, x and y row-major with row strides ldx, ldy; W columns computed
    # group_ids, ja, x_window, as, x, y, n_groups, K, stage_rows, W, ldx,
    # ldy, accumulate, stream
    **{f"sell_k_major_spmm_{v}": (*(_P,) * 6, _I64, _I32, _I32, _I32, _I64,
                                  _I64, _I32, _P)
       for v in ("f32", "bf16")},
    # group_ids, slabs, plane_off, row_len, codes, as, x, y, n_groups, NW, W,
    # ldx, ldy, accumulate, stream
    **{f"sell_wl_spmm_{v}": (*(_P,) * 8, _I64, _I32, _I32, _I64, _I64, _I32,
                             _P)
       for v in ("f32", "bf16")},
    # block_cols, tile_mask, blocks, x, y, n_block_rows, n_block_cols, kb,
    # B, ldx, ldy, stream
    **{f"bsr_spmm_{r}_{v}": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I64,
                             _I64, _P)
       for r in ("blockspec", "dma") for v in ("f32", "bf16")},
    # bandwidth probe (bench/bw_probe.py)
    # a, b, n_vec, n_blocks, partial, seed, out, stream
    **{f"bw_read_{v}": (_P, _P, _I64, _I32, _P, _P, _P, _P)
       for v in ("f32", "i32", "i16", "i8")},
    "bw_read2_f32_i32": (_P, _P, _I64, _I32, _P, _P, _P, _P),
    # in, seed, out, n_vec, n_blocks, stream
    "bw_copy_f32": (_P, _P, _P, _I64, _I32, _P),
    # buf, n_chunks, chunk_rows, nbuf, n_blocks, partial, seed, out, stream
    "bw_read_async_f32": (_P, _I64, _I32, _I32, _I32, _P, _P, _P, _P),
    # chunk_rows, nbuf, blocks_per_sm (int*)
    "bw_read_async_occupancy": (_I32, _I32, _P),
    # qb, x, ja, as, seed, y, n_groups, k, span, stream
    **{f"bw_kernelsim_{v}f32": (_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _P)
       for v in ("", "packed_", "nocompute_")},
    # kernel-variant probes (bench/kernel_probe.py)
    # mode, code_bytes, ja, as, tab, x, partial, y, steps, kb, ck, span, L,
    # stride, tcols, parts, gpp, stream
    "kp_decode": (_I32, _I32, _P, _P, _P, _P, _P, _P, _I64, *(_I32,) * 8,
                  _P),
    # mode, f, tab, x, partial, y, steps, kb, tcols, parts, gpp, stream
    "kp_fused": (_I32, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P),
    # a, b, two, n_rows, n_blocks, partial, out, stream
    "kp_colsum": (_P, _P, _I32, _I64, _I32, _P, _P, _P),
}
# entries that return something else than an error code
_RESTYPES = {"cg_work_bytes": _I64, "cg_flag_pointer": _I64}


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _HEADERS + _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / f"libsell_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """The compiler's output of the build (``-Xptxas -v``: registers,
    shared memory and spills per kernel), or "" when it was not built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}: the CUDA kernels "
            "cannot be built")
    return str(path)


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library are written under a private directory and
    # renamed: concurrent processes never load a half-written library
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in _SOURCES]
        with ThreadPoolExecutor(len(_SOURCES)) as pool:
            logs = list(pool.map(
                _run, [[nvcc, *_FLAGS, "-c", str(_CSRC / s), "-o", o]
                       for s, o in zip(_SOURCES, objs)]))
        lib = os.path.join(tmp, target.name)
        _run([nvcc, *_ARCH, "-shared", "-o", lib, *objs])
        target.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, target)


@functools.cache
def load() -> ctypes.CDLL:
    """Build the kernels if needed and load them (once per process)."""
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib
