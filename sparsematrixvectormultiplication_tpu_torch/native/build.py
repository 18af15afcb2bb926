"""Build and load the native host components (ctypes).

* ``fast_route.cpp`` — the PR router, which computes the PR layout's routing
  at conversion time (:mod:`..formats.pr`): a 128-edge-colouring, the
  per-lane Beneš masks and the final lane gather;
* ``fast_bsr.cpp`` — the CSR -> 128x128 BSR blocker (:mod:`..formats.bsr`):
  distinct blocks per block-row, then the dense tiles;
* ``fast_csr.cpp`` — the COO -> CSR converter (:mod:`..formats.csr`): a
  counting sort over rows, then short per-row column sorts;
* ``fast_mmio.cpp`` — the Matrix Market coordinate-body parser
  (:mod:`..io.mmio`), split across threads at line boundaries.

At first use each source is compiled with ``g++ -O3 -std=c++17 -shared
-fPIC -pthread`` into ``build/native/`` at the root of the checkout, under a
name hashed from the source and the flags, and loaded with :mod:`ctypes`.
Importing this module compiles nothing. A library that cannot be built, or
that fails, raises: there is no silent fallback to the Python router, the
numpy blocker or the numpy CSR converter, which take minutes (router,
millions of elements) or tens of seconds (blocker and converter, tens of
millions of entries). A coordinate body the parser refuses (a token its
number scanner does not read, such as ``nan``, or a malformed line) is a
property of the file, not of the build: :func:`parse_body_native` returns
None for it, and the numpy parser reads the body or raises ``MMIOError``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["load_fast_route", "run_fast_route", "load_fast_bsr",
           "csr_to_bsr_native", "load_fast_csr", "coo_to_csr_native",
           "load_fast_mmio", "parse_body_native", "library_path"]

_DIR = Path(__file__).resolve().parent
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# library stem -> (source, what it is, for messages)
_LIBS = {"fastroute": ("fast_route.cpp", "the PR router"),
         "fastbsr": ("fast_bsr.cpp", "the BSR blocker"),
         "fastcsr": ("fast_csr.cpp", "the COO->CSR converter"),
         "fastmmio": ("fast_mmio.cpp", "the Matrix Market parser")}
_P32 = ctypes.POINTER(ctypes.c_int32)
_P64 = ctypes.POINTER(ctypes.c_int64)
_PF64 = ctypes.POINTER(ctypes.c_double)
_BLOCK = 128
# each blocker thread carries a 4*n_bc-byte stamp array: cap them at 256 MiB
_STAMP_BYTES = 256 << 20


def library_path(stem: str = "fastroute") -> Path:
    """Where library ``stem`` ("fastroute", "fastbsr", "fastcsr" or
    "fastmmio") for the current source and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update((_DIR / _LIBS[stem][0]).read_bytes())
    return _BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def _build(stem: str, target: Path) -> None:
    src, what = _LIBS[stem]
    name = os.environ.get("CXX") or "g++"
    cxx = shutil.which(name)
    if not cxx:
        raise RuntimeError(f"C++ compiler {name!r} not found: {what} "
                           "cannot be built")
    target.parent.mkdir(parents=True, exist_ok=True)
    # written under a private name and renamed: concurrent processes never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        lib = os.path.join(tmp, target.name)
        proc = subprocess.run([cxx, *_FLAGS, str(_DIR / src), "-o", lib],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"building {what} failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, target)


def _load(stem: str) -> ctypes.CDLL:
    path = library_path(stem)
    if not path.exists():
        _build(stem, path)
    return ctypes.CDLL(str(path))


@functools.cache
def load_fast_route():
    """Build the router if needed and return its ``pr_route`` entry."""
    fn = _load("fastroute").pr_route
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _P32, _P32, _P32, _P32,
                   _P32, _P32]
    return fn


def run_fast_route(src_row, dst_row, dst_lane, n_rows: int):
    """Native PR routing; the contract of
    :func:`..formats.pr_route.route_elements`: returns ``(src_lane,
    packed_masks, final_lane)``. Raises when the router refuses the
    problem."""
    fn = load_fast_route()
    n = int(np.asarray(src_row).size)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    sr, dr, dl = i32(src_row), i32(dst_row), i32(dst_lane)
    src_lane = np.empty(n, dtype=np.int32)
    packed = np.empty((n_rows, 128), dtype=np.int32)
    final_lane = np.empty((n_rows, 128), dtype=np.int32)
    ptr = lambda a: a.ctypes.data_as(_P32)
    rc = fn(n, int(n_rows), ptr(sr), ptr(dr), ptr(dl), ptr(src_lane),
            ptr(packed), ptr(final_lane))
    if rc != 0:
        raise RuntimeError(f"pr_route failed with code {rc} (n={n}, "
                           f"n_rows={n_rows})")
    return src_lane, packed, final_lane


@functools.cache
def load_fast_bsr():
    """Build the blocker if needed and return its ``(fast_bsr_count,
    fast_bsr_fill)`` entries."""
    lib = _load("fastbsr")
    cnt = lib.fast_bsr_count
    cnt.restype = ctypes.c_int64
    cnt.argtypes = [_P64, _P32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                    _P64]
    fil = lib.fast_bsr_fill
    fil.restype = ctypes.c_int64
    fil.argtypes = [_P64, _P32, ctypes.POINTER(ctypes.c_double),
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, _P32]
    return cnt, fil


def csr_to_bsr_native(row_ptr, col_idx, values, nrows: int, n_bc: int,
                      value_dtype, max_bytes: int, num_threads: int = 0):
    """Native CSR -> BSR(128x128) blocking: returns ``(blocks, bcols, kb,
    n_real_blocks)``, the products of the numpy path of
    :meth:`..formats.bsr.BSRMatrix.from_csr`. Raises ``ValueError`` on a
    blown byte budget (the numpy path's message) or a value type other than
    float32/float64, and ``RuntimeError`` when the blocker fails."""
    from ..formats.bsr import _budget_message

    value_dtype = np.dtype(value_dtype)
    if value_dtype not in (np.float32, np.float64):
        raise ValueError(f"the native blocker fills float32 or float64 "
                         f"blocks, not {value_dtype}")
    cnt, fil = load_fast_bsr()
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float64)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 16)
    num_threads = min(num_threads,
                      max(1, _STAMP_BYTES // (4 * max(n_bc, 1))))
    n_br = -(-nrows // _BLOCK)
    counts = np.zeros(n_br, dtype=np.int64)
    kb = cnt(row_ptr.ctypes.data_as(_P64), col_idx.ctypes.data_as(_P32),
             nrows, n_bc, num_threads, counts.ctypes.data_as(_P64))
    if kb < 0:
        raise RuntimeError(f"fast_bsr_count failed with code {kb} "
                           f"(nrows={nrows}, n_bc={n_bc})")
    n_real = int(counts.sum())
    stored = n_br * kb * _BLOCK * _BLOCK * value_dtype.itemsize
    if stored > max_bytes:
        raise ValueError(_budget_message(stored, n_real, int(kb),
                                         int(col_idx.size), max_bytes))
    blocks = np.zeros((n_br * kb, _BLOCK, _BLOCK), dtype=value_dtype)
    bcols = np.zeros(n_br * kb, dtype=np.int32)
    rc = fil(row_ptr.ctypes.data_as(_P64), col_idx.ctypes.data_as(_P32),
             values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
             nrows, n_bc, kb, num_threads, int(value_dtype == np.float64),
             blocks.ctypes.data_as(ctypes.c_void_p),
             bcols.ctypes.data_as(_P32))
    if rc != 0:
        raise RuntimeError(f"fast_bsr_fill failed with code {rc}")
    return blocks, bcols, int(kb), n_real


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else min(os.cpu_count() or 1, 16)


@functools.cache
def load_fast_csr():
    """Build the converter if needed and return its ``fast_coo_to_csr``
    entry."""
    fn = _load("fastcsr").fast_coo_to_csr
    fn.restype = ctypes.c_int64
    fn.argtypes = [_P32, _P32, _PF64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, _P64, _P32, _PF64]
    return fn


def coo_to_csr_native(row, col, val, nrows: int, num_threads: int = 0):
    """Native COO -> CSR (≙ the reference's convert_in_csr,
    src/csr_matrix.c:63-126: counting sort, then each row sorted by
    column): returns ``(row_ptr int64, col_idx int32, values float64)``,
    the products of the numpy path of :meth:`..formats.csr.CSRMatrix.
    from_coo` (duplicate coordinates of one row keep their input order in
    rows of up to 32 entries; longer rows sort with ``std::sort``, which
    may order duplicates otherwise). Raises ``RuntimeError`` when a row
    index is out of range."""
    fn = load_fast_csr()
    row = np.ascontiguousarray(row, dtype=np.int32)
    col = np.ascontiguousarray(col, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.float64)
    nnz = int(row.size)
    row_ptr = np.empty(int(nrows) + 1, dtype=np.int64)
    col_out = np.empty(nnz, dtype=np.int32)
    val_out = np.empty(nnz, dtype=np.float64)
    rc = fn(row.ctypes.data_as(_P32), col.ctypes.data_as(_P32),
            val.ctypes.data_as(_PF64), nnz, int(nrows),
            _threads(num_threads), row_ptr.ctypes.data_as(_P64),
            col_out.ctypes.data_as(_P32), val_out.ctypes.data_as(_PF64))
    if rc != 0:
        raise RuntimeError(f"fast_coo_to_csr failed with code {rc} "
                           f"(nnz={nnz}, nrows={nrows})")
    return row_ptr, col_out, val_out


@functools.cache
def load_fast_mmio():
    """Build the parser if needed and return its ``fast_mmio_parse_body``
    entry."""
    fn = _load("fastmmio").fast_mmio_parse_body
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, _P32, _P32, _PF64]
    return fn


def parse_body_native(body: bytes, nnz: int, per_line: int,
                      num_threads: int = 0, offset: int = 0):
    """Parse the ``nnz`` entries of a coordinate body, ``body[offset:]``
    (no copy), of ``per_line`` numbers each (2 pattern, 3 real or integer,
    4 complex: the real part is kept): returns ``(row, col, val)``, 1-based
    int32 indices and float64 values, or None when the parser refuses the
    body (fewer entries than ``nnz``, or a token it does not read)."""
    fn = load_fast_mmio()
    rows = np.empty(nnz, dtype=np.int32)
    cols = np.empty(nnz, dtype=np.int32)
    vals = np.empty(nnz, dtype=np.float64)
    base = ctypes.cast(ctypes.c_char_p(body), ctypes.c_void_p).value
    got = fn(base + offset, len(body) - offset, nnz, per_line,
             _threads(num_threads), rows.ctypes.data_as(_P32),
             cols.ctypes.data_as(_P32), vals.ctypes.data_as(_PF64))
    return (rows, cols, vals) if got == nnz else None
