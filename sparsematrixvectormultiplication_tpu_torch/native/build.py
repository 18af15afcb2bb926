"""Build and load the native PR router (``fast_route.cpp``, ctypes).

The router computes the PR layout's routing at conversion time
(:mod:`..formats.pr`): a 128-edge-colouring, the per-lane Beneš masks and
the final lane gather. At first use ``fast_route.cpp`` is compiled with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into ``build/native/`` at the
root of the checkout, under a name hashed from the source and the flags,
and loaded with :mod:`ctypes`. Importing this module compiles nothing. A
router that cannot be built, or that fails, raises: there is no silent
fallback to the Python router, which takes minutes on millions of elements.
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

__all__ = ["load_fast_route", "run_fast_route", "library_path"]

_SRC = Path(__file__).resolve().parent / "fast_route.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_P32 = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    """Where the router library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libfastroute_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    name = os.environ.get("CXX") or "g++"
    cxx = shutil.which(name)
    if not cxx:
        raise RuntimeError(f"C++ compiler {name!r} not found: the PR router "
                           "cannot be built")
    target.parent.mkdir(parents=True, exist_ok=True)
    # written under a private name and renamed: concurrent processes never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        lib = os.path.join(tmp, target.name)
        proc = subprocess.run([cxx, *_FLAGS, str(_SRC), "-o", lib],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"building the PR router failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, target)


@functools.cache
def load_fast_route():
    """Build the router if needed and return its ``pr_route`` entry."""
    path = library_path()
    if not path.exists():
        _build(path)
    fn = ctypes.CDLL(str(path)).pr_route
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
