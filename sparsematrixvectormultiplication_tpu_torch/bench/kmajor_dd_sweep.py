"""Device times of the k-major SELL SpMV bins beside cuSPARSE, and the
variants of the compacted double-double bins' kernel.

Run on a machine with a CUDA card::

    python -m sparsematrixvectormultiplication_tpu_torch.bench.kmajor_dd_sweep \\
        [--matrices band64,demo,entry] [--variants 1 | NAME,NAME,...]
        [--layouts W/P,W/P,...] [--rounds N]

Matrices, each converted with ``layout="k-major"``: ``band64`` is
``banded(250_000, 64, 64, seed=11)`` (the smoke's band64_250k: one bin of
245 groups, K = 64), ``demo`` the demo's ``banded(50_000, 24, 500,
seed=0)`` (49 groups, K = 24) and ``entry`` ``entry()``'s ``banded(8192,
24, 512, seed=0)`` (8 groups, whose rows split over lanes). For each matrix
and value type (f32, bf16, dd) it prints one JSON line per bin: whether the
bin is compacted, its lanes a row, the bytes of its planes and tables, its
kernel's device time (``device_time_fn``, calls back to back) and the bound
(the bin's real entries' values and 4-byte columns, each distinct x entry
it reads and each y row it writes, per x table, over 3.35 TB/s); and one
line for the whole SpMV (``sell_spmv`` or ``sell_spmv_dd``) beside
cuSPARSE's CSR SpMV on the same matrix (``torch.sparse_csr_tensor @ x``,
int32 indices, f32 or fp64 values), a yardstick the package never calls.

With ``--variants`` each compacted dd bin is laid out again (:func:`relayout`:
rows sorted by length within windows of W rows of a group, P sorted rows a
plane; ``--layouts``, by default :data:`LAYOUTS`) and run by variants of
the row-list kernel of ``csrc/sell_common.cuh`` (:data:`VARIANTS`, all of
them with ``1``): the sum policy ``DDSum`` (two 4-byte value loads and two
4-byte x gathers a slot, what the package runs) or ``DDPairs`` (one 8-byte
(hi, lo) value load and one 8-byte gather of the interleaved x table, which
a whole SpMV builds first), B slots a batch, x gathered before the adds or
not. They are built with nvcc from the package's headers into
``build/kmajor_dd_variants/`` at the root of the checkout, with their
registers and spills (``-Xptxas -v``); each must equal the package's
kernel bit for bit, and each is timed alone and within a whole SpMV as
``sell_spmv_dd`` runs one bin (the zero fills of y, and for DDPairs the x
pair table), ``--rounds`` times in turn.

The script calls only entry points the package had before its dd k-major
bins were compacted, so the same file also times an older checkout of the
package put first on ``PYTHONPATH`` (run it by path) beside the current
one; ``--variants`` needs a package that compacts.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from sparsematrixvectormultiplication_tpu_torch import CSRMatrix, SellMatrix
from sparsematrixvectormultiplication_tpu_torch.models.synthetic import banded
from sparsematrixvectormultiplication_tpu_torch.ops import _build
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
    device_time_fn,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
MATRICES = {
    "band64": lambda: banded(250_000, 64, 64, seed=11),
    "demo": lambda: banded(50_000, 24, 500, seed=0),
    "entry": lambda: banded(8192, 24, 512, seed=0),
}
PRECISIONS = ("f32", "bf16", "dd")
# kernel variant -> (policy, B, x of a batch gathered before its adds, rows
# a plane)
VARIANTS = {f"pairs_{b}{'_gf' if gf else ''}_p{p}": ("pairs", b, gf, p)
            for p in (32, 128) for b in (4, 8, 16) for gf in (False, True)}
VARIANTS.update({f"planes_{b}{'_gf' if gf else ''}_p{p}": ("planes", b, gf, p)
                 for p in (32, 128) for b in (4, 8, 16)
                 for gf in (False, True)})
# layouts of the compacted rows: (rows sorted by length within windows of
# this many rows of a group, sorted rows a plane); (1024, 32) is the
# package's
LAYOUTS = ((1024, 32), (256, 32), (128, 32), (64, 32), (32, 32), (1024, 128),
           (256, 128), (128, 128))
_VARIANT_SRC = r"""
#include "sell_common.cuh"

// sell_common.cuh's row_list_kernel with P sorted rows a plane
template <typename Sum, int B, bool kGatherFirst, int P>
__global__ void __launch_bounds__(sell::kLanes)
rl_kernel(const int* __restrict__ group_ids, const int* __restrict__ plane_off,
          const int* __restrict__ row_table, const int* __restrict__ ja,
          Sum sum, int accumulate) {
  const int64_t s = int64_t(blockIdx.x) * sell::kLanes + threadIdx.x;
  const int t = __ldg(row_table + s);
  const int n = t >> sell::kRowBits;
  int64_t off = int64_t(__ldg(plane_off + s / P)) * P + (threadIdx.x & (P - 1));
  typename Sum::Acc acc = sum.zero();
  for (int q0 = 0; q0 < n; q0 += B, off += B * P) {
    int col[B];
    typename Sum::Val v[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (q0 + u < n) {
        col[u] = __ldg(ja + off + u * P);
        v[u] = sum.load(off + u * P);
      }
    }
    if constexpr (kGatherFirst) {
      typename Sum::XVal xv[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (q0 + u < n) xv[u] = sum.gather(col[u]);
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (q0 + u < n) sum.add(acc, v[u], xv[u]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (q0 + u < n) sum.add(acc, v[u], col[u]);
      }
    }
  }
  sum.store(acc,
            int64_t(group_ids[blockIdx.x / sell::kSublanes]) * sell::kGroupRows +
                (t & (sell::kGroupRows - 1)),
            accumulate);
}

template <typename Sum, int B, bool GF, int P>
int rl_launch(const int* g, const int* po, const int* rt, const int* ja,
              Sum sum, int64_t ng, int acc, void* s) {
  if (ng > 0) {
    rl_kernel<Sum, B, GF, P><<<dim3(unsigned(ng * sell::kSublanes)),
                               sell::kLanes, 0,
                               static_cast<cudaStream_t>(s)>>>(g, po, rt, ja,
                                                                sum, acc);
  }
  return int(cudaGetLastError());
}

#define PAIRS(name, B, GF, P)                                                \
  extern "C" int name(const int* g, const int* po, const int* rt,           \
                      const int* ja, const float2* as2, const float2* x2,   \
                      float* yh, float* yl, int64_t ng, int acc, void* s) { \
    return rl_launch<sell::DDPairs, B, GF, P>(                              \
        g, po, rt, ja,                                                      \
        sell::DDPairs{{nullptr, nullptr, nullptr, nullptr, yh, yl}, as2,    \
                      x2},                                                  \
        ng, acc, s);                                                        \
  }
#define PLANES(name, B, GF, P)                                               \
  extern "C" int name(const int* g, const int* po, const int* rt,           \
                      const int* ja, const float* ah, const float* al,      \
                      const float* xh, const float* xl, float* yh,          \
                      float* yl, int64_t ng, int acc, void* s) {            \
    return rl_launch<sell::DDSum, B, GF, P>(                                \
        g, po, rt, ja, sell::DDSum{ah, al, xh, xl, yh, yl}, ng, acc, s);    \
  }
"""


def _variant_source() -> str:
    lines = [_VARIANT_SRC]
    for name, (policy, b, gf, p) in VARIANTS.items():
        lines.append(f"{'PAIRS' if policy == 'pairs' else 'PLANES'}({name}, "
                     f"{b}, {str(gf).lower()}, {p})")
    return "\n".join(lines) + "\n"


def _ptxas_usage(log: str) -> dict:
    """(policy, B, gather first, P) -> (registers, spill bytes) of each
    variant kernel that ``-Xptxas -v`` reports in ``log``."""
    usage, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"rl_kernelI(?:N4sell)?(\d+)(DDPairs|DDSum)E?Li"
                          r"(\d+)ELb([01])ELi(\d+)E", m.group(1))
            current = ((("pairs" if k.group(2) == "DDPairs" else "planes"),
                        int(k.group(3)), k.group(4) == "1", int(k.group(5)))
                       if k else None)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            usage.setdefault(current, [None, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(current, [None, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def build_variants():
    """Build the variant library (once per source) and load it; returns the
    library and each variant's (registers, spill bytes)."""
    out = _build._BUILD_DIR.parent / "kmajor_dd_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = _variant_source()
    tag = hashlib.sha256((src + (_build._CSRC / "sell_common.cuh")
                          .read_text()).encode()).hexdigest()[:12]
    lib_path = out / f"libkmajor_dd_variants_{tag}.so"
    cu = out / f"variants_{tag}.cu"
    cu.write_text(src)
    log = _build._run([_build._nvcc(), *_build._FLAGS, "-shared", "-I",
                       str(_build._CSRC), str(cu), "-o", str(lib_path)])
    lib = ctypes.CDLL(str(lib_path))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, (policy, *_) in VARIANTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [*(P,) * (8 if policy == "pairs" else 10), I64, I32, P]
        fn.restype = ctypes.c_int
    usage = _ptxas_usage(log)
    return lib, {name: usage.get(v, (None, None))
                 for name, v in VARIANTS.items()}


def relayout(b, window: int, plane: int) -> SimpleNamespace:
    """Compacted bin ``b`` laid out again: each group's rows sorted by
    length, longest first, within windows of ``window`` rows (1024: the
    whole group, as the package sorts; 32: row order within each plane of
    32), and ``plane`` sorted rows a plane, as wide as the longest of
    them."""
    ng, dev = b.n_groups, b.ja.device
    s = torch.arange(ng * 1024, device=dev)
    n = (b.row_table >> 10).long()
    row = s // 1024 * 1024 + (b.row_table & 1023).long()
    base = b.plane_off.long()[s // 32] * 32 + s % 32
    srow, q = (torch.arange(int(n.max()), device=dev)[None, :]
               < n[:, None]).nonzero(as_tuple=True)
    pos = base[srow] + q * 32
    r, cols = row[srow], b.ja.view(-1)[pos]
    vals = torch.stack([b.as_hi.view(-1)[pos], b.as_lo.view(-1)[pos]], -1)
    length = torch.zeros(ng * 1024, dtype=torch.long, device=dev)
    length[row] = n
    length = length.view(ng, 1024)
    key = (torch.arange(1024, device=dev) // window) * 4096 + (2047 - length)
    local = torch.sort(key, dim=1, stable=True)[1]
    lens = length.gather(1, local)
    plane_off = torch.zeros(ng * 1024 // plane + 1, dtype=torch.int32,
                            device=dev)
    plane_off[1:] = torch.cumsum(lens.view(-1, plane).amax(1), 0)
    rank = torch.empty_like(local)
    rank.scatter_(1, local, torch.arange(1024, device=dev).expand(ng, 1024))
    s2 = (rank + torch.arange(ng, device=dev)[:, None] * 1024).view(-1)[r]
    dest = (plane_off[s2 // plane].long() + q) * plane + s2 % plane
    slots = int(plane_off[-1]) * plane
    ja = torch.zeros(slots, dtype=torch.int32, device=dev)
    ja[dest] = cols
    pair = torch.zeros(slots, 2, device=dev)
    pair[dest] = vals
    return SimpleNamespace(
        n_groups=ng, group_ids=b.group_ids, plane_off=plane_off,
        row_table=((lens << 10) | local).view(-1).to(torch.int32), ja=ja,
        as_pair=pair, hi=pair[:, 0].contiguous(), lo=pair[:, 1].contiguous())


def _planes(b) -> tuple:
    """The bin's value planes: one of (hi, lo) pairs, two (dd), or one."""
    if getattr(b, "as_pair", None) is not None:
        return (b.as_pair,)
    if getattr(b, "as_hi", None) is not None:
        return (b.as_hi, b.as_lo)
    return (b.as_,)


def _tables(b) -> tuple:
    return tuple(t for t in (b.group_ids, b.slab_list, b.slab_count,
                             getattr(b, "row_table", None), b.plane_off,
                             b.row_len) if t is not None)


def bin_bytes(b) -> int:
    """Bytes of the bin's index and value planes and its tables."""
    return sum(t.numel() * t.element_size()
               for t in (b.ja, *_planes(b), *_tables(b)))


def bin_counts(b) -> tuple:
    """The bin's real entries, the distinct x entries they read and the y
    rows they write."""
    shape, cols, keep, _ = S._SLOTS[b.layout](b)
    v = _planes(b)[0]
    vals = v[..., 0] if v.dim() == 3 else v
    real = vals.reshape(shape) != 0
    if keep is not None:
        real = real & keep
    if getattr(b, "row_table", None) is not None:
        n_y = int(((b.row_table >> 10) > 0).sum())
    else:
        n_y = int(real.reshape(b.n_groups, -1, 8, 128).any(1).sum())
    return int(real.sum()), int(torch.unique(cols[real]).numel()), n_y


def bound_ms(b, value_bytes: int, tables: int) -> tuple:
    nnz, n_x, n_y = bin_counts(b)
    moved = nnz * (value_bytes + 4) + (n_x + n_y) * 4 * tables
    return moved / HBM_BYTES_PER_S * 1e3, nnz


def cusparse_ms(csr, x: np.ndarray, dtype, dev) -> float:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.row_ptr.astype(np.int32)),
            torch.from_numpy(csr.col_idx.astype(np.int32)),
            torch.from_numpy(csr.values).to(dtype), size=csr.shape,
            device=dev, check_invariants=False)
        xv = torch.from_numpy(x).to(dtype).to(dev)
        return device_time_fn(lambda: A @ xv, device=dev) * 1e3


def _variant_rows(name, i, b, xh, xl, n, variants, dev) -> None:
    """Each layout of compacted bin ``b`` under each variant kernel of its
    plane width (``variants``: the library, the kernels' registers and
    spills, the variants and layouts to run and the rounds): equal to the
    package's kernel bit for bit, timed alone and within a one-bin SpMV,
    the rounds in turn."""
    lib, usage, names, layouts, rounds = variants
    x2 = D.pack_x_pair(xh, xl)
    want = [torch.zeros(n, device=dev) for _ in range(2)]
    D.k_major_bin_dd(b, xh, xl, *want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rnd, (window, plane) in ((r, wp) for r in range(rounds)
                                 for wp in layouts):
        lay = relayout(b, window, plane)
        nbytes = sum(t.numel() * t.element_size() for t in (
            lay.ja, lay.as_pair, lay.row_table, lay.plane_off))
        head = [t.data_ptr() for t in (lay.group_ids, lay.plane_off,
                                       lay.row_table, lay.ja)]
        for vname in names:
            policy, batch, gf, p = VARIANTS[vname]
            if p != plane:
                continue
            fn = getattr(lib, vname)

            def launch(yh, yl, x_pair, fn=fn, policy=policy, vname=vname):
                mid = ((lay.as_pair, x_pair) if policy == "pairs"
                       else (lay.hi, lay.lo, xh, xl))
                err = fn(*head, *(t.data_ptr() for t in (*mid, yh, yl)),
                         b.n_groups, 0, stream)
                if err:
                    raise RuntimeError(f"{vname}: cudaError {err}")

            ys = [torch.zeros(n, device=dev) for _ in range(2)]
            launch(*ys, x2)
            if not all(torch.equal(g, w) for g, w in zip(ys, want)):
                raise RuntimeError(f"{name} bin {i}: variant {vname} on "
                                   f"layout {window}/{plane} differs from "
                                   "the package's kernel")
            ms = device_time_fn(launch, *ys, x2, device=dev) * 1e3

            def spmv(policy=policy, launch=launch):
                yh, yl = (torch.zeros(n, device=dev) for _ in range(2))
                launch(yh, yl, D.pack_x_pair(xh, xl) if policy == "pairs"
                       else None)

            spmv_ms = device_time_fn(spmv, device=dev) * 1e3
            regs, spill = usage[vname]
            print(json.dumps({
                "matrix": name, "precision": "dd", "bin": i, "round": rnd,
                "window": window, "plane": plane, "bytes": nbytes,
                "variant": vname, "policy": policy, "batch": batch,
                "gather_first": gf, "registers": regs, "spill_bytes": spill,
                "ms": ms, "spmv_ms": spmv_ms}), flush=True)
        del lay


def sweep(name: str, variants, dev) -> None:
    t0 = time.perf_counter()
    csr = CSRMatrix.from_coo(MATRICES[name]())
    sell = SellMatrix.from_csr(csr, layout="k-major")
    x = np.random.default_rng(4).standard_normal(csr.ncols)
    print(f"[{name}] {csr.nrows} rows, {csr.nnz} nnz; bins "
          f"{[(b.layout, b.k, b.n_groups) for b in sell.bins]}; set-up "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    for precision in PRECISIONS:
        if precision == "dd":
            d = D.device_put_sell_dd(sell, device=dev)
            xs = D.device_put_x_dd(x, csr.ncols, device=dev)
            spmv, lib_dtype, tables = D.sell_spmv_dd, torch.float64, 2
        else:
            d = S.device_put_sell(sell, torch.bfloat16 if precision == "bf16"
                                  else torch.float32, device=dev)
            xs = (S.device_put_x(x, csr.ncols, device=dev),)
            spmv, lib_dtype, tables = S.sell_spmv, torch.float32, 1
        n = d.num_groups * 1024
        for i, b in enumerate(d.bins):
            ys = [torch.zeros(n, device=dev) for _ in xs]
            if precision == "dd":
                kw = {"x_pair": D.pack_x_pair(*xs)} if D._pairs(b) else {}
                ms = device_time_fn(lambda: D.k_major_bin_dd(b, *xs, *ys,
                                                             **kw),
                                    device=dev) * 1e3
            else:
                ms = device_time_fn(S.k_major_bin, b, *xs, *ys,
                                    device=dev) * 1e3
            vb = sum(v.element_size() * (v.shape[-1] if v.dim() == 3 else 1)
                     for v in _planes(b))
            lo, nnz = bound_ms(b, vb, tables)
            compacted = getattr(b, "row_table", None) is not None
            print(json.dumps({
                "matrix": name, "precision": precision, "bin": i,
                "k": b.k, "groups": b.n_groups,
                "lanes": S._k_major_lanes(b), "compacted": compacted,
                "nnz": nnz, "bytes": bin_bytes(b), "ms": ms,
                "bound_ms": lo, "share": lo / ms}), flush=True)
            if variants and precision == "dd" and compacted:
                _variant_rows(name, i, b, *xs, n, variants, dev)
        ms = device_time_fn(spmv, d, *xs, device=dev) * 1e3
        print(json.dumps({
            "matrix": name, "precision": precision, "spmv_ms": ms,
            "cusparse_ms": cusparse_ms(csr, x, lib_dtype, dev)}), flush=True)
        del d, xs
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--matrices", "--variants", "--layouts",
                                     "--rounds"}:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kmajor_dd_sweep: torch.cuda.is_available() is false: the "
              "sweep times the CUDA kernels", file=sys.stderr)
        return 1
    matrices = opts.get("--matrices", ",".join(MATRICES)).split(",")
    dev = torch.device("cuda", 0)
    _build.load()
    variants = None
    if opts.get("--variants"):
        names = (list(VARIANTS) if opts["--variants"] == "1"
                 else opts["--variants"].split(","))
        layouts = (LAYOUTS if "--layouts" not in opts else tuple(
            tuple(int(v) for v in wp.split("/"))
            for wp in opts["--layouts"].split(",")))
        variants = (*build_variants(), names, layouts,
                    int(opts.get("--rounds", 1)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip(), flush=True)
    if variants:
        print(json.dumps({"variant_usage": variants[1]}), flush=True)
    for name in matrices:
        sweep(name, variants, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
