// The double-double SpMV's x split and y join: fp64 x into the f32 (hi, lo)
// tables the dd kernels gather from, and the (hi, lo) y pair back to fp64.
//
// Replaces no TPU kernel. The TPU package splits x and joins y with XLA
// elementwise ops around its dd kernels (ops/pallas_sell_dd.py
// `sell_spmv_dd_f64`), and the port's wrapper (ops/sell_dd.py
// `sell_spmv_dd_f64`) did the same with PyTorch ops: 9 launches for x
// (`x64.float()`, `.double()`, the subtraction, `.float()`; a zero fill and a
// slice copy for each padded table; the interleaved pair table) and 3 for y
// (two `.double()` and an add). On an H100 each such launch costs the host
// more than the card, and the host paces an fp64 x stream, so the two
// kernels below take their place, one launch each.
//
//   dd_prepare_x: for c < rows, v = c < ncols ? x[c] : 0,
//     hi = __double2float_rn(v), lo = __double2float_rn(v - (double)hi),
//     the rounding of `x64.float()` and `(x64 - hi.double()).float()`, so
//     pad slots hold (+0, +0) as the zero-filled tables did; written as the
//     interleaved (hi, lo) pair table, as the two tables, or both, as the
//     launch plan's bins read x.
//   dd_join_y: y[i] = (double)hi[i] + (double)lo[i], `combine_f64`.
//
// Every operation is one IEEE operation rounded to nearest (no multiply, so
// nothing to contract), so both equal the PyTorch ops bit for bit.
//
// What bounds them on an H100: bytes, 8 B of x read and 8 B (pairs) or 16 B
// (pairs and tables) written a column; 8 B read and 8 B written a row of y.
// fem3d_cube's 648,000 columns are about 10 MB, a few microseconds at
// 3.35 TB/s. One thread an entry, 256-thread blocks, so every load and store
// coalesces; a pointer left null is not written.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
prepare_x_kernel(const double* __restrict__ x, int64_t ncols, int64_t rows,
                 float2* __restrict__ pair, float* __restrict__ hi,
                 float* __restrict__ lo) {
  const int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= rows) return;
  const double v = c < ncols ? __ldg(x + c) : 0.0;
  const float h = __double2float_rn(v);
  const float l = __double2float_rn(__dsub_rn(v, double(h)));
  if (pair != nullptr) pair[c] = make_float2(h, l);
  if (hi != nullptr) {
    hi[c] = h;
    lo[c] = l;
  }
}

__global__ void __launch_bounds__(kThreads)
join_y_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
              double* __restrict__ y, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  y[i] = __dadd_rn(double(__ldg(hi + i)), double(__ldg(lo + i)));
}

unsigned blocks(int64_t n) { return unsigned((n + kThreads - 1) / kThreads); }

}  // namespace

// x: ncols fp64; pair: rows (hi, lo) f32 pairs or null; hi, lo: rows f32
// each, or both null; rows >= ncols
extern "C" int dd_prepare_x(const double* x, int64_t ncols, int64_t rows,
                            float* pair, float* hi, float* lo, void* stream) {
  if (rows > 0) {
    prepare_x_kernel<<<blocks(rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        x, ncols, rows, reinterpret_cast<float2*>(pair), hi, lo);
  }
  return int(cudaGetLastError());
}

// hi, lo: n f32; y: n fp64
extern "C" int dd_join_y(const float* hi, const float* lo, double* y,
                         int64_t n, void* stream) {
  if (n > 0) {
    join_y_kernel<<<blocks(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(hi, lo, y, n);
  }
  return int(cudaGetLastError());
}
