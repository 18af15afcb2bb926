// y in the caller's row order: the gather after a split, sorted SELL SpMV.
//
// Replaces no TPU kernel. The TPU package returns a sigma-sorted SELL's y in
// sorted order and leaves the caller to undo it on the host
// (formats/sell.py `SellMatrix.unpermute`), and its harness adds the
// segments of split heavy rows on the host too. The port converts
// heavy-tailed matrices that way by default (formats/sell_order.py): rows
// of more than 256 entries split into segments, then sorted by length. So
// a matvec must hand back y in the caller's order on the device; this
// kernel is that step, one launch after the plan's.
//
//   row_gather_f32: y[r] = src[pos[ptr[r]]] + ... + src[pos[ptr[r+1]-1]],
//     added in order in f32 from +0 (each add rounded to nearest, nothing
//     to contract), so a row of one segment is its segment's sum and a row
//     with none (no entry) is +0, whatever the kernels wrote anywhere.
//   row_gather_dd: the same over (hi, lo) pairs, dd::add_dd(acc, segment)
//     onto (0, 0), as panel_reduce_dd adds column panels' slices.
//
// What bounds it on an H100: bytes. A row reads 8 B of ptr, 4 B of pos and
// 4 B (dd 8 B) of src a segment, and writes 4 B (8 B) of y, all coalesced
// but src, which the sort scatters (a 32 B sector a read at worst; a split
// row's segments lie side by side). GAP's kron graph at SCALE 20: 1,048,576
// rows and some 700,000 segments, about 16 MB, 5 us at 3.35 TB/s, src (4 MB)
// in the 50 MB L2 from the SpMV that wrote it. One thread a row, 256-thread
// blocks; the longest row (a hub of 64k entries, 256 segments) is 256
// dependent adds of neighbouring loads.

#include <cstdint>

#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kDD>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ src_hi,
                  const float* __restrict__ src_lo,
                  const int* __restrict__ ptr, const int* __restrict__ pos,
                  float* __restrict__ y_hi, float* __restrict__ y_lo,
                  int64_t n) {
  const int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int end = __ldg(ptr + r + 1);
  float h = 0.0f, l = 0.0f;
  for (int i = __ldg(ptr + r); i < end; ++i) {
    const int at = __ldg(pos + i);
    if constexpr (kDD) {
      dd::add_dd(h, l, __ldg(src_hi + at), __ldg(src_lo + at));
    } else {
      h = __fadd_rn(h, __ldg(src_hi + at));
    }
  }
  y_hi[r] = h;
  if constexpr (kDD) y_lo[r] = l;
}

template <bool kDD>
int launch(const float* src_hi, const float* src_lo, const int* ptr,
           const int* pos, float* y_hi, float* y_lo, int64_t n,
           void* stream) {
  if (n > 0) {
    row_gather_kernel<kDD>
        <<<unsigned((n + kThreads - 1) / kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(src_hi, src_lo, ptr, pos,
                                                y_hi, y_lo, n);
  }
  return int(cudaGetLastError());
}

}  // namespace

// src: the sorted y; ptr: n + 1 int32; pos: ptr[n] int32; y: n f32
extern "C" int row_gather_f32(const float* src, const int* ptr,
                              const int* pos, float* y, int64_t n,
                              void* stream) {
  return launch<false>(src, nullptr, ptr, pos, y, nullptr, n, stream);
}

// the same over the (hi, lo) halves of a dd y
extern "C" int row_gather_dd(const float* src_hi, const float* src_lo,
                             const int* ptr, const int* pos, float* y_hi,
                             float* y_lo, int64_t n, void* stream) {
  return launch<true>(src_hi, src_lo, ptr, pos, y_hi, y_lo, n, stream);
}
