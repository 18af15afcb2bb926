// Column panels: the panels' partial rows added into y, f32 and
// double-double.
//
// Replaces no TPU kernel: it takes the place of the TPU package's panel loop
// (sparsematrixvectormultiplication_tpu/ops/pallas_sell.py `_panel_spmv`,
// and the panels of ops/pallas_sell_dd.py `sell_spmv_pallas_dd`), which
// packs an x table for each panel and runs each panel's bins one after
// another, every bin adding onto one y aliased from call to call. On the
// H100 those bins are a few groups each, so each launch fills a few of the
// 132 SMs and the next waits for it. The port's plan (ops/sell.py
// `_panel_plan`) instead runs the bins of every panel that share a kernel
// as one launch, each bin storing its rows into its own slice of a scratch
// y: slice s holds panel p's core bins, or one of its add_into bins, panel
// by panel and in each panel the core slice first. This kernel then adds,
// for each row r of group g, the slices that hold g (cover[s, g] != 0, a
// table built at upload) in slice order onto 0:
//   f32: acc = acc + part (the kernels' accumulating store, y[row] + acc);
//   dd:  dd::add_dd(acc, part), acc first, as DDSum::store adds a sum onto y.
// So y equals the panel-by-panel accumulation onto a zeroed y bit for bit,
// the sign of a zero sum included: 0 + s and add_dd((0, 0), s) come first
// in both.
//
// What bounds it on an H100: bytes, the covered slices' rows read once
// (4 B, dd 8 B) and y written once; one thread a row, a 256-thread block
// on 256 neighbouring rows of one group, so every load and store coalesces
// and a block reads its group's cover entries once each, from L1.

#include <cstdint>

#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kGroupRows = 1024;

template <bool kDD>
__global__ void __launch_bounds__(kThreads)
panel_reduce_kernel(const float* __restrict__ parts_hi,
                    const float* __restrict__ parts_lo,
                    const uint8_t* __restrict__ cover, float* __restrict__ y_hi,
                    float* __restrict__ y_lo, int64_t n_groups, int slices) {
  const int64_t n = n_groups * kGroupRows;
  const int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int64_t g = r / kGroupRows;
  float h = 0.f, l = 0.f;
  for (int s = 0; s < slices; ++s) {
    if (__ldg(cover + int64_t(s) * n_groups + g)) {
      const int64_t at = int64_t(s) * n + r;
      if constexpr (kDD) {
        dd::add_dd(h, l, __ldg(parts_hi + at), __ldg(parts_lo + at));
      } else {
        h = __fadd_rn(h, __ldg(parts_hi + at));
      }
    }
  }
  y_hi[r] = h;
  if constexpr (kDD) y_lo[r] = l;
}

template <bool kDD>
int launch(const float* parts_hi, const float* parts_lo, const uint8_t* cover,
           float* y_hi, float* y_lo, int64_t n_groups, int slices,
           void* stream) {
  const int64_t n = n_groups * kGroupRows;
  if (n > 0) {
    panel_reduce_kernel<kDD>
        <<<dim3(unsigned((n + kThreads - 1) / kThreads)), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(parts_hi, parts_lo, cover,
                                                y_hi, y_lo, n_groups, slices);
  }
  return int(cudaGetLastError());
}

}  // namespace

// parts: (slices, n_groups*1024) f32; cover: (slices, n_groups) uint8;
// y: n_groups*1024 f32
extern "C" int panel_reduce_f32(const float* parts, const uint8_t* cover,
                                float* y, int64_t n_groups, int slices,
                                void* stream) {
  return launch<false>(parts, nullptr, cover, y, nullptr, n_groups, slices,
                       stream);
}

// the hi and lo planes of the slices and of y
extern "C" int panel_reduce_dd(const float* parts_hi, const float* parts_lo,
                               const uint8_t* cover, float* y_hi, float* y_lo,
                               int64_t n_groups, int slices, void* stream) {
  return launch<true>(parts_hi, parts_lo, cover, y_hi, y_lo, n_groups, slices,
                      stream);
}
