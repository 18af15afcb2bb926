// SG (shared-window) SELL SpMV on Hopper, for scattered short-row matrices.
//
// Replaces the TPU kernel sparsematrixvectormultiplication_tpu/ops/pallas_sell.py
// `_kernel_sg`. A bin group g holds T tiles of (8, 128) slots; slot (p, j) of
// tile t sits at plane row (g*T + t)*8 + p, lane j. Its index word
// md = (doff*8 + sigma)*128 + m names column 128*(w0 + doff) + m, with the
// tile's window base w0 = table[g, t*stride] (stride 2 for dynamic bins,
// whose table also holds pass counts, else 1). Its product lands on row
// sigma*128 + j of the group: sigma = md bits 7-9 in slots mode, or the
// position p itself in rows mode. Only the first slab_count[g] tiles are
// real; padding tiles hold zero values and are not read. The TPU kernel
// swept the window in V masked passes because a TPU core gathers only within
// a 128-lane row; the static V and the dynamic pass counts bound those
// passes and do not change what an entry computes, so they are not read here.
//
// What bounds it on an H100: bytes and, at small group counts, occupancy.
// Every slot streams its value (4 B f32, 2 B bf16) and its 4-byte md; x is
// re-read through L1/L2. Design: one 1024-thread block per group, thread
// (p, j) walks slot (p, j) of every real tile, so a warp reads 128
// consecutive bytes of each plane row. Slots mode keeps 8 register sums
// selected by sigma and reduces them over p through shared memory in a fixed
// order (no atomics: the f32 sum is the same on every run); rows mode needs
// no reduction. One block per group gives few blocks on small bins: a
// 196-group bin is 196 blocks of 1024 threads for 132 SMs.

#include "sell_common.cuh"

namespace sell {

constexpr int kGroupThreads = kSublanes * kLanes;  // 1024: thread (p, j)

template <typename T, bool kSlots>
__global__ void __launch_bounds__(kGroupThreads)
sg_kernel(const int* __restrict__ group_ids, const int* __restrict__ table,
          const int* __restrict__ counts, const int* __restrict__ ja,
          const T* __restrict__ as, const float* __restrict__ x,
          float* __restrict__ y, int T_tiles, int stride, int accumulate) {
  const int64_t g = blockIdx.x;
  const int p = threadIdx.x / kLanes;
  const int j = threadIdx.x % kLanes;
  const int n_tiles = min(counts[g], T_tiles);
  const int* w0 = table + g * T_tiles * stride;
  int64_t off = (g * T_tiles * kSublanes + p) * kLanes + j;
  const int64_t tile_step = int64_t(kSublanes) * kLanes;
  float acc[kSublanes] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t, off += tile_step) {
    const int md = ja[off];
    const int col = (w0[t * stride] + (md >> 10)) * kLanes + (md & (kLanes - 1));
    const float prod = widen(as[off]) * x[col];
    if constexpr (kSlots) {
      const int sigma = (md >> 7) & (kSublanes - 1);
#pragma unroll
      for (int s = 0; s < kSublanes; ++s) acc[s] += sigma == s ? prod : 0.f;
    } else {
      acc[0] += prod;
    }
  }
  float result;
  if constexpr (kSlots) {
    __shared__ float part[kSublanes][kSublanes][kLanes];  // [p][sigma][j]
#pragma unroll
    for (int s = 0; s < kSublanes; ++s) part[p][s][j] = acc[s];
    __syncthreads();
    result = 0.f;  // this thread now sums row sigma = p over the 8 slots
#pragma unroll
    for (int q = 0; q < kSublanes; ++q) result += part[q][p][j];
  } else {
    result = acc[0];
  }
  float* out = y + int64_t(group_ids[g]) * kGroupRows + p * kLanes + j;
  *out = accumulate ? *out + result : result;
}

template <typename T>
int launch_sg(const int* group_ids, const int* table, const int* counts,
              const int* ja, const T* as, const float* x, float* y,
              int64_t n_groups, int T_tiles, int stride, int slots,
              int accumulate, void* stream) {
  if (n_groups > 0) {
    auto kernel = slots ? sg_kernel<T, true> : sg_kernel<T, false>;
    kernel<<<dim3(unsigned(n_groups)), kGroupThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        group_ids, table, counts, ja, as, x, y, T_tiles, stride, accumulate);
  }
  return int(cudaGetLastError());
}

}  // namespace sell

extern "C" int sell_sg_f32(const int* group_ids, const int* table,
                           const int* counts, const int* ja, const float* as,
                           const float* x, float* y, int64_t n_groups,
                           int T_tiles, int stride, int slots, int accumulate,
                           void* stream) {
  return sell::launch_sg<float>(group_ids, table, counts, ja, as, x, y,
                                n_groups, T_tiles, stride, slots, accumulate,
                                stream);
}

extern "C" int sell_sg_bf16(const int* group_ids, const int* table,
                            const int* counts, const int* ja,
                            const __nv_bfloat16* as, const float* x, float* y,
                            int64_t n_groups, int T_tiles, int stride,
                            int slots, int accumulate, void* stream) {
  return sell::launch_sg<__nv_bfloat16>(group_ids, table, counts, ja, as, x,
                                        y, n_groups, T_tiles, stride, slots,
                                        accumulate, stream);
}
