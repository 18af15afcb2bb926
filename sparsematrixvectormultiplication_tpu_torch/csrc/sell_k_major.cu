// k-major SELL-C-128 SpMV on Hopper.
//
// Replaces the TPU kernel sparsematrixvectormultiplication_tpu/ops/pallas_sell.py
// `_kernel_k_major`. Entry k of local row i*128+j of bin group g sits at plane
// row (g*K + k)*8 + i, lane j; `ja` holds its absolute column and `as` its
// value (f32 or bf16). The TPU kernel enumerated the group's distinct x slabs
// and masked a lane gather per slab because a TPU core can only gather within
// a 128-lane row; a GPU thread gathers x[col] directly, so the slab lists are
// not read here.
//
// What bounds it on an H100: bytes. Every padded slot streams its value
// (4 B f32, 2 B bf16) and its 4-byte column once; x (4 B per column) is
// re-read through L1/L2 and stays resident in the 50 MB L2 at the slice's
// sizes. Design: one thread per row, 128-thread blocks, one block per
// (group, row-block); neighbouring threads read neighbouring addresses of each
// plane row, so both streams coalesce. Sums are f32 whatever the value type.
// Rows within a bin are unique and bins run in order on one stream, so y is
// written with a plain store, or, with `accumulate` (the sg far-remainder
// bins and column panels), read and added onto without atomics.

#include "sell_common.cuh"

namespace sell {

template <typename T>
__global__ void __launch_bounds__(kLanes)
k_major_kernel(const int* __restrict__ group_ids, const int* __restrict__ ja,
               const T* __restrict__ as, const float* __restrict__ x,
               float* __restrict__ y, int K, int accumulate) {
  const int64_t g = blockIdx.x / kSublanes;
  const int i = blockIdx.x % kSublanes;
  const int j = threadIdx.x;
  const int64_t stride = int64_t(kSublanes) * kLanes;  // from entry k to k+1
  int64_t off = (g * K * kSublanes + i) * kLanes + j;
  float acc = 0.f;
  for (int k = 0; k < K; ++k, off += stride) {
    acc += widen(as[off]) * x[ja[off]];
  }
  float* out = y + int64_t(group_ids[g]) * kGroupRows + i * kLanes + j;
  *out = accumulate ? *out + acc : acc;
}

template <typename T>
int launch_k_major(const int* group_ids, const int* ja, const T* as,
                   const float* x, float* y, int64_t n_groups, int K,
                   int accumulate, void* stream) {
  if (n_groups > 0) {
    k_major_kernel<T><<<dim3(unsigned(n_groups * kSublanes)), kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(group_ids, ja, as,
                                                             x, y, K,
                                                             accumulate);
  }
  return int(cudaGetLastError());
}

}  // namespace sell

extern "C" int sell_k_major_f32(const int* group_ids, const int* ja,
                                const float* as, const float* x, float* y,
                                int64_t n_groups, int K, int accumulate,
                                void* stream) {
  return sell::launch_k_major<float>(group_ids, ja, as, x, y, n_groups, K,
                                     accumulate, stream);
}

extern "C" int sell_k_major_bf16(const int* group_ids, const int* ja,
                                 const __nv_bfloat16* as, const float* x,
                                 float* y, int64_t n_groups, int K,
                                 int accumulate, void* stream) {
  return sell::launch_k_major<__nv_bfloat16>(group_ids, ja, as, x, y,
                                             n_groups, K, accumulate, stream);
}
