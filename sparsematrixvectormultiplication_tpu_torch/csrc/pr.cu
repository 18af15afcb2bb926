// PR (permutation-routed) SpMV on Hopper, f32 or bf16 values, and
// double-double.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/pallas_pr.py
// `_kernel_pr` (pallas_pr.py:150, whose values may be f32 or bf16) and
// ops/pallas_pr_dd.py `_kernel_pr_dd` (pallas_pr_dd.py:114). A PR problem
// holds its entries in global column order: source slot s = r*128 + l of the
// (n_rows, 128) planes carries value `val[s]` and `md[s]`, and gathers
// x[128*row_slab[r] + (md[s] & 127)]. The TPU kernel forms every product in
// that order, moves the products to a sigma-ordered k-major slot array by
// 2*log2(n_rows)-1 Benes exchange stages and a final lane gather, and sums
// each row's K slots per bin. Its window classes (tile_base, tile_far, the
// md >> 7 deltas) exist because a TPU gathers only within lanes; a GPU
// thread reads x directly, so they are not read here.
//
// The routing is a fixed permutation of a fixed matrix, so the upload
// (ops/pr.py) applies it once, on the device: it composes the stages and
// the lane gather into the source slot `route[dst]` of each destination
// slot and gathers, in destination order, the column
// `dst_col[dst] = 128*row_slab[route[dst] >> 7] + (md[route[dst]] & 127)`
// and the value `dst_val[dst] = val[route[dst]]` (dd: one interleaved
// (hi, lo) float2 plane). The kernel never reads `route`. The planes cover
// the destination rows the bins use (off + K*8*G of the last bin).
//
// Design: one launch per PR problem, one 128-thread block per (group,
// row-block) of the problem's y and one thread per output row, as in the
// k-major SELL kernel. A block finds its bin (K, G, off, g0) in the
// problem's small bin table (bins are contiguous in g0), and thread j sums
// the K slots dst = (off + (gg*K + k)*8 + i)*128 + j of its row, in k
// order: `dst_val[dst] * x[dst_col[dst]]` by the sum policies of
// sell_common.cuh (f32: one fmaf per slot, bf16 widened on load; dd:
// dd::mul_dd, which is dd.cuh's two_prod plus the cross terms of
// pallas_pr_dd.py:121-126 and a renormalisation, then the same dd::add_dd
// chain from (0, 0) over K as the TPU kernel). The column and value loads
// of a chunk of kChunk slots are issued before its x gathers, so a thread
// has up to 2*kChunk loads in flight; the sums still run in k order, so y
// equals the one-slot-at-a-time loop bit for bit. Every y element of the
// problem is written once, with a plain store.
//
// What bounds it on an H100: bytes. Per padded destination slot the kernel
// reads a 4 B column and the value (f32 4 B, bf16 2, dd 8), both coalesced
// (thread j reads lane j of a 128-slot row), then gathers x from a table
// that stays in the 50 MB L2 (webbase_like(1M)'s is ~4.0 MB, two in dd).
// The suite's webbase_like(1M) after the harness's heavy-row split is 2
// problems of 16,384 Benes rows; their destination planes are 8 B (f32) or
// 12 B (dd) a slot, against ~16 B and ~20 B of random sector traffic when
// `val` and `md` were read at `route`. About 2 FLOP a slot (f32) or ~20
// (dd) leave the FLOP bound far below. The routed planes cost no bytes per
// call: they are built once at upload, where the previous design read
// `route` (4 B a slot) on every call. Measured times are in PERF.md.

#include "sell_common.cuh"

namespace pr {

using sell::kGroupRows;
using sell::kLanes;
using sell::kSublanes;

constexpr int kChunk = 8;  // slots whose loads are in flight together

// The destination-order value plane of each precision, loaded in one piece
// and added by the arithmetic of sell_common.cuh's F32Sum / DDSum.
template <typename T>
struct F32Dst : sell::F32Sum<T> {
  using Val = T;
  __device__ __forceinline__ Val load(int64_t off) const {
    return __ldg(this->as + off);
  }
  __device__ __forceinline__ void add(float& acc, Val v, int col) const {
    acc = fmaf(sell::widen(v), __ldg(this->x + col), acc);
  }
};

struct DDDst : sell::DDSum {
  using Val = float2;  // (hi, lo)
  const float2* as2;
  __device__ __forceinline__ Val load(int64_t off) const {
    return __ldg(as2 + off);
  }
  __device__ __forceinline__ void add(Acc& acc, Val v, int col) const {
    float ph, pl;
    dd::mul_dd(v.x, v.y, __ldg(x_hi + col), __ldg(x_lo + col), ph, pl);
    dd::add_dd(acc.hi, acc.lo, ph, pl);
  }
};

// bins: n_bins rows of (K, G, off, g0), g0 ascending and contiguous.
template <typename Sum>
__global__ void __launch_bounds__(kLanes)
pr_kernel(const int* __restrict__ bins, int n_bins,
          const int* __restrict__ dst_col, Sum sum) {
  const int g = blockIdx.x / kSublanes;
  const int i = blockIdx.x % kSublanes;
  const int j = threadIdx.x;
  int b = 0;
  while (b + 1 < n_bins && __ldg(bins + 4 * (b + 1) + 3) <= g) ++b;
  const int K = __ldg(bins + 4 * b);
  const int64_t off = __ldg(bins + 4 * b + 2);
  const int64_t gg = g - __ldg(bins + 4 * b + 3);
  constexpr int64_t kStep = int64_t(kSublanes) * kLanes;
  // destination slot of k: (off + (gg*K + k)*8 + i)*128 + j
  const int64_t dst0 = ((off + gg * K * kSublanes + i) * kLanes) + j;
  typename Sum::Acc acc = sum.zero();
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    int col[kChunk];
    typename Sum::Val v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (k0 + u < K) {
        const int64_t dst = dst0 + (k0 + u) * kStep;
        col[u] = __ldg(dst_col + dst);
        v[u] = sum.load(dst);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (k0 + u < K) sum.add(acc, v[u], col[u]);
    }
  }
  sum.store(acc, int64_t(g) * kGroupRows + i * kLanes + j, 0);
}

template <typename Sum>
int launch(const int* bins, int n_bins, const int* dst_col, Sum sum,
           int64_t n_groups, void* stream) {
  if (n_groups > 0 && n_bins > 0) {
    pr_kernel<Sum><<<dim3(unsigned(n_groups * kSublanes)), kLanes, 0,
                     static_cast<cudaStream_t>(stream)>>>(bins, n_bins,
                                                          dst_col, sum);
  }
  return int(cudaGetLastError());
}

}  // namespace pr

extern "C" int pr_spmv_f32(const int* bins, int n_bins, const int* dst_col,
                           const float* dst_val, const float* x, float* y,
                           int64_t n_groups, void* stream) {
  return pr::launch(bins, n_bins, dst_col,
                    pr::F32Dst<float>{{dst_val, x, y}}, n_groups, stream);
}

extern "C" int pr_spmv_bf16(const int* bins, int n_bins, const int* dst_col,
                            const __nv_bfloat16* dst_val, const float* x,
                            float* y, int64_t n_groups, void* stream) {
  return pr::launch(bins, n_bins, dst_col,
                    pr::F32Dst<__nv_bfloat16>{{dst_val, x, y}}, n_groups,
                    stream);
}

// dst_val: (hi, lo) pairs, 8 B a slot
extern "C" int pr_spmv_dd(const int* bins, int n_bins, const int* dst_col,
                          const float2* dst_val, const float* x_hi,
                          const float* x_lo, float* y_hi, float* y_lo,
                          int64_t n_groups, void* stream) {
  return pr::launch(
      bins, n_bins, dst_col,
      pr::DDDst{{nullptr, nullptr, x_hi, x_lo, y_hi, y_lo}, dst_val},
      n_groups, stream);
}
