// PR (permutation-routed) SpMV on Hopper, f32 or bf16 values, and
// double-double.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/pallas_pr.py
// `_kernel_pr` (whose values may be f32 or bf16, pallas_pr.py:104) and
// ops/pallas_pr_dd.py `_kernel_pr_dd`. bf16 values are widened to f32 on
// load (sell_common.cuh's F32Sum<__nv_bfloat16>); x and the sums stay f32,
// as in the bf16 SELL kernels, where the TPU kernel summed in the value
// type. A bf16 slot reads 2 B of value instead of 4, 10 B per slot with md
// and route instead of 12. A PR problem holds
// its entries in global column order: source slot s = r*128 + l of the
// (n_rows, 128) planes carries value `val[s]` and `md[s]`, and gathers
// x[128*row_slab[r] + (md[s] & 127)]. The TPU kernel forms every product in
// that order, moves the products to a sigma-ordered k-major slot array by
// 2*log2(n_rows)-1 Benes exchange stages and a final lane gather, and sums
// each row's K slots per bin. Its window classes (tile_base, tile_far, the
// md >> 7 deltas) exist because a TPU gathers only within lanes; a GPU
// thread reads x directly, so they are not read here. The upload
// (ops/pr.py) composes the stages and the lane gather into one int32 plane:
// route[r, l] is the source slot whose product lands at destination (r, l).
//
// Design: one launch per PR problem, one 128-thread block per (group,
// row-block) of the problem's y and one thread per output row, as in the
// k-major SELL kernel. A block finds its bin (K, G, off, g0) in the
// problem's small bin table (bins are contiguous in g0), and thread j sums
// the K slots s = route[(off + (gg*K + k)*8 + i)*128 + j] of its row,
// `val[s] * x[128*row_slab[s >> 7] + (md[s] & 127)]`, through the sum
// policies of sell_common.cuh: f32 (F32Sum), or double-double (DDSum:
// dd::mul_dd, which is dd.cuh's two_prod plus the cross terms of
// pallas_pr_dd.py:121-126 and a renormalisation, then the same dd::add_dd
// chain from (0, 0) over K as the TPU kernel). Every y element of the
// problem is written once, with a plain store.
//
// What bounds it on an H100: bytes. Each padded slot is read once: f32
// 4 B val + 4 B md + 4 B route, dd 8 B val hi/lo + 4 + 4. The suite's
// webbase_like(1M) after the harness's heavy-row split is 2 problems of
// 16,384 rows, 4,194,304 slots: f32 ~50.3 MB of planes + the x table
// (~4.0 MB) + y (~4.3 MB) ~ 58.6 MB, a bound of ~17.5 us at 3.35 TB/s; dd
// ~67 MB of planes + two x tables + two y ~ 84 MB, ~25 us. About 2 FLOP per
// slot (f32) or ~20 (dd) leave the FLOP bound far below.
//
// What the design does about the bytes: route is read coalesced, but val
// and md are read at `route`, a random 4 B out of each 32 B sector. This
// kernel takes that one-phase form: one problem's val and md planes are
// 16.8 MB (f32) or 25.2 MB (dd with val_lo), inside the 50 MB L2, so after
// a sector's first touch its other slots are L2 hits and HBM traffic stays
// near the planes' size; the cost moves to L2 sector traffic (~3 sectors
// per slot f32, ~5 dd, x included). The two-phase form (products gathered
// in column order into a scratch plane, then a routed reduce) would read
// val/md coalesced but write and read one more plane per problem (+4 B per
// slot f32, +8 B dd: ~+33% f32 and ~+50% dd bytes). Measured times are in
// PERF.md.

#include "sell_common.cuh"

namespace pr {

using sell::kGroupRows;
using sell::kLanes;
using sell::kSublanes;

// bins: n_bins rows of (K, G, off, g0), g0 ascending and contiguous.
template <typename Sum>
__global__ void __launch_bounds__(kLanes)
pr_kernel(const int* __restrict__ bins, int n_bins,
          const int* __restrict__ route, const int* __restrict__ md,
          const int* __restrict__ row_slab, Sum sum) {
  const int g = blockIdx.x / kSublanes;
  const int i = blockIdx.x % kSublanes;
  const int j = threadIdx.x;
  int b = 0;
  while (b + 1 < n_bins && __ldg(bins + 4 * (b + 1) + 3) <= g) ++b;
  const int K = __ldg(bins + 4 * b);
  const int64_t off = __ldg(bins + 4 * b + 2);
  const int64_t gg = g - __ldg(bins + 4 * b + 3);
  // destination row of slot k: off + (gg*K + k)*8 + i
  int64_t dst = ((off + gg * K * kSublanes + i) * kLanes) + j;
  typename Sum::Acc acc = sum.zero();
  for (int k = 0; k < K; ++k, dst += int64_t(kSublanes) * kLanes) {
    const int s = __ldg(route + dst);
    const int col = __ldg(row_slab + (s >> 7)) * kLanes + (__ldg(md + s) & 127);
    sum.add(acc, s, col);
  }
  sum.store(acc, int64_t(g) * kGroupRows + i * kLanes + j, 0);
}

template <typename Sum>
int launch(const int* bins, int n_bins, const int* route, const int* md,
           const int* row_slab, Sum sum, int64_t n_groups, void* stream) {
  if (n_groups > 0 && n_bins > 0) {
    pr_kernel<Sum><<<dim3(unsigned(n_groups * kSublanes)), kLanes, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        bins, n_bins, route, md, row_slab, sum);
  }
  return int(cudaGetLastError());
}

}  // namespace pr

extern "C" int pr_spmv_f32(const int* bins, int n_bins, const int* route,
                           const int* md, const int* row_slab,
                           const float* val, const float* x, float* y,
                           int64_t n_groups, void* stream) {
  return pr::launch(bins, n_bins, route, md, row_slab,
                    sell::F32Sum<float>{val, x, y}, n_groups, stream);
}

extern "C" int pr_spmv_bf16(const int* bins, int n_bins, const int* route,
                            const int* md, const int* row_slab,
                            const __nv_bfloat16* val, const float* x, float* y,
                            int64_t n_groups, void* stream) {
  return pr::launch(bins, n_bins, route, md, row_slab,
                    sell::F32Sum<__nv_bfloat16>{val, x, y}, n_groups, stream);
}

extern "C" int pr_spmv_dd(const int* bins, int n_bins, const int* route,
                          const int* md, const int* row_slab,
                          const float* val_hi, const float* val_lo,
                          const float* x_hi, const float* x_lo, float* y_hi,
                          float* y_lo, int64_t n_groups, void* stream) {
  return pr::launch(bins, n_bins, route, md, row_slab,
                    sell::DDSum{val_hi, val_lo, x_hi, x_lo, y_hi, y_lo},
                    n_groups, stream);
}
