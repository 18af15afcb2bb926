// k-major SELL-C-128 SpMV on Hopper, f32 and double-double.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/pallas_sell.py
// `_kernel_k_major` and ops/pallas_sell_dd.py `_kernel_k_major_dd`. Entry k
// of local row i*128+j of bin group g sits at plane row (g*K + k)*8 + i,
// lane j; `ja` holds its absolute column and `as` its value (f32 or bf16, or
// a dd hi/lo pair of f32 planes). The TPU kernel enumerated the group's
// distinct x slabs and masked a lane gather per slab because a TPU core can
// only gather within a 128-lane row; a GPU thread gathers x[col] directly,
// so the slab lists are not read here.
//
// What bounds it on an H100: bytes. Every padded slot streams its value
// (4 B f32, 2 B bf16, 8 B dd) and its 4-byte column once; x (4 B per column,
// 8 B dd) is re-read through L1/L2 and stays resident in the 50 MB L2 at the
// slice's sizes. Design: one thread per row, 128-thread blocks, one block per
// (group, row-block); neighbouring threads read neighbouring addresses of each
// plane row, so both streams coalesce. Sums are f32 whatever the value type,
// or dd pairs (sell_common.cuh's sum policies share this decode). A slot
// whose value is zero, a pad among them, adds nothing (the stored-zero rule
// of sell_common.cuh).
//
// A bin of few groups fills few of the 132 SMs that way, and each thread
// walks its row's K slots in one dependent chain (a dd add a slot). So below
// about two waves of blocks the bin's rows are split over lanes
// (ops/sell.py `_k_major_lanes`, a function of n_groups and K only): G
// lanes, a power of two up to 32, of one warp own a row, lane p takes the
// row's slots k = p, p + G, p + 2G, ... in order onto its own sum, and the
// lanes join their sums by __shfl_xor_sync over distances 1, 2, ..., G/2,
// the lower lane's sum first (Sum::combine), so the row's sum is the same
// fixed pairwise tree on every run; its first lane writes y. A block then
// covers 128/G rows, and the bin launches n_groups * 8 * G blocks. Bins at
// or above the threshold run with G = 1, the path above, or in dd the
// compacted path below.
//
// A dd bin of one thread a row streamed its pads at 12 B a slot and at the
// card's read rate: on banded(250_000, 64, 64) 21% of its K = 64 slots were
// pads, since K is the longest row of each group. Those bins are compacted
// at upload (ops/sell.py `_compact_km`: the rows of each 128-row block
// sorted by their real length, a row's real slots in k order, one plane per
// 32 sorted rows, hi and lo value planes) and run by the row-list kernel of
// sell_common.cuh with the DDSum policy (`sell_k_major_dd_list`), a block
// on the 128 rows the padded kernel's block ran: a real slot's two 4-byte
// values and its 4-byte column, 4 slots a batch, then the batch's x pairs
// gathered from the two x tables before its adds. Measured on the H100
// (bench/kmajor_dd_sweep.py): rows sorted within their block, whose x
// gathers and y stores lie near each other, ran 1-7% faster than rows
// sorted within their group, and the two x tables spared the launch of the
// interleaved table that one (hi, lo) pair a slot (DDPairs) needs, for a
// faster whole SpMV. A row's real slots are added in the order the padded
// kernel adds them, and a pad added (0, 0) there, which leaves a
// normalised pair as it was, so the two layouts give the same sums bit for
// bit.
//
// Rows within a bin are unique and bins run in order on one stream, so y is
// written with a plain store, or, with `accumulate` (the sg far-remainder
// bins and column panels), read and added onto without atomics.

#include "sell_common.cuh"

namespace sell {

// kSplit: the rows' slots are split over `lanes` lanes (a power of two, at
// most 32); otherwise one thread a row
constexpr int kSplitBatch = 4;  // a split lane's slots in flight together
// a compacted dd row's slots in flight together, its x gathered after them
constexpr int kKmListBatch = 4;

template <typename Sum, bool kSplit>
__global__ void __launch_bounds__(kLanes)
k_major_kernel(const int* __restrict__ group_ids, const int* __restrict__ ja,
               Sum sum, int K, int lanes, int accumulate) {
  const int G = kSplit ? lanes : 1;
  const int p = kSplit ? int(threadIdx.x) & (G - 1) : 0;  // the row's lane
  // the bin's row g*1024 + i*128 + j
  const int64_t r = int64_t(blockIdx.x) * (kLanes / G) + threadIdx.x / G;
  const int64_t g = r / kGroupRows;
  const int i = int(r / kLanes) % kSublanes;
  const int j = int(r % kLanes);
  const int64_t stride = int64_t(kSublanes) * kLanes;  // from entry k to k+1
  int64_t off = ((g * K + p) * kSublanes + i) * kLanes + j;
  typename Sum::Acc acc = sum.zero();
  if constexpr (!kSplit) {
    for (int k = 0; k < K; ++k, off += stride) {
      sum.add(acc, off, ja[off]);
    }
  } else {
    // the lane's slots k = p, p + G, ..., kSplitBatch of them loaded before
    // they are added, in order
    constexpr int B = kSplitBatch;
    const int64_t step = int64_t(G) * stride;
    for (int k0 = p; k0 < K; k0 += B * G, off += B * step) {
      int col[B];
      typename Sum::Val v[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (k0 + u * G < K) {
          col[u] = __ldg(ja + off + u * step);
          v[u] = sum.load(off + u * step);
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (k0 + u * G < K) sum.add(acc, v[u], col[u]);
      }
    }
    for (int m = 1; m < G; m <<= 1) {
      const typename Sum::Acc other = shfl_xor(acc, m);
      acc = p & m ? Sum::combine(other, acc) : Sum::combine(acc, other);
    }
    if (p != 0) return;
  }
  sum.store(acc, int64_t(group_ids[g]) * kGroupRows + i * kLanes + j,
            accumulate);
}

template <typename Sum>
int launch_k_major(const int* group_ids, const int* ja, Sum sum,
                   int64_t n_groups, int K, int lanes, int accumulate,
                   void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1))) {
    return int(cudaErrorInvalidValue);
  }
  if (n_groups > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid(unsigned(n_groups * kSublanes * lanes));
    if (lanes == 1) {
      k_major_kernel<Sum, false><<<grid, kLanes, 0, s>>>(group_ids, ja, sum,
                                                         K, 1, accumulate);
    } else {
      k_major_kernel<Sum, true><<<grid, kLanes, 0, s>>>(group_ids, ja, sum, K,
                                                        lanes, accumulate);
    }
  }
  return int(cudaGetLastError());
}

}  // namespace sell

// lanes: the lanes a row (ops/sell.py `_k_major_lanes`), 1 for one thread a
// row
extern "C" int sell_k_major_f32(const int* group_ids, const int* ja,
                                const float* as, const float* x, float* y,
                                int64_t n_groups, int K, int lanes,
                                int accumulate, void* stream) {
  return sell::launch_k_major(group_ids, ja,
                              sell::F32Slots<float>{{as, x, y}}, n_groups, K,
                              lanes, accumulate, stream);
}

extern "C" int sell_k_major_bf16(const int* group_ids, const int* ja,
                                 const __nv_bfloat16* as, const float* x,
                                 float* y, int64_t n_groups, int K, int lanes,
                                 int accumulate, void* stream) {
  return sell::launch_k_major(group_ids, ja,
                              sell::F32Slots<__nv_bfloat16>{{as, x, y}},
                              n_groups, K, lanes, accumulate, stream);
}

extern "C" int sell_k_major_dd(const int* group_ids, const int* ja,
                               const float* as_hi, const float* as_lo,
                               const float* x_hi, const float* x_lo,
                               float* y_hi, float* y_lo, int64_t n_groups,
                               int K, int lanes, int accumulate,
                               void* stream) {
  return sell::launch_k_major(
      group_ids, ja, sell::DDSum{as_hi, as_lo, x_hi, x_lo, y_hi, y_lo},
      n_groups, K, lanes, accumulate, stream);
}

// the compacted planes of a bin of one lane a row: group_ids, plane_off,
// row_table, ja, then the hi/lo value planes, x tables and y
extern "C" int sell_k_major_dd_list(const int* group_ids,
                                    const int* plane_off,
                                    const int* row_table, const int* ja,
                                    const float* as_hi, const float* as_lo,
                                    const float* x_hi, const float* x_lo,
                                    float* y_hi, float* y_lo,
                                    int64_t n_groups, int accumulate,
                                    void* stream) {
  return sell::launch_row_list<sell::DDSum, sell::kKmListBatch, true>(
      group_ids, plane_off, row_table, ja,
      sell::DDSum{as_hi, as_lo, x_hi, x_lo, y_hi, y_lo}, n_groups,
      accumulate, stream);
}
