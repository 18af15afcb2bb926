// sb-major and sb-list SELL-C-128 SpMV on Hopper, f32 and double-double.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/pallas_sell.py
// `_kernel_sb_major` and `_kernel_sb_list`, and their dd twins
// ops/pallas_sell_dd.py `_kernel_sb_major_dd` and `_kernel_sb_list_dd`. Both
// layouts store entry k of row sb*128+j of bin group g at plane row
// g*8K + sb*K + k, lane j; the K entries of a row are cut into K/ck chunks of
// ck. The index plane is one of
//   int32: the absolute column (sb-major);
//   int16 sb-major (`_pack_sb_i16`): (dq<<7)|m, column 128*(qbase+dq)+m with
//     qbase = table[g, sb*nchunks + c], c = k/ck;
//   int16 sb-list (`_pack_sl_i16`): (js<<7)|m, column
//     128*table[g, (sb*nchunks + c)*span + js] + m.
// A negative dq or js marks a pad: its value is 0 and it reads no x (dq = -1
// on qbase 0 would name column m-128). The TPU kernels scanned a static span
// of slabs per chunk under a mask because a TPU core gathers only within a
// 128-lane row; a GPU thread gathers x[col] directly.
//
// What bounds it on an H100: bytes. Every padded slot streams its value
// (4 B f32, 2 B bf16, 8 B dd) and its index (4 B, or 2 B with int16 planes);
// x and the chunk tables are re-read through L1/L2. Design of the padded
// kernel (sb-major, and sb-list with int16 planes), as in sell_k_major.cu:
// one thread per row, one 128-thread block per (group, row-block); thread j
// reads lane j of consecutive plane rows, so each warp's loads coalesce. The
// int16 sb-major qbase is uniform across the block and read once per chunk.
//
// sb-list with int32 planes runs on compacted planes (ops/sell.py
// `_compact_sl`) through the row-list kernel of sell_common.cuh, because its
// matrices are the short-row ones whose padding dominates the bytes:
// road_network(1_200_000)'s rows hold 1-4 entries, its bins K = 8 (a
// multiple of ck), 3.2 slots an entry, 1.02 after compaction. The int16
// planes stay padded: their 2-byte codes name a slab of the slot's
// (row-block, chunk) list, which the sorting and compaction do not keep; the
// compacted int32 planes move fewer bytes than they do (8 B x 1.02 against
// 6 B x 3.2 slots an entry on road, f32).
//
// A slot whose value is zero adds nothing in every kernel here
// (sell_common.cuh's stored-zero rule), so the compacted kernel equals
// the padded one bit for bit on finite x, up to the sign of a zero sum. Sums
// are f32 whatever the value type (one fmaf a slot, in entry order), or dd
// pairs; the compacted dd kernel reads one 8-byte (hi, lo) value pair a slot
// and the interleaved x table (DDPairs). `accumulate` adds the sum onto y
// (column panels).

#include "sell_common.cuh"

namespace sell {

enum class Decode { kAbsolute, kQbase, kList };

template <typename Sum, typename I, Decode D>
__global__ void __launch_bounds__(kLanes)
sb_kernel(const int* __restrict__ group_ids, const int* __restrict__ table,
          const I* __restrict__ ja, Sum sum, int K, int ck, int span,
          int accumulate) {
  const int64_t g = blockIdx.x / kSublanes;
  const int sb = blockIdx.x % kSublanes;
  const int j = threadIdx.x;
  const int nchunks = K / ck;
  int64_t off = (int64_t(blockIdx.x) * K) * kLanes + j;  // (g*8 + sb)*K rows
  const int* chunk_tab = table + (g * kSublanes + sb) * nchunks *
                                     (D == Decode::kList ? span : 1);
  typename Sum::Acc acc = sum.zero();
  for (int c = 0; c < nchunks; ++c) {
    const int qbase = D == Decode::kQbase ? chunk_tab[c] : 0;
    const int* list = D == Decode::kList ? chunk_tab + c * span : nullptr;
    for (int kk = 0; kk < ck; ++kk, off += kLanes) {
      const int v = ja[off];
      int col;
      if constexpr (D == Decode::kAbsolute) {
        col = v;
      } else {
        const int hi = v >> 7;  // arithmetic: a pad's -1 stays negative
        if (hi < 0) continue;
        int slab;
        if constexpr (D == Decode::kQbase) {
          slab = qbase + hi;
        } else {
          slab = list[hi];
        }
        col = slab * kLanes + (v & (kLanes - 1));
      }
      sum.add(acc, off, col);
    }
  }
  sum.store(acc, int64_t(group_ids[g]) * kGroupRows + sb * kLanes + j,
            accumulate);
}

template <typename I, Decode D, typename Sum>
int launch_sb(const int* group_ids, const int* table, const I* ja, Sum sum,
              int64_t n_groups, int K, int ck, int span, int accumulate,
              void* stream) {
  if (n_groups > 0) {
    sb_kernel<Sum, I, D><<<dim3(unsigned(n_groups * kSublanes)), kLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        group_ids, table, ja, sum, K, ck, span, accumulate);
  }
  return int(cudaGetLastError());
}

}  // namespace sell

// int32 planes hold absolute columns: sb-major gathers x[col] directly.
#define SELL_SB_ENTRY(name, T, I, D)                                          \
  extern "C" int name(const int* group_ids, const int* table, const I* ja,   \
                      const T* as, const float* x, float* y,                 \
                      int64_t n_groups, int K, int ck, int span,             \
                      int accumulate, void* stream) {                        \
    return sell::launch_sb<I, sell::Decode::D>(                              \
        group_ids, table, ja, sell::F32Sum<T>{as, x, y}, n_groups, K, ck,    \
        span, accumulate, stream);                                           \
  }

SELL_SB_ENTRY(sell_sb_major_f32_i32, float, int, kAbsolute)
SELL_SB_ENTRY(sell_sb_major_bf16_i32, __nv_bfloat16, int, kAbsolute)
SELL_SB_ENTRY(sell_sb_major_f32_i16, float, int16_t, kQbase)
SELL_SB_ENTRY(sell_sb_major_bf16_i16, __nv_bfloat16, int16_t, kQbase)
SELL_SB_ENTRY(sell_sb_list_f32_i16, float, int16_t, kList)
SELL_SB_ENTRY(sell_sb_list_bf16_i16, __nv_bfloat16, int16_t, kList)

#define SELL_SB_DD_ENTRY(name, I, D)                                          \
  extern "C" int name(const int* group_ids, const int* table, const I* ja,   \
                      const float* as_hi, const float* as_lo,                \
                      const float* x_hi, const float* x_lo, float* y_hi,     \
                      float* y_lo, int64_t n_groups, int K, int ck,          \
                      int span, int accumulate, void* stream) {              \
    return sell::launch_sb<I, sell::Decode::D>(                              \
        group_ids, table, ja,                                                \
        sell::DDSum{as_hi, as_lo, x_hi, x_lo, y_hi, y_lo}, n_groups, K, ck,  \
        span, accumulate, stream);                                           \
  }

SELL_SB_DD_ENTRY(sell_sb_major_dd_i32, int, kAbsolute)
SELL_SB_DD_ENTRY(sell_sb_major_dd_i16, int16_t, kQbase)
SELL_SB_DD_ENTRY(sell_sb_list_dd_i16, int16_t, kList)

// the compacted sb-list planes (int32 columns): group_ids, plane_off,
// row_table, ja, then the value plane, x and y
extern "C" int sell_sb_list_f32(const int* group_ids, const int* plane_off,
                                const int* row_table, const int* ja,
                                const float* as, const float* x, float* y,
                                int64_t n_groups, int accumulate,
                                void* stream) {
  return sell::launch_row_list(group_ids, plane_off, row_table, ja,
                              sell::F32Slots<float>{{as, x, y}}, n_groups,
                              accumulate, stream);
}

extern "C" int sell_sb_list_bf16(const int* group_ids, const int* plane_off,
                                 const int* row_table, const int* ja,
                                 const __nv_bfloat16* as, const float* x,
                                 float* y, int64_t n_groups, int accumulate,
                                 void* stream) {
  return sell::launch_row_list(group_ids, plane_off, row_table, ja,
                              sell::F32Slots<__nv_bfloat16>{{as, x, y}},
                              n_groups, accumulate, stream);
}

// as2: (hi, lo) value pairs; x2: the interleaved (hi, lo) x table
extern "C" int sell_sb_list_dd(const int* group_ids, const int* plane_off,
                               const int* row_table, const int* ja,
                               const float2* as2, const float2* x2,
                               float* y_hi, float* y_lo, int64_t n_groups,
                               int accumulate, void* stream) {
  return sell::launch_row_list(
      group_ids, plane_off, row_table, ja,
      sell::DDPairs{{nullptr, nullptr, nullptr, nullptr, y_hi, y_lo}, as2,
                    x2},
      n_groups, accumulate, stream);
}
