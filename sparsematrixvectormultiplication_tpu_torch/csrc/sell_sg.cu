// SG (shared-window) SELL SpMV on Hopper, for scattered short-row matrices,
// f32, bf16 and double-double, slots and rows mode.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/pallas_sell.py
// `_kernel_sg` and ops/pallas_sell_dd.py `_kernel_sg_dd`. A bin group g
// holds T tiles of (8, 128) slots; slot (p, j) of tile t sits at plane row
// (g*T + t)*8 + p, lane j. Its index word md = (doff*8 + sigma)*128 + m
// names column 128*(w0 + doff) + m, with the tile's window base
// w0 = table[g, t*stride] (stride 2 for dynamic bins, whose table also
// holds pass counts, else 1). Its product lands on row sigma*128 + j of the
// group: sigma = md bits 7-9 in slots mode, or the position p itself in
// rows mode. Only the first slab_count[g] tiles are real; padding tiles
// hold zero values and are not read. The TPU kernel swept the window in V
// masked passes because a TPU core gathers only within a 128-lane row; the
// static V and the dynamic pass counts bound those passes and do not change
// what an entry computes, so they are not read here. The TPU dd kernel took
// rows mode only: its error-free transforms could add one product per
// output position. A GPU thread keeps a dd sum per sigma instead.
//
// What bounds it on an H100: bytes and, at small group counts, occupancy.
// f32 and bf16 bins run on compacted planes (ops/sell.py `_compact_sg`):
// the upload drops every slot of a real tile whose value is zero, which is
// most of them on scattered matrices (random_general(200_000, 200_000,
// 2.5e-4)'s main bin: 63% of its real tiles' slots), decodes each real slot
// to its absolute column and its row (sigma*128 + j, or p*128 + j in rows
// mode), keeps each row's slots in (tile, p) order and lays the rows out as
// the compacted sb-list bin does. The row-list kernel of sell_common.cuh
// runs them, one thread a row with no sigma sums and no chunks: 8 bytes a
// real slot (f32) in place of 8 bytes a slot of every real tile, and a row
// of the list is as long as its real entries, not as its group's tiles.
//
// dd bins stay padded (one 8-byte (hi, lo) pair a slot; x gathered as one
// 8-byte pair from the interleaved table) and run the tile kernel below:
// a 1024-thread block per (group, chunk); thread (p, j) walks slot (p, j) of
// the chunk's tiles in tile order, kTileBatch tiles' loads in flight, so a
// warp reads 128 consecutive lanes of each plane row. Slots mode keeps
// thread (p, j)'s 8 sigma sums in shared memory, part[p][sigma][j], which
// only that thread touches while it sums (one load and one store a slot, no
// select over 8 registers); after a barrier thread (p, j) joins row sigma =
// p over q = 0..7 in that order. Rows mode sums in a register. With chunks
// == 1 the block writes its rows (stored, or added onto y with
// `accumulate`). A bin of few groups is split (ops/sell.py:_sg_chunks):
// chunk c of group g takes its real tiles [c*n/chunks, (c+1)*n/chunks), n =
// min(slab_count[g], T), writes its partial rows to scratch[g, c, 1024], and
// a second launch joins each row's partials in chunk order and writes y
// once. No atomics: every sum has one fixed order, so y is the same on every
// run. A slot whose value is zero adds nothing in both kernels
// (sell_common.cuh's stored-zero rule).

#include "sell_common.cuh"

namespace sell {

constexpr int kGroupThreads = kSublanes * kLanes;  // 1024: thread (p, j)
constexpr int kTileBatch = 4;  // tiles whose loads are in flight together
constexpr int kJoinThreads = 256;

template <typename Sum, bool kSlots>
__global__ void __launch_bounds__(kGroupThreads)
sg_kernel(const int* __restrict__ group_ids, const int* __restrict__ table,
          const int* __restrict__ counts, const int* __restrict__ ja, Sum sum,
          typename Sum::Acc* __restrict__ scratch, int T_tiles, int stride,
          int chunks, int accumulate) {
  using Acc = typename Sum::Acc;
  const int64_t g = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const int p = threadIdx.x / kLanes;
  const int j = threadIdx.x % kLanes;
  const int n = min(__ldg(counts + g), T_tiles);
  const int t0 = int(int64_t(c) * n / chunks);
  const int t1 = int(int64_t(c + 1) * n / chunks);
  const int* w0 = table + g * T_tiles * stride;
  constexpr int64_t kTile = int64_t(kSublanes) * kLanes;
  const int64_t off0 = ((g * T_tiles + t0) * kSublanes + p) * kLanes + j;

  // thread (p, j)'s sums: 8 sigma rows in shared memory, or one register
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* part = reinterpret_cast<Acc*>(smem);  // [p][sigma][j] (slots mode)
  Acc* mine = part + p * kGroupThreads + j;  // mine[sigma*128]
  Acc r = sum.zero();
  if constexpr (kSlots) {
#pragma unroll
    for (int s = 0; s < kSublanes; ++s) mine[s * kLanes] = sum.zero();
  }
  for (int t = t0; t < t1; t += kTileBatch) {
    int md[kTileBatch];
    typename Sum::Val v[kTileBatch];
#pragma unroll
    for (int u = 0; u < kTileBatch; ++u) {
      if (t + u < t1) {
        const int64_t off = off0 + int64_t(t - t0 + u) * kTile;
        md[u] = __ldg(ja + off);
        v[u] = sum.load(off);
      }
    }
#pragma unroll
    for (int u = 0; u < kTileBatch; ++u) {
      if (t + u < t1) {
        const int col = (__ldg(w0 + (t + u) * stride) + (md[u] >> 10)) *
                            kLanes + (md[u] & (kLanes - 1));
        if constexpr (kSlots) {
          const int sigma = (md[u] >> 7) & (kSublanes - 1);
          sum.add(mine[sigma * kLanes], v[u], col);
        } else {
          sum.add(r, v[u], col);
        }
      }
    }
  }
  if constexpr (kSlots) {
    __syncthreads();
    // thread (p, j) now joins row sigma = p: part[q][p][j] over q in order
    const Acc* row = part + p * kLanes + j;
    r = row[0];
#pragma unroll
    for (int q = 1; q < kSublanes; ++q) {
      r = Sum::combine(r, row[q * kGroupThreads]);
    }
  }
  if (chunks == 1) {
    sum.store(r, int64_t(group_ids[g]) * kGroupRows + threadIdx.x,
              accumulate);
  } else {
    scratch[(g * chunks + c) * kGroupThreads + threadIdx.x] = r;
  }
}

// Row i of group g: its chunks' partials joined in chunk order, written once.
template <typename Sum>
__global__ void __launch_bounds__(kJoinThreads)
sg_join_kernel(const int* __restrict__ group_ids,
               const typename Sum::Acc* __restrict__ scratch, Sum sum,
               int64_t n_groups, int chunks, int accumulate) {
  const int64_t id = int64_t(blockIdx.x) * kJoinThreads + threadIdx.x;
  if (id >= n_groups * kGroupThreads) return;
  const int64_t g = id / kGroupThreads;
  const int i = int(id % kGroupThreads);
  const typename Sum::Acc* src = scratch + g * chunks * kGroupThreads + i;
  typename Sum::Acc r = src[0];
  for (int c = 1; c < chunks; ++c) r = Sum::combine(r, src[c * kGroupThreads]);
  sum.store(r, int64_t(group_ids[g]) * kGroupRows + i, accumulate);
}

template <bool kSlots, typename Sum>
int launch_sg_mode(const int* group_ids, const int* table, const int* counts,
                   const int* ja, Sum sum, void* scratch, int64_t n_groups,
                   int T_tiles, int stride, int chunks, int accumulate,
                   cudaStream_t stream) {
  using Acc = typename Sum::Acc;
  const auto kernel = sg_kernel<Sum, kSlots>;
  const size_t smem = kSlots ? size_t(kSublanes) * kGroupThreads * sizeof(Acc)
                             : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<dim3(unsigned(n_groups * chunks)), kGroupThreads, smem, stream>>>(
      group_ids, table, counts, ja, sum, static_cast<Acc*>(scratch), T_tiles,
      stride, chunks, accumulate);
  if (chunks > 1) {
    const int64_t rows = n_groups * kGroupThreads;
    sg_join_kernel<Sum><<<dim3(unsigned((rows + kJoinThreads - 1) /
                                        kJoinThreads)),
                          kJoinThreads, 0, stream>>>(
        group_ids, static_cast<const Acc*>(scratch), sum, n_groups, chunks,
        accumulate);
  }
  return int(cudaGetLastError());
}

template <typename Sum>
int launch_sg(const int* group_ids, const int* table, const int* counts,
              const int* ja, Sum sum, void* scratch, int64_t n_groups,
              int T_tiles, int stride, int slots, int chunks, int accumulate,
              void* stream) {
  if (n_groups <= 0) return int(cudaGetLastError());
  if (chunks < 1 || (chunks > 1 && scratch == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return slots ? launch_sg_mode<true>(group_ids, table, counts, ja, sum,
                                      scratch, n_groups, T_tiles, stride,
                                      chunks, accumulate, s)
               : launch_sg_mode<false>(group_ids, table, counts, ja, sum,
                                       scratch, n_groups, T_tiles, stride,
                                       chunks, accumulate, s);
}

}  // namespace sell

// f32 and bf16: the compacted planes, as the compacted sb-list entries of
// sell_sb.cu take them: group_ids, plane_off, row_table, ja (absolute
// columns), then the value plane, x and y. sg rows are long (about 51 real
// slots a row in random_general(200_000, 200_000, 2.5e-4)'s main bin), so
// a thread gathers a batch's x before it adds them, the batch 8 f32 slots
// or 4 bf16 ones (measured on the H100: 8 bf16 slots compiled to fewer
// registers and ran slower).
namespace sell {
template <typename T>
constexpr int kSgBatch = sizeof(T) == 4 ? 8 : 4;

template <typename T>
int launch_sg_list(const int* group_ids, const int* plane_off,
                   const int* row_table, const int* ja, const T* as,
                   const float* x, float* y, int64_t n_groups, int accumulate,
                   void* stream) {
  return launch_row_list<F32Slots<T>, kSgBatch<T>, true>(
      group_ids, plane_off, row_table, ja, F32Slots<T>{{as, x, y}}, n_groups,
      accumulate, stream);
}
}  // namespace sell

extern "C" int sell_sg_f32(const int* group_ids, const int* plane_off,
                           const int* row_table, const int* ja,
                           const float* as, const float* x, float* y,
                           int64_t n_groups, int accumulate, void* stream) {
  return sell::launch_sg_list(group_ids, plane_off, row_table, ja, as, x, y,
                              n_groups, accumulate, stream);
}

extern "C" int sell_sg_bf16(const int* group_ids, const int* plane_off,
                            const int* row_table, const int* ja,
                            const __nv_bfloat16* as, const float* x, float* y,
                            int64_t n_groups, int accumulate, void* stream) {
  return sell::launch_sg_list(group_ids, plane_off, row_table, ja, as, x, y,
                              n_groups, accumulate, stream);
}

// dd, the padded tiles: scratch holds (n_groups, chunks, 1024) partial
// (hi, lo) sums when chunks > 1, else it is unused; as2: (hi, lo) value
// pairs; x2: the interleaved (hi, lo) x table
extern "C" int sell_sg_dd(const int* group_ids, const int* table,
                          const int* counts, const int* ja, const float2* as2,
                          const float2* x2, float* y_hi, float* y_lo,
                          void* scratch, int64_t n_groups, int T_tiles,
                          int stride, int slots, int chunks, int accumulate,
                          void* stream) {
  return sell::launch_sg(
      group_ids, table, counts, ja,
      sell::DDPairs{{nullptr, nullptr, nullptr, nullptr, y_hi, y_lo}, as2,
                    x2},
      scratch, n_groups, T_tiles, stride, slots, chunks, accumulate, stream);
}
