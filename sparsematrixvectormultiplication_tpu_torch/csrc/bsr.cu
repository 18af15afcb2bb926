// 128x128 block-sparse (BSR) SpMM on Hopper: Y = A·X with f32 or bf16
// blocks and X, f32 sums and Y.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/
// pallas_bsr.py `_kernel` (pallas_bsr.py:102; the X slab reaches VMEM
// through a BlockSpec index map) and `_kernel_dma` (pallas_bsr.py:124; the
// kernel copies it in with make_async_copy):
//   Y[128g : 128g+128, :] = sum_j blocks[g*kb + j] @ X[128*bc : 128*bc+128, :],
//   bc = block_cols[g*kb + j].
// The TPU walks j on a sequential grid axis with the Y tile resident in VMEM
// and zeroed at j = 0. Here one thread block owns a 128 x kTileB tile of Y in
// registers, walks the kb slots itself and writes the tile once: no
// zero-fill, no atomics. Columns of Y at or past B are not written (the
// ragged edge); rows past nrows are written into the padded Y and cropped by
// the caller.
//
// What bounds it on an H100, and what the design does about it. A block
// multiplied densely is 2*128^3 FLOP per slot per 128 columns of X
// (band64_250k: 5,862 slots, 24.6 GFLOP at B = 128, where the function needs
// 3.2), 0.37 ms at the 67 TFLOP/s f32 rate: operations bound it. So:
// - The upload keeps a 64-bit `tile_mask` per slot: bit 8a + b is set iff
//   the 16x16 sub-tile (rows 16a.., columns 16b..) of the block holds a
//   nonzero (band64: 37.5% do). Each of the 8 warps owns a 16-row stripe of
//   the Y tile (sub-tile row a = warp) and skips, as a whole, every
//   sub-tile whose bit is clear. A depth-16 stage (a 128 x 16 strip of the
//   block and 16 rows of X) whose strip is all clear is neither loaded nor
//   multiplied; pad slots have an empty mask. band64's multiply drops to
//   ~9.2 GFLOP.
// - Stages stream through a ring of kRing stages in dynamic shared memory,
//   each with a "full" and an "empty" mbarrier. Warp 0 produces: it fills
//   the ring ahead and refills the slot of stage s - 1 once all 8 warps
//   have released it, so the others may run up to kRing - 1 stages ahead.
//   The two routes differ, as the TPU kernels did, only in how tiles reach
//   shared memory:
//     blockspec: TMA tile loads (cp.async.bulk.tensor) issued by one
//                thread, completing on the stage's full barrier; the
//                tensor maps, the counterpart of a BlockSpec index map, are
//                encoded at launch from the block and X pointers, and the
//                coordinates come from block_cols;
//     dma:       warp 0 copies the same bytes with cp.async, each lane's
//                copies arriving on the full barrier
//                (cp.async.mbarrier.arrive.noinc).
//   Both fill one layout: A as [128][16] and X as [16][128] elements,
//   bf16 X in two 64-column halves with the 128-byte swizzle (16-byte chunk
//   c of row k at chunk c ^ (k & 7)), so that ldmatrix reads it without
//   bank conflicts. Columns at or past B come in as zeros (TMA's
//   out-of-bounds fill, or a zero-byte cp.async source).
// - f32: IEEE fmaf only, no tensor cores, so no TF32 rounding. A thread
//   owns 8 rows (16*warp + 2i + rg) x 8 columns (4cg.., 64 + 4cg..) of Y.
//   The order of each element's sum is that of the dense kernel before it:
//   slot j, then k ascending; a skipped product is an exact zero, so Y is
//   the same bit for bit on finite X. An Inf or NaN in X under a structural
//   zero is not propagated, as in cuSPARSE and the CSR oracle.
// - bf16: warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate: the TPU's
//   single bf16 pass). Its 16-row A tile is the skip's granularity; a warp
//   holds 16 n-tiles of 8 columns, 64 f32 sums a thread.
// Both run 256 threads at <= 128 registers, two blocks an SM. Bytes of
// the f32 layout (384 MB of blocks, 128 MB of X and Y each on band64) set a
// floor of ~0.23 ms at the copy rate; skipped strips are not read. Measured
// times, registers and spills are in PERF.md.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime's driver entry point, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bsr {

constexpr int kBlock = 128;    // block edge
constexpr int kTileB = 128;    // Y columns per thread block
constexpr int kDepth = 16;     // k per stage
constexpr int kWarps = kBlock / 16;  // one 16-row stripe each
constexpr int kThreads = 32 * kWarps;
constexpr int kAlign = 1024;   // the 128-byte swizzle's repeat

template <typename T>
struct Geom {
  static constexpr int kABytes = kBlock * kDepth * int(sizeof(T));
  static constexpr int kXBytes = kDepth * kTileB * int(sizeof(T));
  static constexpr int kStageBytes = kABytes + kXBytes;
  static constexpr int kRing = sizeof(T) == 4 ? 6 : 8;  // stages
  static constexpr int kSmem = kRing * kStageBytes + kAlign;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Bit b of the result: strip b (a 128 x 16 column strip of the block) holds
// a nonzero 16x16 sub-tile.
__device__ __forceinline__ unsigned strips_of(uint64_t m) {
  m |= m >> 32;
  m |= m >> 16;
  m |= m >> 8;
  return unsigned(m) & 0xFFu;
}

// The block row's live stages in order: slot j ascending, then strip b.
struct Stages {
  const unsigned long long* mask;  // this block row's kb masks
  int kb;
  int j = -1;
  unsigned left = 0;
  uint64_t m = 0;

  __device__ __forceinline__ bool next(int& slot, int& b, uint64_t& bits) {
    while (left == 0) {
      if (j + 1 >= kb) return false;
      m = __ldg(mask + ++j);
      left = strips_of(m);
    }
    b = __ffs(left) - 1;
    left &= left - 1;
    slot = j;
    bits = m;
    return true;
  }
};

// Byte offset in a bf16 X tile of 16-byte chunk c (columns 8c..8c+7) of row
// k: two 64-column halves of 16 x 128 B, chunks swizzled within a row.
__device__ __forceinline__ int x_chunk_bf16(int k, int c) {
  return (c >> 3) * (kDepth * 128) + k * 128 + (((c & 7) ^ (k & 7)) << 4);
}

template <typename T>
struct Operands {
  const int* block_cols;
  const unsigned long long* tile_mask;
  const T* blocks;
  const T* x;
  float* y;
  int kb, B;
  int64_t ldx, ldy;
};

// dma: warp 0 copies stage (slot, b) into ring slot `sa` / `sx` with
// cp.async and arrives on `full` when its copies land.
template <typename T>
__device__ __forceinline__ void copy_stage(const Operands<T>& o, int64_t slot,
                                           int b, int c0, unsigned char* sa,
                                           unsigned char* sx, uint64_t* full,
                                           int lane) {
  constexpr int V = 16 / int(sizeof(T));  // elements per chunk
  constexpr int kAChunks = kDepth / V;    // per A row
  constexpr int kXChunks = kTileB / V;    // per X row
  const T* a = o.blocks + slot * kBlock * kBlock + b * kDepth;
  for (int q = lane; q < kBlock * kAChunks; q += 32) {
    const int m = q / kAChunks, c = q % kAChunks;
    cp_async16(sa + (m * kDepth + c * V) * sizeof(T), a + m * kBlock + c * V,
               16);
  }
  const T* xs = o.x + (int64_t(__ldg(o.block_cols + slot)) * kBlock +
                       b * kDepth) * o.ldx + c0;
  for (int q = lane; q < kDepth * kXChunks; q += 32) {
    const int k = q / kXChunks, c = q % kXChunks;
    const int off = sizeof(T) == 4 ? (k * kTileB + c * V) * 4
                                   : x_chunk_bf16(k, c);
    const bool in = c0 + c * V < o.B;
    cp_async16(sx + off, in ? xs + k * o.ldx + c * V : o.x, in ? 16 : 0);
  }
  cp_async_arrive(full);
}

// blockspec: one thread loads stage (slot, b) by TMA; the box bytes,
// out-of-bounds zeros included, complete the full barrier's transaction.
template <typename T>
__device__ __forceinline__ void tma_stage(const Operands<T>& o,
                                          const CUtensorMap* map_a,
                                          const CUtensorMap* map_x,
                                          int64_t slot, int b, int c0,
                                          unsigned char* sa, unsigned char* sx,
                                          uint64_t* full) {
  mbar_expect_tx(full, Geom<T>::kStageBytes);
  tma_load(sa, map_a, b * kDepth, int(slot) * kBlock, full);
  const int row = __ldg(o.block_cols + slot) * kBlock + b * kDepth;
  if constexpr (sizeof(T) == 4) {
    tma_load(sx, map_x, c0, row, full);
  } else {
    tma_load(sx, map_x, c0, row, full);
    tma_load(sx + kDepth * 128, map_x, c0 + 64, row, full);
  }
}

// f32: acc[i][c] += A[16w + 2i + rg, d] * X[d, col c] over the stage's 16 d,
// col c = 4cg + c (c < 4) or 64 + 4cg + c - 4
__device__ __forceinline__ void multiply_f32(const float* sa, const float* sx,
                                             float (&acc)[8][8], int warp,
                                             int rg, int cg) {
  const float* a = sa + (16 * warp + rg) * kDepth;
#pragma unroll
  for (int d = 0; d < kDepth; d += 2) {
    float2 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      av[i] = *reinterpret_cast<const float2*>(a + 2 * i * kDepth + d);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 x0 =
          *reinterpret_cast<const float4*>(sx + (d + e) * kTileB + 4 * cg);
      const float4 x1 = *reinterpret_cast<const float4*>(
          sx + (d + e) * kTileB + 64 + 4 * cg);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = e ? av[i].y : av[i].x;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(ai, xv[c], acc[i][c]);
      }
    }
  }
}

// bf16: the warp's 16 x 16 A sub-tile times the stage's 16 x 128 X slice,
// 16 mma.sync m16n8k16 into acc[n-tile][4]
__device__ __forceinline__ void multiply_bf16(const unsigned char* sa,
                                              const unsigned char* sx,
                                              float (&acc)[16][4], int warp,
                                              int lane) {
  uint32_t a[4];
  {
    const int row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int col = 8 * (lane >> 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(smem_addr(sa + (row * kDepth + col) * 2)));
  }
  const int q = lane >> 3, k = (lane & 7) + 8 * (q & 1);
#pragma unroll
  for (int p = 0; p < 8; ++p) {  // n-tiles 2p and 2p + 1
    uint32_t bq[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(bq[0]), "=r"(bq[1]), "=r"(bq[2]), "=r"(bq[3])
        : "r"(smem_addr(sx + x_chunk_bf16(k, 2 * p + (q >> 1)))));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* c = acc[2 * p + h];
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(bq[2 * h]),
            "r"(bq[2 * h + 1]));
    }
  }
}

template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads, 2)
bsr_kernel(__grid_constant__ const CUtensorMap map_a,
           __grid_constant__ const CUtensorMap map_x, Operands<T> o) {
  using G = Geom<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int R = G::kRing;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[R], empty[R];
  unsigned char* smem =
      smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1));
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * kTileB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t slot0 = int64_t(g) * o.kb;

  if (tid == 0) {
    for (int r = 0; r < R; ++r) {
      mbar_init(&full[r], kTma ? 1 : 32);
      mbar_init(&empty[r], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int r, int j, int b) {
    unsigned char* sa = smem + r * G::kStageBytes;
    unsigned char* sx = sa + G::kABytes;
    if constexpr (kTma) {
      if (lane == 0) tma_stage(o, &map_a, &map_x, slot0 + j, b, c0, sa, sx,
                               &full[r]);
    } else {
      copy_stage(o, slot0 + j, b, c0, sa, sx, &full[r], lane);
    }
  };

  Stages prod{o.tile_mask + slot0, o.kb};
  if (warp == 0) {
    int j, b;
    uint64_t m;
    for (int r = 0; r < R && prod.next(j, b, m); ++r) issue(r, j, b);
  }

  float acc_f32[kF32 ? 8 : 1][8];
  float acc_bf16[kF32 ? 1 : 16][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if constexpr (kF32) {
        acc_f32[i][c] = 0.f;
      } else {
        acc_bf16[2 * i + c / 4][c % 4] = 0.f;
      }
    }
  }
  const int rg = lane >> 4, cg = lane & 15;

  Stages cons{o.tile_mask + slot0, o.kb};
  int j, b;
  uint64_t m;
  for (int s = 0; cons.next(j, b, m); ++s) {
    if (warp == 0 && s > 0) {
      // refill the ring slot of stage s - 1 with stage s - 1 + R once every
      // warp has released it
      int pj, pb;
      uint64_t pm;
      if (prod.next(pj, pb, pm)) {
        const int r = (s - 1) % R;
        if (kTma ? lane == 0 : true) mbar_wait(&empty[r], ((s - 1) / R) & 1);
        __syncwarp();
        issue(r, pj, pb);
      }
      __syncwarp();
    }
    const int r = s % R;
    mbar_wait(&full[r], (s / R) & 1);
    if ((m >> (8 * warp + b)) & 1) {
      const unsigned char* sa = smem + r * G::kStageBytes;
      if constexpr (kF32) {
        multiply_f32(reinterpret_cast<const float*>(sa),
                     reinterpret_cast<const float*>(sa + G::kABytes), acc_f32,
                     warp, rg, cg);
      } else {
        multiply_bf16(sa, sa + G::kABytes, acc_bf16, warp, lane);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[r]);
  }

  if constexpr (kF32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* yr = o.y + (int64_t(g) * kBlock + 16 * warp + 2 * i + rg) * o.ldy;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + 64 * h + 4 * cg;
        const float* v = &acc_f32[i][4 * h];
        if (col + 4 <= o.B) {
          *reinterpret_cast<float4*>(yr + col) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (col + c < o.B) yr[col + c] = v[c];
          }
        }
      }
    }
  } else {
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* yr = o.y + (int64_t(g) * kBlock + 16 * warp + gr + 8 * h) * o.ldy;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = c0 + 8 * n + 2 * t;
        const float* v = &acc_bf16[n][2 * h];
        if (col + 2 <= o.B) {
          *reinterpret_cast<float2*>(yr + col) = make_float2(v[0], v[1]);
        } else if (col < o.B) {
          yr[col] = v[0];
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, or null
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) tensor with row stride ld elements, read in
// (box_rows, box_cols) boxes; out-of-bounds elements read as zeros
template <typename T>
bool encode(CUtensorMap* map, const T* base, uint64_t rows, uint64_t cols,
            uint64_t ld, uint32_t box_rows, uint32_t box_cols,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * sizeof(T)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map,
            sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<T*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kNoEncoder = -1;  // returned when a tensor map cannot be made

template <typename T, bool kTma>
int launch(const Operands<T>& o, int64_t n_block_rows, int64_t n_block_cols,
           void* stream) {
  if (n_block_rows <= 0 || o.B <= 0) return int(cudaGetLastError());
  CUtensorMap map_a{}, map_x{};
  if constexpr (kTma) {
    const uint64_t n_slots = uint64_t(n_block_rows) * o.kb;
    if (n_slots > 0 &&
        (!encode(&map_a, o.blocks, n_slots * kBlock, kBlock, kBlock, kBlock,
                 kDepth, CU_TENSOR_MAP_SWIZZLE_NONE) ||
         !encode(&map_x, o.x, uint64_t(n_block_cols) * kBlock, o.B, o.ldx,
                 kDepth, sizeof(T) == 4 ? kTileB : kTileB / 2,
                 sizeof(T) == 4 ? CU_TENSOR_MAP_SWIZZLE_NONE
                                : CU_TENSOR_MAP_SWIZZLE_128B))) {
      return kNoEncoder;
    }
  }
  auto kernel = bsr_kernel<T, kTma>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geom<T>::kSmem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  }
  if (e != cudaSuccess) return int(e);
  const dim3 grid(unsigned(n_block_rows), unsigned((o.B + kTileB - 1) / kTileB));
  kernel<<<grid, kThreads, Geom<T>::kSmem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_x, o);
  return int(cudaGetLastError());
}

}  // namespace bsr

// block_cols (n_block_rows*kb,) int32; tile_mask (n_block_rows*kb,) 64-bit
// sub-tile masks; blocks (n_block_rows*kb, 128, 128); x (n_block_cols*128,
// B) with row stride ldx (a multiple of 8, >= B), 16-byte aligned; y
// (n_block_rows*128, B) f32 with row stride ldy (a multiple of 4, >= B).
// Returns a cudaError_t, or -1 when a tensor map cannot be encoded.
#define BSR_ENTRY(route, tma, tag, T)                                         \
  extern "C" int bsr_spmm_##route##_##tag(                                    \
      const int* block_cols, const unsigned long long* tile_mask,             \
      const T* blocks, const T* x, float* y, int64_t n_block_rows,            \
      int64_t n_block_cols, int kb, int B, int64_t ldx, int64_t ldy,          \
      void* stream) {                                                         \
    return bsr::launch<T, tma>(                                               \
        bsr::Operands<T>{block_cols, tile_mask, blocks, x, y, kb, B, ldx,     \
                         ldy},                                                \
        n_block_rows, n_block_cols, stream);                                  \
  }

BSR_ENTRY(blockspec, true, f32, float)
BSR_ENTRY(blockspec, true, bf16, __nv_bfloat16)
BSR_ENTRY(dma, false, f32, float)
BSR_ENTRY(dma, false, bf16, __nv_bfloat16)
