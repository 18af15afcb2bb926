// Bandwidth probe kernels on Hopper: what the card streams from HBM.
//
// Replaces the TPU kernels of probes/bw_probe.py:
//   pallas_read (:78)        -> read_kernel<f32>: single-stream read;
//   pallas_read2 (:106)      -> read_kernel<f32, i32>: the two streams of a
//                               SELL bin, values and indices;
//   int_load_probe (:278)    -> read_kernel<i16> and <i8>: narrow index
//                               planes, read at full size;
//   pallas_copy (:135)       -> copy_kernel: out = buf + seed[0,0], the
//                               read + write rate (the %STREAM denominator);
//   pallas_manual_dma (:155) -> read_async_kernel: cp.async copies through
//                               shared memory, NBUF stages deep;
//   pallas_kernelsim (:208)  -> kernelsim_kernel: a miniature SELL kernel
//                               (value and index streams, an x gather).
//
// The reads fold the (nrows, 128) input into an (8, 128) output: row i adds
// onto out[i % 8], every row. The TPU kernels DMA whole blocks but sum only
// each block's first 8 rows; a GPU kernel that did the same would skip the
// bytes it is meant to time. So each read here sums every row it loads, and
// equals the TPU function at 8-row blocks (bk = 8, chunk_rows = 8).
//
// What bounds them on an H100: bytes, 3.35 TB/s of HBM3 at the spec. Each
// does at most one add per element read. Design against it:
//   * every load and store is 16 bytes a thread, neighbouring threads on
//     neighbouring addresses (4 f32, 8 int16, 16 int8 per vector);
//   * a grid of a few blocks per SM walks the input with a stride that is a
//     multiple of 1024 elements, so each thread's elements always land on
//     the same output slots: its sums stay in registers, and each block
//     writes one partial (8, 128) tile; fold_kernel adds the partials onto
//     the seed, one warp per output slot in a fixed order (no atomics: the
//     result does not depend on the schedule; a thread per slot summing
//     ~1000 partials one after another made a 512 MB read 12% slower);
//   * the reads keep 4 vectors per thread in flight per stream (unrolled by
//     hand), the cp.async read NBUF stages of CHUNK_ROWS rows per block;
//   * kernelsim runs one thread per (group, row-block, lane), as the SELL
//     kernels do: lane j of each (8, 128) plane tile is thread j, so the
//     value and index streams coalesce; x is gathered through L1/L2.

#include <cstdint>

#include <cuda_runtime.h>

namespace bw {

constexpr int kLanes = 128;
constexpr int kSlots = 8 * kLanes;  // the (8, 128) output tile
constexpr int kThreads = 256;       // read, copy and cp.async blocks
constexpr int kUnroll = 4;          // vectors in flight per thread and stream

template <typename T>
constexpr int kVec = 16 / int(sizeof(T));  // elements per 16-byte vector

template <typename T>
__device__ __forceinline__ void add16(float* acc, const int4& v) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) acc[i] += float(e[i]);
}

// Thread t of a block owns slots (t * n) % kSlots .. + n, n = kVec<T>: the
// grid stride (gridDim.x * kThreads vectors) is a multiple of kSlots
// elements for n >= 4. A block's partial tile sums the kThreads * n / kSlots
// threads that share each slot, in thread order.
template <typename TA, typename TB, bool kTwo>
__global__ void __launch_bounds__(kThreads)
read_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
            int64_t n_vec, float* __restrict__ partial) {
  static_assert(sizeof(TA) == sizeof(TB), "the two streams share slots");
  constexpr int n = kVec<TA>;
  float acc[n];
#pragma unroll
  for (int i = 0; i < n; ++i) acc[i] = 0.f;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t v = int64_t(blockIdx.x) * kThreads + threadIdx.x; v < n_vec;
       v += kUnroll * stride) {
    int4 va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = v + u * stride;
      va[u] = w < n_vec ? __ldg(a + w) : make_int4(0, 0, 0, 0);
      if (kTwo) vb[u] = w < n_vec ? __ldg(b + w) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add16<TA>(acc, va[u]);
      if (kTwo) add16<TB>(acc, vb[u]);
    }
  }
  __shared__ float sh[kThreads * n];
#pragma unroll
  for (int i = 0; i < n; ++i) sh[threadIdx.x * n + i] = acc[i];
  __syncthreads();
  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    float t = 0.f;
    for (int c = 0; c < kThreads * n / kSlots; ++c) t += sh[c * kSlots + s];
    partial[int64_t(blockIdx.x) * kSlots + s] = t;
  }
}

// out[s] = seed[s] + sum over blocks b of partial[b][s]: warp s sums slot
// s, lane l the blocks l, l + 32, ..., then a shuffle tree adds the lanes
constexpr int kFoldBlocks = kSlots * 32 / kThreads;
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ partial, int n_blocks,
            const float* __restrict__ seed, float* __restrict__ out) {
  const int s = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  float t = 0.f;
  for (int b = lane; b < n_blocks; b += 32)
    t += partial[int64_t(b) * kSlots + s];
#pragma unroll
  for (int d = 16; d > 0; d /= 2) t += __shfl_down_sync(0xffffffffu, t, d);
  if (lane == 0) out[s] = seed[s] + t;
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const float4* __restrict__ in, const float* __restrict__ seed,
            float4* __restrict__ out, int64_t n_vec) {
  const float s = __ldg(seed);
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t v = int64_t(blockIdx.x) * kThreads + threadIdx.x; v < n_vec;
       v += kUnroll * stride) {
    float4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = v + u * stride;
      if (w < n_vec) r[u] = __ldg(in + w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = v + u * stride;
      if (w < n_vec)
        out[w] = make_float4(r[u].x + s, r[u].y + s, r[u].z + s, r[u].w + s);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The f32 input as chunks of chunk_rows rows (chunk_rows * 32 float4s);
// block b takes chunks b, b + gridDim.x, ... through NBUF shared-memory
// stages. Thread t copies and reads the float4s t + 256 j of a chunk (j <
// chunk_rows / 8): rows t / 32 + 8 j, column (t % 32) * 4, i.e. slots 4t ..
// 4t+3, so it reads back only its own copies and needs no barrier.
template <int NBUF>
__global__ void __launch_bounds__(kThreads)
read_async_kernel(const float4* __restrict__ buf, int64_t n_chunks,
                  int chunk_rows, float* __restrict__ partial) {
  extern __shared__ float4 stage[];  // NBUF * chunk_rows * 32 float4s
  const int t = threadIdx.x;
  const int per = chunk_rows / 8;
  const int64_t chunk_vec = int64_t(chunk_rows) * 32;
  auto fetch = [&](int slot, int64_t ci) {
    if (ci < n_chunks) {
      for (int j = 0; j < per; ++j)
        cp_async16(stage + (slot * per + j) * kThreads + t,
                   buf + ci * chunk_vec + t + kThreads * j);
    }
    cp_async_commit();  // an empty group keeps the count of groups uniform
  };
#pragma unroll
  for (int s = 0; s < NBUF; ++s) fetch(s, blockIdx.x + int64_t(s) * gridDim.x);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int slot = 0;
  for (int64_t ci = blockIdx.x; ci < n_chunks; ci += gridDim.x) {
    cp_async_wait<NBUF - 1>();
    for (int j = 0; j < per; ++j) {
      const float4 v = stage[(slot * per + j) * kThreads + t];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    fetch(slot, ci + int64_t(NBUF) * gridDim.x);
    slot = slot + 1 == NBUF ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  reinterpret_cast<float4*>(partial + int64_t(blockIdx.x) * kSlots)[t] = acc;
}

// One thread per (group g, row-block sb, lane): y[g*8 + sb, lane] = seed[0]
// + sum over the k/8 chunks c and their 8 rows r of as[off + r, lane] *
// x[q + sel, m], off = g*k*8 + sb*k + c*8, code = ja[off + r, lane] (packed:
// the low 16 bits of ja[g*k*4 + sb*k/2 + (c/2)*8 + r, lane] for even c, the
// high 16 bits for odd c), sel = code >> 7, m = code & 127, q = qb[g,
// sb*k/8 + c]; codes with sel outside [0, span) add nothing, as in the TPU
// kernel's span masked passes. kCompute = false adds as + f32(ja) instead,
// with no gather, on the unpacked plane only (the TPU probe's unpacked
// no-compute variant; its packed one reads rows off/2 .. off/2 + 7, past the
// end of the plane at the last chunk, and its main never runs it).
template <bool kCompute, bool kPacked>
__global__ void __launch_bounds__(kLanes)
kernelsim_kernel(const int* __restrict__ qb, const float* __restrict__ x,
                 const int* __restrict__ ja, const float* __restrict__ as,
                 const float* __restrict__ seed, float* __restrict__ y, int k,
                 int span) {
  const int64_t g = blockIdx.x / 8;
  const int sb = blockIdx.x % 8;
  const int lane = threadIdx.x;
  const int nch = k / 8;
  float acc = 0.f;
  for (int c = 0; c < nch; ++c) {
    const int64_t off = g * k * 8 + sb * k + c * 8;
    if (!kCompute) {
      static_assert(kCompute || !kPacked, "no packed no-compute variant");
#pragma unroll
      for (int r = 0; r < 8; ++r)
        acc += __ldg(as + (off + r) * kLanes + lane) +
               float(__ldg(ja + (off + r) * kLanes + lane));
      continue;
    }
    const int q = __ldg(qb + g * 8 * nch + sb * nch + c);
    const int64_t joff =
        kPacked ? g * k * 4 + sb * (k / 2) + (c / 2) * 8 : off;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      int code = __ldg(ja + (joff + r) * kLanes + lane);
      if (kPacked) code = (c & 1) ? (code >> 16) & 0xFFFF : code & 0xFFFF;
      const int sel = code >> 7;
      const float xv = unsigned(sel) < unsigned(span)
                           ? __ldg(x + int64_t(q + sel) * kLanes + (code & 127))
                           : 0.f;
      acc = fmaf(__ldg(as + (off + r) * kLanes + lane), xv, acc);
    }
  }
  y[(g * 8 + sb) * kLanes + lane] = acc + __ldg(seed);
}

template <typename TA, typename TB, bool kTwo>
int read(const void* a, const void* b, int64_t n_vec, int n_blocks,
         float* partial, const float* seed, float* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_vec > 0 && n_blocks > 0) {
    read_kernel<TA, TB, kTwo><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const int4*>(a), static_cast<const int4*>(b), n_vec,
        partial);
    const int err = int(cudaGetLastError());
    if (err) return err;
  }
  fold_kernel<<<kFoldBlocks, kThreads, 0, s>>>(
      partial, n_vec > 0 ? n_blocks : 0, seed, out);
  return int(cudaGetLastError());
}

template <int NBUF>
int read_async(const float* buf, int64_t n_chunks, int chunk_rows,
               int n_blocks, float* partial, const float* seed, float* out,
               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = size_t(NBUF) * chunk_rows * kLanes * sizeof(float);
  int err = int(cudaFuncSetAttribute(
      read_async_kernel<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem)));
  if (err) return err;
  if (n_chunks > 0 && n_blocks > 0) {
    read_async_kernel<NBUF><<<n_blocks, kThreads, smem, s>>>(
        reinterpret_cast<const float4*>(buf), n_chunks, chunk_rows, partial);
    err = int(cudaGetLastError());
    if (err) return err;
  }
  fold_kernel<<<kFoldBlocks, kThreads, 0, s>>>(
      partial, n_chunks > 0 ? n_blocks : 0, seed, out);
  return int(cudaGetLastError());
}

template <int NBUF>
int async_occupancy(int chunk_rows, int* blocks_per_sm) {
  const size_t smem = size_t(NBUF) * chunk_rows * kLanes * sizeof(float);
  int err = int(cudaFuncSetAttribute(
      read_async_kernel<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem)));
  if (err) return err;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, read_async_kernel<NBUF>, kThreads, smem));
}

}  // namespace bw

// a (and b): n_vec 16-byte vectors of an (nrows, 128) array, nrows a
// multiple of 8; partial: n_blocks * 1024 f32 scratch; seed, out: (8, 128)
#define BW_READ(name, TA, TB, two)                                          \
  extern "C" int name(const void* a, const void* b, int64_t n_vec,           \
                      int n_blocks, float* partial, const float* seed,       \
                      float* out, void* stream) {                            \
    return bw::read<TA, TB, two>(a, b, n_vec, n_blocks, partial, seed, out, \
                                 stream);                                    \
  }

BW_READ(bw_read_f32, float, float, false)
BW_READ(bw_read_i32, int32_t, int32_t, false)
BW_READ(bw_read_i16, int16_t, int16_t, false)
BW_READ(bw_read_i8, int8_t, int8_t, false)
BW_READ(bw_read2_f32_i32, float, int32_t, true)

// in, out: n_vec float4s; seed: its first value is added
extern "C" int bw_copy_f32(const float* in, const float* seed, float* out,
                           int64_t n_vec, int n_blocks, void* stream) {
  if (n_vec > 0 && n_blocks > 0) {
    bw::copy_kernel<<<n_blocks, bw::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(in), seed,
        reinterpret_cast<float4*>(out), n_vec);
  }
  return int(cudaGetLastError());
}

// buf: n_chunks * chunk_rows rows of 128 f32, chunk_rows a multiple of 8;
// nbuf 2 or 3
extern "C" int bw_read_async_f32(const float* buf, int64_t n_chunks,
                                 int chunk_rows, int nbuf, int n_blocks,
                                 float* partial, const float* seed, float* out,
                                 void* stream) {
  switch (nbuf) {
    case 2:
      return bw::read_async<2>(buf, n_chunks, chunk_rows, n_blocks, partial,
                               seed, out, stream);
    case 3:
      return bw::read_async<3>(buf, n_chunks, chunk_rows, n_blocks, partial,
                               seed, out, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// how many cp.async blocks of chunk_rows rows and nbuf stages fit an SM
extern "C" int bw_read_async_occupancy(int chunk_rows, int nbuf,
                                       int* blocks_per_sm) {
  switch (nbuf) {
    case 2:
      return bw::async_occupancy<2>(chunk_rows, blocks_per_sm);
    case 3:
      return bw::async_occupancy<3>(chunk_rows, blocks_per_sm);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// qb (n_groups, k) int32 (k/8 chunks of each of 8 row-blocks), x (xrows,
// 128) f32, ja and as planes as kernelsim_kernel reads them, seed (8, 128);
// y (n_groups*8, 128) f32
#define BW_KERNELSIM(name, compute, packed)                                  \
  extern "C" int name(const int* qb, const float* x, const int* ja,          \
                      const float* as, const float* seed, float* y,          \
                      int64_t n_groups, int k, int span, void* stream) {     \
    if (n_groups > 0) {                                                      \
      bw::kernelsim_kernel<compute, packed>                                  \
          <<<unsigned(n_groups * 8), bw::kLanes, 0,                          \
             static_cast<cudaStream_t>(stream)>>>(qb, x, ja, as, seed, y, k, \
                                                  span);                     \
    }                                                                        \
    return int(cudaGetLastError());                                          \
  }

BW_KERNELSIM(bw_kernelsim_f32, true, false)
BW_KERNELSIM(bw_kernelsim_packed_f32, true, true)
BW_KERNELSIM(bw_kernelsim_nocompute_f32, false, false)
