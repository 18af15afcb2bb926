// Kernel-variant probe kernels on Hopper: what a layout's decode costs
// beside what its bytes cost.
//
// Replaces the TPU kernels of probes/kernel_probe{,2,3,4,5}.py:
//   kp_decode  <- kernel_probe.py:96 (k_span, k_span_window, k_layered,
//                 k_stream), kernel_probe2.py:76 (k_stream, k_gather_b,
//                 k_gather_w, k_span4), kernel_probe3.py:76 (k_stream,
//                 k_gather, k_span), kernel_probe4.py:285 (mk_span) and
//                 kernel_probe5.py:70 (k_sbmajor, k_sblist, k_wl);
//   kp_fused   <- kernel_probe3.py:76 (k_fused: 8-row ja/as chunks
//                 interleaved in one int32 plane), kernel_probe4.py:154
//                 (mk_fused_pure) and :209 (mk_fused_gather: blocks of a ja
//                 half then an as-bits half);
//   kp_colsum  <- kernel_probe4.py:88 (mk_read1) and :118 (mk_read2).
//
// The function, shared by every decode probe: a plane has rows of 128
// lanes; step g is kb consecutive rows and owns the output tile y[8g ..
// 8g+8, :]; chunk c is ck consecutive rows of a step, all sharing one scalar
// of the step's row of `tab` (qb, or a run of a list); the entry at row i of
// the step, lane j, adds v * xhat into y[8g + i % 8, j], v its as value.
// The modes differ only in xhat (m = code & 127 everywhere; the m-only int8
// and int16 codes of the layered planes hold 0..127, so the mask is ja):
//   stream   float(code), no gather;
//   bcast    x[q, m], q = tab[g, c*stride] (the slab part is ignored);
//   window   x[q + r, m], r the row within the chunk (0 .. ck-1);
//   masked   x[q + d, m] if 0 <= d < span, else 0: d = (code >> 7) - q for
//            int32 codes (absolute slab), d = code >> 7 for int16 codes
//            (relative slab, shifted arithmetically on the widened value);
//   sblist   sum over s < span of [code >> 7 == l_s] x[l_s, m], l_s = tab[g,
//            c*span + s], in order s (a slab listed twice counts twice);
//   wl       x[tab[g, 8 (c / L) + r], m], ck = 8: L layer tiles per window.
// The TPU kernels scan span masked passes (or one window read) per chunk
// because a TPU core gathers only within a 128-lane row; a GPU thread
// gathers x[col] directly. So on this card a sweep over span measures the
// decode and the x locality, not the masked passes. kp_fused's fused8 and
// halves-gather are stream and bcast with v = bitcast_f32(as bits) taken
// from the same int32 plane; halves-pure is the int32 (wrapping) column sum
// of ja + as bits, widened to f32 and broadcast to 8 rows; colsum is the f32
// column sum of a (or a + b), broadcast to 8 rows. The TPU's colsum and
// halves-pure map every grid step onto output block (0, 0) and so keep only
// the last block's sums; a GPU kernel that did the same would skip the bytes
// it is meant to time, so these sum every block (the TPU function at one
// block).
//
// What bounds them on an H100: bytes. Each entry streams its code (4, 2 or
// 1 B) and value (4 B) once; the x table (1 MB) and the tables stay in L2.
// Design against it:
//   * one thread per lane, 128-thread blocks: thread j reads lane j of 8
//     consecutive plane rows per iteration, so each warp's loads coalesce
//     and 8 rows per stream are in flight; its 8 sums, one per output slot,
//     stay in registers (as in bw_probe.cu's kernelsim);
//   * a step is cut into `parts` contiguous runs of 8-row groups, one block
//     each, so that 16 steps of 8192 rows still fill 132 SMs; each block
//     writes a partial (8, 128) tile and fold_parts adds a step's partials
//     in part order: no atomics, the result does not depend on the schedule;
//   * colsum reads 16 bytes a thread (float4), a few blocks per SM with a
//     grid stride of whole 8-row groups; blocks write 128-lane partials that
//     fold_cols adds one warp per lane in a fixed order (shuffle tree);
//   * halves-pure adds in uint32, where overflow wraps (int32 overflow is
//     undefined in C++), and converts once at the end.

#include <cstdint>

#include <cuda_runtime.h>

namespace kp {

constexpr int kLanes = 128;
constexpr int kSlots = 8 * kLanes;  // the (8, 128) output tile
constexpr int kThreads = 256;       // colsum and fold blocks
constexpr int kUnroll = 4;          // colsum: float4s in flight per stream

enum Mode { kStream = 0, kBcast, kWindow, kMasked, kSbList, kWl };
enum Fused { kFused8 = 0, kHalvesGather, kHalvesPure };

// Geometry of a decode or fused launch: steps of kb rows, each cut into
// `parts` runs of `gpp` 8-row groups (the last run may be shorter).
struct Geo {
  int kb, ck, span, L, stride, tcols, parts, gpp;
};

template <int kMode, bool kRel>
__device__ __forceinline__ float xhat(int code, int r, const int* __restrict__ trow,
                                      int c, const float* __restrict__ x,
                                      const Geo& p) {
  const int m = code & (kLanes - 1);
  if constexpr (kMode == kStream) {
    return float(code);
  } else if constexpr (kMode == kBcast) {
    return __ldg(x + int64_t(__ldg(trow + c * p.stride)) * kLanes + m);
  } else if constexpr (kMode == kWindow) {
    return __ldg(x + int64_t(__ldg(trow + c * p.stride) + r) * kLanes + m);
  } else if constexpr (kMode == kMasked) {
    const int q = __ldg(trow + c * p.stride);
    const int d = kRel ? (code >> 7) : (code >> 7) - q;
    return unsigned(d) < unsigned(p.span)
               ? __ldg(x + int64_t(q + d) * kLanes + m)
               : 0.f;
  } else if constexpr (kMode == kSbList) {
    const int slab = code >> 7;
    float t = 0.f;
    for (int s = 0; s < p.span; ++s) {
      const int l = __ldg(trow + c * p.span + s);
      if (l == slab) t += __ldg(x + int64_t(l) * kLanes + m);
    }
    return t;
  } else {  // kWl
    return __ldg(x + int64_t(__ldg(trow + 8 * (c / p.L) + r)) * kLanes + m);
  }
}

// Block b: step b / parts, part b % parts; lane = threadIdx.x. Writes its
// partial tile at out[b * kSlots] (= y itself when parts == 1).
template <int kMode, typename CodeT>
__global__ void __launch_bounds__(kLanes)
decode_kernel(const CodeT* __restrict__ ja, const float* __restrict__ as,
              const int* __restrict__ tab, const float* __restrict__ x,
              float* __restrict__ out, Geo p) {
  constexpr bool kRel = sizeof(CodeT) == 2;  // int16 masked codes: relative
  const int64_t g = blockIdx.x / p.parts;
  const int part = blockIdx.x % p.parts;
  const int lane = threadIdx.x;
  const int h0 = part * p.gpp;
  const int h1 = min(p.kb / 8, h0 + p.gpp);
  const int* trow = tab + g * p.tcols;
  float acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.f;
  for (int h = h0; h < h1; ++h) {
    const int row0 = h * 8;  // row of the step; ck is a multiple of 8
    const int c = row0 / p.ck;
    const int r0 = row0 - c * p.ck;
    const int64_t off = (g * p.kb + row0) * kLanes + lane;
    int code[8];
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      code[r] = int(__ldg(ja + off + r * kLanes));  // widened, sign kept
      v[r] = __ldg(as + off + r * kLanes);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
      acc[r] = fmaf(v[r], xhat<kMode, kRel>(code[r], r0 + r, trow, c, x, p),
                    acc[r]);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
    out[int64_t(blockIdx.x) * kSlots + r * kLanes + lane] = acc[r];
}

// The fused int32 planes. fused8: logical chunk C = g*kb/8 + h is plane
// rows 16C .. 16C+7 (ja) and 16C+8 .. 16C+15 (as bits). halves: step g is
// plane rows 2*kb*g .. (ja half, kb rows) then the as-bits half. Gather
// (halves-gather) is bcast: x[tab[g, h], ja & 127]; fused8 streams
// float(ja). halves-pure adds ja + as bits in uint32 into one sum per lane,
// written as a uint32 partial of 128 lanes at out[b * kLanes].
template <int kMode>
__global__ void __launch_bounds__(kLanes)
fused_kernel(const int* __restrict__ f, const int* __restrict__ tab,
             const float* __restrict__ x, void* __restrict__ out, Geo p) {
  const int64_t g = blockIdx.x / p.parts;
  const int part = blockIdx.x % p.parts;
  const int lane = threadIdx.x;
  const int h0 = part * p.gpp;
  const int h1 = min(p.kb / 8, h0 + p.gpp);
  float acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.f;
  unsigned wrap = 0u;
  for (int h = h0; h < h1; ++h) {
    int64_t ja_row, as_row;
    if (kMode == kFused8) {
      ja_row = 16 * (g * (p.kb / 8) + h);
      as_row = ja_row + 8;
    } else {
      ja_row = 2 * g * p.kb + 8 * h;
      as_row = ja_row + p.kb;
    }
    int code[8], bits[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      code[r] = __ldg(f + (ja_row + r) * kLanes + lane);
      bits[r] = __ldg(f + (as_row + r) * kLanes + lane);
    }
    if (kMode == kHalvesPure) {
#pragma unroll
      for (int r = 0; r < 8; ++r) wrap += unsigned(code[r]) + unsigned(bits[r]);
      continue;
    }
    const int q = kMode == kHalvesGather ? __ldg(tab + g * p.tcols + h) : 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float xv =
          kMode == kFused8
              ? float(code[r])
              : __ldg(x + int64_t(q) * kLanes + (code[r] & (kLanes - 1)));
      acc[r] = fmaf(__int_as_float(bits[r]), xv, acc[r]);
    }
  }
  if (kMode == kHalvesPure) {
    static_cast<unsigned*>(out)[int64_t(blockIdx.x) * kLanes + lane] = wrap;
    return;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
    static_cast<float*>(out)[int64_t(blockIdx.x) * kSlots + r * kLanes +
                             lane] = acc[r];
}

// y[g, s] = sum over parts p in order of partial[(g*parts + p), s]
__global__ void __launch_bounds__(kThreads)
fold_parts(const float* __restrict__ partial, int64_t steps, int parts,
           float* __restrict__ y) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= steps * kSlots) return;
  const int64_t g = t / kSlots;
  const int s = int(t % kSlots);
  float sum = 0.f;
  for (int q = 0; q < parts; ++q)
    sum += partial[(g * parts + q) * kSlots + s];
  y[t] = sum;
}

// Column sum over one or two f32 streams of n_rows rows: thread t of a block
// owns lanes 4*(t % 32) .. +3 of rows t / 32 + 8 k; the grid strides over
// whole 8-row groups. A block's 8 row-threads of a lane are added in order
// into its 128-lane partial.
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
              int64_t n_rows, float* __restrict__ partial) {
  const int t = threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * 8;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t row = int64_t(blockIdx.x) * 8 + t / 32; row < n_rows;
       row += kUnroll * stride) {
    float4 va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = row + u * stride;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      va[u] = w < n_rows ? __ldg(a + w * 32 + t % 32) : zero;
      if (kTwo) vb[u] = w < n_rows ? __ldg(b + w * 32 + t % 32) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kTwo) {  // the TPU adds a + b per entry, then sums
        va[u].x += vb[u].x;
        va[u].y += vb[u].y;
        va[u].z += vb[u].z;
        va[u].w += vb[u].w;
      }
      acc.x += va[u].x;
      acc.y += va[u].y;
      acc.z += va[u].z;
      acc.w += va[u].w;
    }
  }
  __shared__ float4 sh[kThreads];
  sh[t] = acc;
  __syncthreads();
  if (t < kLanes) {
    float s = 0.f;
    for (int k = 0; k < 8; ++k)
      s += reinterpret_cast<const float*>(sh + k * 32)[t];
    partial[int64_t(blockIdx.x) * kLanes + t] = s;
  }
}

__device__ __forceinline__ float to_f32(float t) { return t; }
__device__ __forceinline__ float to_f32(unsigned t) { return float(int(t)); }

// out[i, lane] = sum over blocks of partial[b, lane], every row i: warp
// `lane` adds blocks lane', lane' + 32, ... then a shuffle tree. T = float
// (colsum) or unsigned (halves-pure: the wrapped sum, read as int32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_cols(const T* __restrict__ partial, int n_blocks, float* __restrict__ out) {
  const int lane = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int l = threadIdx.x % 32;
  T t = T(0);
  for (int b = l; b < n_blocks; b += 32) t += partial[int64_t(b) * kLanes + lane];
#pragma unroll
  for (int d = 16; d > 0; d /= 2) t += __shfl_down_sync(0xffffffffu, t, d);
  if (l == 0) {
    const float v = to_f32(t);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i * kLanes + lane] = v;
  }
}
constexpr int kFoldColBlocks = kLanes * 32 / kThreads;

int finish_parts(const float* partial, int64_t steps, const Geo& p, float* y,
                 cudaStream_t s) {
  int err = int(cudaGetLastError());
  if (err || p.parts == 1) return err;
  const int64_t n = steps * kSlots;
  fold_parts<<<unsigned((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      partial, steps, p.parts, y);
  return int(cudaGetLastError());
}

template <typename CodeT>
int decode(int mode, const void* ja, const float* as, const int* tab,
           const float* x, float* partial, float* y, int64_t steps,
           const Geo& p, cudaStream_t s) {
  float* out = p.parts == 1 ? y : partial;
  const unsigned nb = unsigned(steps * p.parts);
  const auto* j = static_cast<const CodeT*>(ja);
  switch (mode) {
#define KP_MODE(M)                                                        \
  case M:                                                                 \
    decode_kernel<M, CodeT><<<nb, kLanes, 0, s>>>(j, as, tab, x, out, p); \
    break;
    KP_MODE(kStream)
    KP_MODE(kBcast)
    KP_MODE(kWindow)
    KP_MODE(kMasked)
    KP_MODE(kSbList)
    KP_MODE(kWl)
#undef KP_MODE
    default:
      return int(cudaErrorInvalidValue);
  }
  return finish_parts(partial, steps, p, y, s);
}

}  // namespace kp

// mode: 0 stream, 1 bcast, 2 window, 3 masked, 4 sblist, 5 wl; code_bytes:
// 4, 2 or 1 (int32, int16, int8 codes). ja and as: steps*kb rows of 128;
// tab: steps rows of tcols int32; x: rows of 128 f32; partial: steps*parts
// (8, 128) f32 tiles of scratch (unused when parts == 1); y: steps*8 rows.
extern "C" int kp_decode(int mode, int code_bytes, const void* ja,
                         const float* as, const int* tab, const float* x,
                         float* partial, float* y, int64_t steps, int kb,
                         int ck, int span, int L, int stride, int tcols,
                         int parts, int gpp, void* stream) {
  if (steps <= 0) return int(cudaGetLastError());
  const kp::Geo p{kb, ck, span, L, stride, tcols, parts, gpp};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 4:
      return kp::decode<int32_t>(mode, ja, as, tab, x, partial, y, steps, p, s);
    case 2:
      return kp::decode<int16_t>(mode, ja, as, tab, x, partial, y, steps, p, s);
    case 1:
      return kp::decode<int8_t>(mode, ja, as, tab, x, partial, y, steps, p, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// mode: 0 fused8 (steps*kb*2 plane rows; y steps*8 rows), 1 halves-gather
// (tab steps rows of tcols = kb/8; y steps*8 rows), 2 halves-pure (y the
// (8, 128) column sum; partial steps*parts*128 uint32). partial otherwise as
// kp_decode's.
extern "C" int kp_fused(int mode, const int* f, const int* tab,
                        const float* x, void* partial, float* y,
                        int64_t steps, int kb, int tcols, int parts, int gpp,
                        void* stream) {
  if (steps <= 0) return int(cudaGetLastError());
  const kp::Geo p{kb, 8, 1, 1, 1, tcols, parts, gpp};
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned nb = unsigned(steps * parts);
  float* out = parts == 1 ? y : static_cast<float*>(partial);
  switch (mode) {
    case kp::kFused8:
      kp::fused_kernel<kp::kFused8><<<nb, kp::kLanes, 0, s>>>(f, tab, x, out,
                                                              p);
      break;
    case kp::kHalvesGather:
      kp::fused_kernel<kp::kHalvesGather><<<nb, kp::kLanes, 0, s>>>(
          f, tab, x, out, p);
      break;
    case kp::kHalvesPure: {
      kp::fused_kernel<kp::kHalvesPure><<<nb, kp::kLanes, 0, s>>>(
          f, tab, x, partial, p);
      const int err = int(cudaGetLastError());
      if (err) return err;
      kp::fold_cols<unsigned><<<kp::kFoldColBlocks, kp::kThreads, 0, s>>>(
          static_cast<const unsigned*>(partial), int(nb), y);
      return int(cudaGetLastError());
    }
    default:
      return int(cudaErrorInvalidValue);
  }
  return kp::finish_parts(static_cast<const float*>(partial), steps, p, y, s);
}

// a (and b when two): n_rows rows of 128 f32; partial: n_blocks * 128 f32;
// out: (8, 128), every row the column sum
extern "C" int kp_colsum(const float* a, const float* b, int two,
                         int64_t n_rows, int n_blocks, float* partial,
                         float* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_rows > 0 && n_blocks > 0) {
    const auto* a4 = reinterpret_cast<const float4*>(a);
    const auto* b4 = reinterpret_cast<const float4*>(b);
    if (two)
      kp::colsum_kernel<true><<<n_blocks, kp::kThreads, 0, s>>>(a4, b4, n_rows,
                                                                partial);
    else
      kp::colsum_kernel<false><<<n_blocks, kp::kThreads, 0, s>>>(a4, b4, n_rows,
                                                                 partial);
    const int err = int(cudaGetLastError());
    if (err) return err;
  }
  kp::fold_cols<float><<<kp::kFoldColBlocks, kp::kThreads, 0, s>>>(
      partial, n_rows > 0 ? n_blocks : 0, out);
  return int(cudaGetLastError());
}
