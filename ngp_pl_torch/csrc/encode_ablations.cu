// K9: stripped variants of the packed-f16 encode forward, the encode-kernel
// ablation bench.  Replaces the Pallas kernels of
// benchmarking/micro_pallas_fwd.py: `make_variant` (pallas_call :56) and
// `make_variant_bn` (:231) with the bodies `full_kernel`, `no_decode_kernel`,
// `no_wrow_kernel`, `no_ft_kernel` and `stream_kernel`, and
// `make_variant_interleaved` (:267) with `full_kernel_il`.  `make_variant_bn`
// computes the same function as `make_variant` with another TPU block; here
// both are the same kernel, with its own tile of 128 samples.
//
// Semantics (held against `encode_ablation_plain` in
// ngp_pl_torch/ops/encode_ablations.py): rows of 64 u32 words per level and
// sample, word j holding the f16 bits of lane j (low half) and of lane
// j + 64 (high half); per level
//   wr = bf16(dec(lo) * w(lane)), bf16(dec(hi) * w(lane + 64)),
//   w(lane) = ((hat_x * hat_y) * hat_z) * valid in f32 for the lane's point
//   min(lane / 4, 26), hat(c) = max(0, 1 - |c - p|), valid = lane < 108;
//   ft2[l, f, n] = sum of wr over the valid lanes = f (mod 4), in f32;
//   h1[n] += wr (128 lanes) x bf16(w1big[l]) (128 x 64), f32 accumulation.
// no_decode reads bitcast_f32(u) for both halves; no_wrow drops the weight and
// the valid mask (lanes 108-127 reach h1, not ft2); no_ft writes ft2 = 0;
// stream sums bitcast_f32(u) over the levels into h1 and writes ft2 = 0.
// The f16 decoder is the TPU kernel's integer one, which maps exponent 31 to
// 2^16 * (1 + m/1024) * sign, not inf or NaN (`__half2float` would not).
//
// What bounds it on an H100: bytes.  At the bench's N = 196,608 and L = 8 it
// reads 402.7 MB of rows, 18.9 MB of p-values (3 of meta_T's 4 rows) and
// writes 50.3 MB of h1 and 25.2 MB of ft2: 0.148 ms at 3.35 TB/s, far past
// the 50 MB L2.  The contraction, 2.58e10 flops, takes 0.026 ms on the
// tensor cores and 0.385 ms on the f32 pipes, so it runs on the tensor cores
// (bf16 `wmma` fragments, f32 accumulators, the MXU's own semantics).
// Design: one block of 8 warps per tile of 128 samples.  Per level, each
// thread loads eight 16-byte chunks of rows (coalesced), decodes and weights
// them into a bf16 tile in shared memory (128 x 128, padded rows) and sums
// its chunk's feature partials, which a 16-lane shuffle tree reduces per
// sample; bf16(w1big[l]) goes to shared memory beside it.  Each warp then
// multiplies its 16 samples by the 128 x 64 weight with 4 accumulator
// fragments that live across all levels.  The next level's rows are loaded
// while the tensor cores run.  The variants are compile-time flags of one
// template, so each stripped instance really drops its work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWords = 64;    // u32 words per row: f16 lanes j and j + 64
constexpr int kLanes = 128;   // lanes per row
constexpr int kH = 64;        // h1 width
constexpr int kF = 4;         // features per level
constexpr int kPts = 27;      // corner points per row
constexpr int kTile = 128;    // samples per block
constexpr int kThreads = 256;
constexpr int kChunks = kTile * kWords / 4 / kThreads;   // uint4 per thread
constexpr int kLdA = kLanes + 8;   // bf16 row strides in shared memory
constexpr int kLdB = kH + 8;
constexpr size_t kSmemBytes =
    (size_t)kTile * kLdA * 2 + (size_t)kLanes * kLdB * 2 + kF * kTile * 4;

static_assert(kTile / 16 * 32 == kThreads, "one warp per 16 samples");
static_assert(kChunks * kThreads * 4 == kTile * kWords, "whole chunks");

enum Variant { kFull, kNoDecode, kNoWrow, kNoFt, kStream };

__device__ __forceinline__ float f16_bits_to_f32(uint32_t h) {
  h &= 0xFFFFu;
  const uint32_t s = h >> 15, e = (h >> 10) & 0x1Fu, m = h & 0x3FFu;
  if (e == 0) {   // subnormal or zero: m * 2^-24, signed
    return __fmul_rn(__fmul_rn((float)m, 5.9604644775390625e-8f),
                     s ? -1.f : 1.f);
  }
  return __uint_as_float((s << 31) | ((e + 112u) << 23) | (m << 13));
}

__device__ __forceinline__ float hat(int c, float p) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn((float)c, p))));
}

// ((hat_x * hat_y) * hat_z) of corner point `pt` (cx, cy, cz in {0, 1, 2})
__device__ __forceinline__ float point_weight(int pt, float px, float py,
                                              float pz) {
  return __fmul_rn(__fmul_rn(hat(pt / 9, px), hat((pt / 3) % 3, py)),
                   hat(pt % 3, pz));
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p,
                                             const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// Start row (of 64 words) of the tile at sample n0 in level l.  Interleaved
// rows are laid out (n / bn, L, bn, 64); a tile never crosses a block.
template <bool kIl>
__device__ __forceinline__ size_t tile_row(int n0, int l, int n, int levels,
                                           int bn) {
  return kIl ? ((size_t)(n0 / bn) * levels + l) * bn + (n0 % bn)
             : (size_t)l * n + n0;
}

// This thread's chunks of one tile: chunk i is words 4c..4c+3 of sample s,
// c = tid % 16, s = tid / 16 + 16 i (consecutive threads, consecutive bytes).
__device__ __forceinline__ void load_chunks(const uint4* tile,
                                            uint4 (&q)[kChunks]) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    q[i] = __ldg(tile + threadIdx.x + kThreads * i);
  }
}

template <Variant V, bool kIl>
__global__ void __launch_bounds__(kThreads, 2)
encode_ablation_kernel(const uint4* __restrict__ rows,
                       const float* __restrict__ meta,
                       const float* __restrict__ w1big,
                       float* __restrict__ h1, float* __restrict__ ft2, int n,
                       int levels, int bn) {
  const int n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int c = tid & 15;
  uint4 q[kChunks];
  load_chunks(rows + tile_row<kIl>(n0, 0, n, levels, bn) * (kWords / 4), q);

  if constexpr (V == kStream) {
    float acc[kChunks][4];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    for (int l = 0; l < levels; ++l) {
      if (l > 0) {
        load_chunks(rows + tile_row<kIl>(n0, l, n, levels, bn) * (kWords / 4),
                    q);
      }
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        acc[i][0] += __uint_as_float(q[i].x);
        acc[i][1] += __uint_as_float(q[i].y);
        acc[i][2] += __uint_as_float(q[i].z);
        acc[i][3] += __uint_as_float(q[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int s = (tid >> 4) + 16 * i;
      reinterpret_cast<float4*>(h1 + (size_t)(n0 + s) * kH)[c] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    for (int k = tid; k < levels * kF * kTile; k += kThreads) {
      ft2[(size_t)(k / kTile) * n + n0 + k % kTile] = 0.f;
    }
    return;
  } else {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // wr tile
    __nv_bfloat16* bs = as + kTile * kLdA;                       // bf16 w1
    float* fts = reinterpret_cast<float*>(bs + kLanes * kLdB);   // ft2 tile
    const int warp = tid >> 5;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kH / 16];
#pragma unroll
    for (int t = 0; t < kH / 16; ++t) wmma::fill_fragment(acc[t], 0.f);

    for (int l = 0; l < levels; ++l) {
      const float4* w = reinterpret_cast<const float4*>(
          w1big + (size_t)l * kLanes * kH);
      for (int k = tid; k < kLanes * kH / 4; k += kThreads) {
        const float4 v = __ldg(w + k);
        float f[4] = {v.x, v.y, v.z, v.w};
        store_bf16x4(bs + (4 * k / kH) * kLdB + 4 * k % kH, f);
      }
      const float* m = meta + (size_t)l * 4 * n + n0;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int s = (tid >> 4) + 16 * i;
        // lanes 4c..4c+3 carry point c; lanes 64+4c.. point min(16+c, 26),
        // valid while 64 + 4c < 108
        float w_lo = 1.f, w_hi = 1.f;
        if (V != kNoWrow) {
          const float px = __ldg(m + s), py = __ldg(m + n + s),
                      pz = __ldg(m + 2 * n + s);
          w_lo = point_weight(c, px, py, pz);
          w_hi = c < 11 ? point_weight(16 + c, px, py, pz) : 0.f;
        }
        const uint32_t u[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
        float lo[4], hi[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float a = V == kNoDecode ? __uint_as_float(u[k])
                                         : f16_bits_to_f32(u[k]);
          const float b = V == kNoDecode ? __uint_as_float(u[k])
                                         : f16_bits_to_f32(u[k] >> 16);
          lo[k] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, w_lo)));
          hi[k] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(b, w_hi)));
        }
        store_bf16x4(as + s * kLdA + 4 * c, lo);
        store_bf16x4(as + s * kLdA + kWords + 4 * c, hi);
        if (V != kNoFt) {
          // lane 4c + k and 64 + 4c + k carry feature k; the 16 threads of
          // a sample hold its 16 chunks
          float p[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) p[k] = c < 11 ? lo[k] + hi[k] : lo[k];
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              p[k] += __shfl_xor_sync(0xffffffffu, p[k], off);
            }
          }
          if (c == 0) {
#pragma unroll
            for (int k = 0; k < 4; ++k) fts[k * kTile + s] = p[k];
          }
        }
      }
      __syncthreads();
      if (l + 1 < levels) {   // in flight while the tensor cores run
        load_chunks(
            rows + tile_row<kIl>(n0, l + 1, n, levels, bn) * (kWords / 4), q);
      }
#pragma unroll
      for (int k = 0; k < kLanes; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, as + warp * 16 * kLdA + k, kLdA);
#pragma unroll
        for (int t = 0; t < kH / 16; ++t) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(b, bs + k * kLdB + t * 16, kLdB);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
      float* out = ft2 + (size_t)l * kF * n + n0;
      for (int k = tid; k < kF * kTile; k += kThreads) {
        out[(size_t)(k / kTile) * n + k % kTile] =
            V == kNoFt ? 0.f : fts[k];
      }
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < kH / 16; ++t) {
      wmma::store_matrix_sync(h1 + (size_t)(n0 + warp * 16) * kH + t * 16,
                              acc[t], kH, wmma::mem_row_major);
    }
  }
}

template <Variant V, bool kIl>
int launch(const void* rows, const void* meta, const void* w1big, void* h1,
           void* ft2, int n, int levels, int bn, void* stream) {
  if (n < kTile || n % kTile || levels < 1 ||
      (kIl && (bn < kTile || bn % kTile || n % bn))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = V == kStream ? 0 : kSmemBytes;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_ablation_kernel<V, kIl>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  encode_ablation_kernel<V, kIl>
      <<<n / kTile, kThreads, smem, (cudaStream_t)stream>>>(
          (const uint4*)rows, (const float*)meta, (const float*)w1big,
          (float*)h1, (float*)ft2, n, levels, bn);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry: rows (L, n, 64) u32 ((n / bn, L, bn, 64) for full_il), meta
// (L, 4, n) f32, w1big (L, 128, 64) f32 -> h1 (n, 64) f32, ft2 (L, 4, n)
// f32; n a multiple of 128 (and of bn, itself a multiple of 128, for
// full_il).  Returns cudaGetLastError().
#define K9_ENTRY(name, V, IL)                                                 \
  extern "C" int name(const void* rows, const void* meta, const void* w1big, \
                      void* h1, void* ft2, int n, int levels, int bn,        \
                      void* stream) {                                        \
    return launch<V, IL>(rows, meta, w1big, h1, ft2, n, levels, bn, stream); \
  }

K9_ENTRY(encode_ablation_full, kFull, false)
K9_ENTRY(encode_ablation_no_decode, kNoDecode, false)
K9_ENTRY(encode_ablation_no_wrow, kNoWrow, false)
K9_ENTRY(encode_ablation_no_ft, kNoFt, false)
K9_ENTRY(encode_ablation_stream, kStream, false)
K9_ENTRY(encode_ablation_full_il, kFull, true)
