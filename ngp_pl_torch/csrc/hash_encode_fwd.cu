// K1 and K3: fused multiresolution hash encode + first dense layer, forward
// only.  One kernel template, two instances:
//   K1, F=4: replaces `_fwd_kernel_packed` (the packed-f16 branch of
//     `encode_mlp_fwd_pallas`, ngp_pl_tpu/ops/hash_encoding_pallas.py);
//     reads rows of 128 halves from the f16 table copy;
//   K3, F=2: replaces `_fwd_kernel` (its f32/paired branch); reads rows of
//     64 floats from the f32 table itself, as the TPU gathered f32 rows for
//     64-wide rows (ngp_pl_tpu/ops/hash_encoding.py `_encode_mlp_pl_fwd`).
// Both take along the XLA code around the TPU kernels in `_encode_mlp_pl_fwd`:
// slot/local/frac computation, the brick-row gather, the trilinear
// interpolation and the 32 -> 64 contraction.  The TPU left the gather in XLA
// only because it has no gather hardware; here one thread does all of it for
// one sample.  K3's TPU kernel paired two samples per 128-lane row with a
// block-diagonal w1, a layout trick for its 128-lane tiles that a thread per
// sample does not need.
//
// Semantics (held against the plain version `hash_encode_fwd_plain` in
// ngp_pl_torch/ops/hash_encoding.py):
//   x clipped to [0,1]; per level l: pos = x * R_l, cell = clip(floor(pos)),
//   brick = cell >> 1, local = cell & 1, p = local + frac;
//   slot = dense index (coarse levels) or the Instant-NGP spatial hash of the
//   brick, primes (1, 2654435761, 805459861) in uint32, masked to 2^lb rows;
//   corner weight w = (hat_x * hat_y) * hat_z, hat(c) = max(0, 1-|c-p|),
//   rounded to bf16 for F=4 only (the packed TPU kernel expands its weights
//   with a bf16 dot, `_expand_w27`; the f32 one keeps them in f32, `_wrow`);
//   feature f = sum over the 8 corners of bf16(row[corner, f] * w), in f32;
//   h1 = sum_l,f feature * bf16(w1[l*F + f]), accumulated in f32.
// These are the TPU kernels' rounding points.  The position math uses the
// _rn intrinsics so nvcc cannot contract it into FMAs and move a sample
// across a cell edge.
//
// What bounds it on an H100: per sample it reads 12 B of x and writes 256 B
// of h1 from device memory.  The floor is that h1 write (bytes), but this
// simple design is bound by the latency of its dependent table reads: one
// thread per sample, 8 dependent 8-byte reads per level (4 halves or 2
// floats of one corner), w1 (bf16-rounded, as f32) in shared memory read as
// broadcasts, 64 f32 accumulators in registers.
//   K1 (L=8, F=4, T=2^19): the f16 copy, 26.3 MB, stays in the 50 MB L2.
//   K3 (L=16, F=2, T=2^19): twice the levels, and the f32 table, 56.5 MB
//   (220,851 rows of 256 B), no longer fits the L2, so reads of the hashed
//   levels go to device memory part of the time.
// Sharing a sample's work across a warp, an mma-based contraction and, for
// K3, an f16 or level-sorted table are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kH = 64;       // first-layer width
constexpr int kBlock = 128;

struct Levels {
  int n_levels;
  uint32_t hash_mask;
  float res_f[kMaxLevels];
  int res[kMaxLevels];
  int bgrid[kMaxLevels];
  int offset[kMaxLevels];
  int dense[kMaxLevels];
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float hat(int c, float p) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn((float)c, p))));
}

// The F features of one corner point: 8 contiguous, 8-byte aligned bytes.
__device__ __forceinline__ void load_corner(const __half* p, float (&v)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __half2 lo = *reinterpret_cast<const __half2*>(&raw.x);
  const __half2 hi = *reinterpret_cast<const __half2*>(&raw.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ void load_corner(const float* p, float (&v)[2]) {
  const float2 raw = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = raw.x;
  v[1] = raw.y;
}

__device__ __forceinline__ void store_feats(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_feats(float* p, const float (&f)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
}

// F features per level, table rows of T (32 * F of them: 27 corner points x
// F, padded), corner weights rounded to bf16 when kRoundW.
template <int F, typename T, bool kRoundW>
__global__ void __launch_bounds__(kBlock)
hash_encode_fwd_kernel(const float* __restrict__ x,
                       const T* __restrict__ table,
                       const float* __restrict__ w1,
                       float* __restrict__ h1,
                       float* __restrict__ feats,
                       int n, Levels lv) {
  constexpr int kRowW = 32 * F;
  __shared__ float w1s[kMaxLevels * F * kH];
  const int lf = lv.n_levels * F;
  for (int k = threadIdx.x; k < lf * kH; k += blockDim.x) {
    w1s[k] = bf16_round(w1[k]);
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float xs[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    xs[a] = fminf(fmaxf(x[3 * i + a], 0.f), 1.f);
  }

  float acc[kH];
#pragma unroll
  for (int j = 0; j < kH; ++j) acc[j] = 0.f;

  for (int l = 0; l < lv.n_levels; ++l) {
    int brick[3], loc[3];
    float p[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = __fmul_rn(xs[a], lv.res_f[l]);
      const float cellf = floorf(pos);
      const float frac = __fsub_rn(pos, cellf);
      const int cell = min(max((int)cellf, 0), lv.res[l] - 1);
      brick[a] = cell >> 1;
      loc[a] = cell & 1;
      p[a] = __fadd_rn((float)loc[a], frac);
    }
    uint32_t slot;
    if (lv.dense[l]) {
      const int b = lv.bgrid[l];
      slot = (uint32_t)((brick[0] * b + brick[1]) * b + brick[2]);
    } else {
      slot = ((uint32_t)brick[0] ^ (uint32_t)brick[1] * 2654435761u ^
              (uint32_t)brick[2] * 805459861u) & lv.hash_mask;
    }
    const T* row = table + (size_t)(lv.offset[l] + (int)slot) * kRowW;

    float wx[2], wy[2], wz[2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      wx[d] = hat(loc[0] + d, p[0]);
      wy[d] = hat(loc[1] + d, p[1]);
      wz[d] = hat(loc[2] + d, p[2]);
    }

    float f[F];
#pragma unroll
    for (int k = 0; k < F; ++k) f[k] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
      float w = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
      if (kRoundW) w = bf16_round(w);
      const int pt = ((loc[0] + dx) * 3 + (loc[1] + dy)) * 3 + (loc[2] + dz);
      float v[F];
      load_corner(row + pt * F, v);
#pragma unroll
      for (int k = 0; k < F; ++k) f[k] += bf16_round(__fmul_rn(v[k], w));
    }

    if (feats != nullptr) store_feats(feats + (size_t)i * lf + l * F, f);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const float* wrow = w1s + (l * F + k) * kH;
#pragma unroll
      for (int j = 0; j < kH; j += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + j);
        acc[j] = fmaf(f[k], w.x, acc[j]);
        acc[j + 1] = fmaf(f[k], w.y, acc[j + 1]);
        acc[j + 2] = fmaf(f[k], w.z, acc[j + 2]);
        acc[j + 3] = fmaf(f[k], w.w, acc[j + 3]);
      }
    }
  }

  float4* out = reinterpret_cast<float4*>(h1 + (size_t)i * kH);
#pragma unroll
  for (int j = 0; j < kH; j += 4) {
    out[j / 4] = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  }
}

template <int F, typename T, bool kRoundW>
int launch(const void* x, const void* table, const void* w1, void* h1,
           void* feats, int n, int n_levels, int log2_bricks, const int* res,
           const int* bgrid, const int* offset, const int* dense,
           void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  lv.n_levels = n_levels;
  lv.hash_mask = (uint32_t)((1ull << log2_bricks) - 1ull);
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < n_levels;
    lv.res[l] = used ? res[l] : 1;
    lv.res_f[l] = (float)lv.res[l];
    lv.bgrid[l] = used ? bgrid[l] : 1;
    lv.offset[l] = used ? offset[l] : 0;
    lv.dense[l] = used ? dense[l] : 1;
  }
  const int grid = (n + kBlock - 1) / kBlock;
  hash_encode_fwd_kernel<F, T, kRoundW>
      <<<grid, kBlock, 0, (cudaStream_t)stream>>>(
          (const float*)x, (const T*)table, (const float*)w1, (float*)h1,
          (float*)feats, n, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: x (n, 3) f32, table (rows, 128) f16, w1 (n_levels*4, 64) f32 -> h1
// (n, 64) f32 and, when feats is not null, feats (n, n_levels*4) f32.  The
// level arrays are host pointers of n_levels ints each.  Returns
// cudaGetLastError().
extern "C" int hash_encode_fwd(const void* x, const void* table,
                               const void* w1, void* h1, void* feats, int n,
                               int n_levels, int log2_bricks, const int* res,
                               const int* bgrid, const int* offset,
                               const int* dense, void* stream) {
  return launch<4, __half, true>(x, table, w1, h1, feats, n, n_levels,
                                 log2_bricks, res, bgrid, offset, dense,
                                 stream);
}

// K3: as K1 with table (rows, 64) f32, w1 (n_levels*2, 64) f32 and feats
// (n, n_levels*2) f32.
extern "C" int hash_encode_fwd_f2(const void* x, const void* table,
                                  const void* w1, void* h1, void* feats,
                                  int n, int n_levels, int log2_bricks,
                                  const int* res, const int* bgrid,
                                  const int* offset, const int* dense,
                                  void* stream) {
  return launch<2, float, false>(x, table, w1, h1, feats, n, n_levels,
                                 log2_bricks, res, bgrid, offset, dense,
                                 stream);
}
