// K8: fused field tail, backward.
//
// Replaces the TPU kernel ngp_pl_tpu/ops/field_pallas.py `_bwd_kernel`
// (called by `_field_tail_bwd`, the custom VJP of `field_tail`): it
// recomputes the forward from h1 and sh, backpropagates to dh1 and sums the
// four weight gradients over all samples.  No gradient goes to sh.
//
// Semantics (held against the plain version `field_tail_bwd_plain` in
// ngp_pl_torch/ops/field_tail.py); every product has bf16-rounded operands
// and an f32 accumulator, as on the TPU.  With the forward of K7
// (csrc/field_tail_fwd.cu): x = relu(h1), h = x W2, z1 = [sh | h] Wr1,
// r1 = relu(z1), z2 = r1 Wr2, r2 = relu(z2), z3 = r2 Wr3, rgb = sigmoid(z3):
//   d_z3  = g_rgb * rgb * (1 - rgb)
//   d_z2  = [z2 > 0] (d_z3 Wr3^T)         d_z1 = [z1 > 0] (d_z2 Wr2^T)
//   d_h   = d_z1 Wr1[16:]^T + e0 * g_sigma * exp(clip(h[0], -15, 15))
//   dh1   = [h1 > 0] (d_h W2^T)
//   dW2 = x^T d_h, dWr1 = [sh | h]^T d_z1, dWr2 = r1^T d_z2, dWr3 = r2^T d_z3
// summed over the samples.  Layouts are sample-major: h1 (P, 64), sh (P, 16),
// g_sigma (P,), g_rgb (P, 3), dh1 (P, 64).
//
// What bounds it on an H100: it must move 592 B per sample (h1, sh and the
// two gradients in, dh1 out); its ~45k FLOP per sample would take less at
// the bf16 tensor-core rate, so the floor is bytes.  This simple design runs
// the per-sample forward and backward on the f32 pipes, one thread per
// sample as K7, so it is bound by operations.  The weight gradients are
// contractions over the samples: each block walks tiles of 128 samples,
// keeps the tile's bf16 activations and gradients in 76 KB of shared memory
// (row strides padded against bank conflicts) and contracts them into 59
// per-thread f32 accumulators; a second kernel sums the blocks' partials in
// a fixed order, so the weight gradients are deterministic.  Moving both the
// per-sample layers and the contractions onto mma/wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHid = 64;
constexpr int kGeo = 16;
constexpr int kSh = 16;
constexpr int kBlock = 128;   // threads per block = samples per tile
constexpr int kLd = 66;       // bf16 row stride of the 64-wide tiles
constexpr int kLd16 = 18;     // of the 16-wide tiles
constexpr int kLd3 = 4;       // of the d_z3 tile
// weight-gradient layout of the partials and of the output
constexpr int kOffW2 = 0;
constexpr int kOffWr1 = kOffW2 + kHid * kGeo;            // 1024
constexpr int kOffWr2 = kOffWr1 + (kSh + kGeo) * kHid;   // 3072
constexpr int kOffWr3 = kOffWr2 + kHid * kHid;           // 7168
constexpr int kGrads = kOffWr3 + kHid * 3;               // 7360

struct Weights {
  float w2[kHid * kGeo];              // (64, 16)
  float wr1[(kSh + kGeo) * kHid];     // (32, 64)
  float wr2t[kHid * kHid];            // Wr2 transposed: wr2t[j][i] = Wr2[i][j]
  float wr3[kHid * 3];                // (64, 3)
};

struct Tiles {
  __nv_bfloat16 r1[kBlock * kLd];     // bf16(relu(z1))
  __nv_bfloat16 r2[kBlock * kLd];     // bf16(relu(z2))
  __nv_bfloat16 dz2[kBlock * kLd];
  __nv_bfloat16 dz1[kBlock * kLd];
  __nv_bfloat16 hb[kBlock * kLd16];   // bf16(h)
  __nv_bfloat16 dh[kBlock * kLd16];   // bf16(d_h)
  __nv_bfloat16 dz3[kBlock * kLd3];   // bf16(d_z3), lane 3 unused
};

constexpr size_t kSmem = sizeof(Weights) + sizeof(Tiles);

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ __nv_bfloat16 bf16(float v) {
  return __float2bfloat16_rn(v);
}

// Forward and backward of one sample; stores its tile rows and dh1.
__device__ __forceinline__ void sample_bwd(
    const Weights& s, Tiles& t, int tid, int i, const float* __restrict__ h1,
    const float* __restrict__ sh, const float* __restrict__ g_sigma,
    const float* __restrict__ g_rgb, float* __restrict__ dh1) {
  // sigma layer 2: h = bf16(relu(h1)) @ W2
  float h[kGeo];
#pragma unroll
  for (int k = 0; k < kGeo; ++k) h[k] = 0.f;
  uint64_t m0 = 0;
  const float4* h1v = reinterpret_cast<const float4*>(h1 + (size_t)i * kHid);
#pragma unroll 4
  for (int q = 0; q < kHid / 4; ++q) {
    const float4 v = h1v[q];
    const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (xv[e] > 0.f) m0 |= 1ull << (4 * q + e);
      const float xb = bf16_round(fmaxf(xv[e], 0.f));
      const float* wrow = s.w2 + (4 * q + e) * kGeo;
#pragma unroll
      for (int k = 0; k < kGeo; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + k);
        h[k] = fmaf(xb, w.x, h[k]);
        h[k + 1] = fmaf(xb, w.y, h[k + 1]);
        h[k + 2] = fmaf(xb, w.z, h[k + 2]);
        h[k + 3] = fmaf(xb, w.w, h[k + 3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kGeo; ++k) t.hb[tid * kLd16 + k] = bf16(h[k]);

  // rgb layer 1: z1 = bf16(sh) @ Wr1[:16] + bf16(h) @ Wr1[16:]
  float r1[kHid];
#pragma unroll
  for (int j = 0; j < kHid; ++j) r1[j] = 0.f;
  const float4* shv = reinterpret_cast<const float4*>(sh + (size_t)i * kSh);
  // Not unrolled: fully unrolled, this loop made cicc (CUDA 12.8) take about
  // four minutes over this file; rolled, it builds in seconds and runs as
  // fast.
#pragma unroll 1
  for (int q = 0; q < (kSh + kGeo) / 4; ++q) {
    float in[4];
    if (q < kSh / 4) {
      const float4 v = shv[q];
      in[0] = v.x; in[1] = v.y; in[2] = v.z; in[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) in[e] = h[4 * q - kSh + e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ib = bf16_round(in[e]);
      const float* wrow = s.wr1 + (4 * q + e) * kHid;
#pragma unroll
      for (int j = 0; j < kHid; j += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + j);
        r1[j] = fmaf(ib, w.x, r1[j]);
        r1[j + 1] = fmaf(ib, w.y, r1[j + 1]);
        r1[j + 2] = fmaf(ib, w.z, r1[j + 2]);
        r1[j + 3] = fmaf(ib, w.w, r1[j + 3]);
      }
    }
  }
  uint64_t m1 = 0;
#pragma unroll
  for (int j = 0; j < kHid; ++j) {
    if (r1[j] > 0.f) m1 |= 1ull << j;
    r1[j] = bf16_round(fmaxf(r1[j], 0.f));
    t.r1[tid * kLd + j] = bf16(r1[j]);
  }

  // rgb layers 2 and 3, one hidden unit at a time
  float z3[3] = {0.f, 0.f, 0.f};
  uint64_t m2 = 0;
  for (int j = 0; j < kHid; ++j) {
    const float* wcol = s.wr2t + j * kHid;
    float z = 0.f;
#pragma unroll
    for (int k = 0; k < kHid; k += 4) {
      const float4 w = *reinterpret_cast<const float4*>(wcol + k);
      z = fmaf(r1[k], w.x, z);
      z = fmaf(r1[k + 1], w.y, z);
      z = fmaf(r1[k + 2], w.z, z);
      z = fmaf(r1[k + 3], w.w, z);
    }
    if (z > 0.f) m2 |= 1ull << j;
    const float r2 = bf16_round(fmaxf(z, 0.f));
    t.r2[tid * kLd + j] = bf16(r2);
    z3[0] = fmaf(r2, s.wr3[j * 3], z3[0]);
    z3[1] = fmaf(r2, s.wr3[j * 3 + 1], z3[1]);
    z3[2] = fmaf(r2, s.wr3[j * 3 + 2], z3[2]);
  }

  // sigmoid backward
  float dz3[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rgb = 1.f / (1.f + expf(-z3[c]));
    dz3[c] = bf16_round(__fmul_rn(__fmul_rn(g_rgb[(size_t)i * 3 + c], rgb),
                                  __fsub_rn(1.f, rgb)));
    t.dz3[tid * kLd3 + c] = bf16(dz3[c]);
  }
  t.dz3[tid * kLd3 + 3] = bf16(0.f);

  // d_z2 = [z2 > 0] (d_z3 Wr3^T); d_r1 = d_z2 Wr2^T, row j of Wr2^T at once
  float d_r1[kHid];
#pragma unroll
  for (int k = 0; k < kHid; ++k) d_r1[k] = 0.f;
  for (int j = 0; j < kHid; ++j) {
    float d_r2 = dz3[0] * s.wr3[j * 3];
    d_r2 = fmaf(dz3[1], s.wr3[j * 3 + 1], d_r2);
    d_r2 = fmaf(dz3[2], s.wr3[j * 3 + 2], d_r2);
    const float dz2 = bf16_round(((m2 >> j) & 1ull) ? d_r2 : 0.f);
    t.dz2[tid * kLd + j] = bf16(dz2);
    const float* wrow = s.wr2t + j * kHid;
#pragma unroll
    for (int k = 0; k < kHid; k += 4) {
      const float4 w = *reinterpret_cast<const float4*>(wrow + k);
      d_r1[k] = fmaf(dz2, w.x, d_r1[k]);
      d_r1[k + 1] = fmaf(dz2, w.y, d_r1[k + 1]);
      d_r1[k + 2] = fmaf(dz2, w.z, d_r1[k + 2]);
      d_r1[k + 3] = fmaf(dz2, w.w, d_r1[k + 3]);
    }
  }

  // d_z1 = [z1 > 0] d_r1; d_h = d_z1 Wr1[16:]^T + the TruncExp term
  float d_h[kGeo];
#pragma unroll
  for (int k = 0; k < kGeo; ++k) d_h[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kHid; ++j) {
    const float dz1 = bf16_round(((m1 >> j) & 1ull) ? d_r1[j] : 0.f);
    t.dz1[tid * kLd + j] = bf16(dz1);
#pragma unroll
    for (int k = 0; k < kGeo; ++k) {
      d_h[k] = fmaf(dz1, s.wr1[(kSh + k) * kHid + j], d_h[k]);
    }
  }
  d_h[0] += g_sigma[i] * expf(fminf(fmaxf(h[0], -15.f), 15.f));
#pragma unroll
  for (int k = 0; k < kGeo; ++k) {
    d_h[k] = bf16_round(d_h[k]);
    t.dh[tid * kLd16 + k] = bf16(d_h[k]);
  }

  // dh1 = [h1 > 0] (d_h W2^T)
  float4* out = reinterpret_cast<float4*>(dh1 + (size_t)i * kHid);
#pragma unroll 4
  for (int q = 0; q < kHid / 4; ++q) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * q + e;
      const float* wrow = s.w2 + row * kGeo;
      float dx = 0.f;
#pragma unroll
      for (int k = 0; k < kGeo; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + k);
        dx = fmaf(d_h[k], w.x, dx);
        dx = fmaf(d_h[k + 1], w.y, dx);
        dx = fmaf(d_h[k + 2], w.z, dx);
        dx = fmaf(d_h[k + 3], w.w, dx);
      }
      o[e] = ((m0 >> row) & 1ull) ? dx : 0.f;
    }
    out[q] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

__global__ void __launch_bounds__(kBlock, 2)
field_tail_bwd_kernel(const float* __restrict__ h1, const float* __restrict__ sh,
                      const float* __restrict__ g_sigma,
                      const float* __restrict__ g_rgb,
                      const float* __restrict__ w2, const float* __restrict__ wr1,
                      const float* __restrict__ wr2, const float* __restrict__ wr3,
                      float* __restrict__ dh1, float* __restrict__ partial,
                      int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  Weights& s = *reinterpret_cast<Weights*>(smem);
  Tiles& t = *reinterpret_cast<Tiles*>(smem + sizeof(Weights));
  for (int k = threadIdx.x; k < kHid * kGeo; k += blockDim.x)
    s.w2[k] = bf16_round(w2[k]);
  for (int k = threadIdx.x; k < (kSh + kGeo) * kHid; k += blockDim.x)
    s.wr1[k] = bf16_round(wr1[k]);
  for (int k = threadIdx.x; k < kHid * kHid; k += blockDim.x)
    s.wr2t[(k % kHid) * kHid + k / kHid] = bf16_round(wr2[k]);
  for (int k = threadIdx.x; k < kHid * 3; k += blockDim.x)
    s.wr3[k] = bf16_round(wr3[k]);
  __syncthreads();

  const int tid = threadIdx.x;
  // the weight-gradient entries this thread sums over every tile
  const int i2 = tid >> 1;            // row of dWr2 and dW2
  const int jb2 = (tid & 1) * 32;     // 32 columns of dWr2
  const int kb = (tid & 1) * 8;       // 8 columns of dW2
  const int ri = tid >> 2;            // row of dWr1 (0..31)
  const int jb1 = (tid & 3) * 16;     // 16 columns of dWr1
  float a_wr2[32], a_w2[8], a_wr1[16], a_wr3[3];
#pragma unroll
  for (int k = 0; k < 32; ++k) a_wr2[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) a_w2[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) a_wr1[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) a_wr3[k] = 0.f;

  const int n_tiles = (n + kBlock - 1) / kBlock;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kBlock;
    if (base + tid < n) {
      sample_bwd(s, t, tid, base + tid, h1, sh, g_sigma, g_rgb, dh1);
    }
    __syncthreads();
    const int ns = min(kBlock, n - base);
    for (int si = 0; si < ns; ++si) {
      const size_t smp = (size_t)(base + si);
      // dWr2[i2, jb2:jb2+32] += r1[i2] * d_z2[jb2:jb2+32]
      const float a = __bfloat162float(t.r1[si * kLd + i2]);
      const __nv_bfloat162* dz2p =
          reinterpret_cast<const __nv_bfloat162*>(t.dz2 + si * kLd + jb2);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float2 v = __bfloat1622float2(dz2p[q]);
        a_wr2[2 * q] = fmaf(a, v.x, a_wr2[2 * q]);
        a_wr2[2 * q + 1] = fmaf(a, v.y, a_wr2[2 * q + 1]);
      }
      // dW2[i2, kb:kb+8] += bf16(relu(h1[i2])) * d_h[kb:kb+8]
      const float xb = bf16_round(fmaxf(h1[smp * kHid + i2], 0.f));
      const __nv_bfloat162* dhp =
          reinterpret_cast<const __nv_bfloat162*>(t.dh + si * kLd16 + kb);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = __bfloat1622float2(dhp[q]);
        a_w2[2 * q] = fmaf(xb, v.x, a_w2[2 * q]);
        a_w2[2 * q + 1] = fmaf(xb, v.y, a_w2[2 * q + 1]);
      }
      // dWr1[ri, jb1:jb1+16] += [bf16(sh) | bf16(h)][ri] * d_z1[jb1:jb1+16]
      const float in = ri < kSh
          ? bf16_round(sh[smp * kSh + ri])
          : __bfloat162float(t.hb[si * kLd16 + ri - kSh]);
      const __nv_bfloat162* dz1p =
          reinterpret_cast<const __nv_bfloat162*>(t.dz1 + si * kLd + jb1);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 v = __bfloat1622float2(dz1p[q]);
        a_wr1[2 * q] = fmaf(in, v.x, a_wr1[2 * q]);
        a_wr1[2 * q + 1] = fmaf(in, v.y, a_wr1[2 * q + 1]);
      }
      // dWr3[tid, :] += r2[tid] * d_z3
      if (tid < kHid) {
        const float r2 = __bfloat162float(t.r2[si * kLd + tid]);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a_wr3[c] = fmaf(r2, __bfloat162float(t.dz3[si * kLd3 + c]),
                          a_wr3[c]);
        }
      }
    }
    __syncthreads();
  }

  float* part = partial + (size_t)blockIdx.x * kGrads;
#pragma unroll
  for (int k = 0; k < 32; ++k) part[kOffWr2 + i2 * kHid + jb2 + k] = a_wr2[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) part[kOffW2 + i2 * kGeo + kb + k] = a_w2[k];
#pragma unroll
  for (int k = 0; k < 16; ++k) part[kOffWr1 + ri * kHid + jb1 + k] = a_wr1[k];
  if (tid < kHid) {
#pragma unroll
    for (int c = 0; c < 3; ++c) part[kOffWr3 + tid * 3 + c] = a_wr3[c];
  }
}

// Sums the blocks' partial weight gradients in block order.
__global__ void field_tail_bwd_reduce(const float* __restrict__ partial,
                                      int n_blocks, float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= kGrads) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += partial[(size_t)b * kGrads + o];
  out[o] = acc;
}

}  // namespace

// h1 (n, 64), sh (n, 16), g_sigma (n,), g_rgb (n, 3), w2 (64, 16),
// wr1 (32, 64), wr2 (64, 64), wr3 (64, 3), all f32 and contiguous ->
// dh1 (n, 64) f32 and the weight gradients, concatenated flat into
// wgrad (7360,) f32 as [dW2 | dWr1 | dWr2 | dWr3].  partial is scratch of
// n_blocks * 7360 f32; n_blocks blocks walk the tiles of 128 samples.
// Returns cudaGetLastError().
extern "C" int field_tail_bwd(const void* h1, const void* sh,
                              const void* g_sigma, const void* g_rgb,
                              const void* w2, const void* wr1, const void* wr2,
                              const void* wr3, void* dh1, void* wgrad,
                              void* partial, int n, int n_blocks,
                              void* stream) {
  if (n < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      field_tail_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  field_tail_bwd_kernel<<<n_blocks, kBlock, kSmem, st>>>(
      (const float*)h1, (const float*)sh, (const float*)g_sigma,
      (const float*)g_rgb, (const float*)w2, (const float*)wr1,
      (const float*)wr2, (const float*)wr3, (float*)dh1, (float*)partial, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  field_tail_bwd_reduce<<<(kGrads + 255) / 256, 256, 0, st>>>(
      (const float*)partial, n_blocks, (float*)wgrad);
  return (int)cudaGetLastError();
}
