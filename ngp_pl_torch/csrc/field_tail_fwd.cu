// K7: fused field tail, forward only.
//
// Replaces the TPU kernel ngp_pl_tpu/ops/field_pallas.py `_fwd_kernel`
// (called by `field_tail` -> `_field_tail_impl`): everything between the
// fused hash encode's first-layer pre-activation h1 and the compositor.
//
// Semantics (held against the plain version `field_tail_plain` in
// ngp_pl_torch/ops/field_tail.py); every product has bf16-rounded operands
// and an f32 accumulator, as on the TPU:
//   h     = bf16(relu(h1)) @ W2                            (64 -> 16)
//   sigma = exp(clip(h[0], -30, 30))                       (TruncExp forward)
//   z1    = bf16(sh) @ Wr1[:16] + bf16(h) @ Wr1[16:]       (32 -> 64)
//   z2    = bf16(relu(z1)) @ Wr2                           (64 -> 64)
//   rgb   = sigmoid(bf16(relu(z2)) @ Wr3)                  (64 -> 3)
// Layouts are sample-major: h1 (P, 64), sh (P, 16), sigma (P,), rgb (P, 3).
// The TPU's transposed (16, P) / (8, P) layouts only avoided lane padding.
//
// What bounds it on an H100: it must move 336 B per sample (h1 256, sh 64,
// outputs 16) and do 15,360 FLOP per sample, so at bf16 tensor-core rates it
// is bound by bytes.  This simple design is bound by operations instead: one
// thread per sample runs the 7,680 multiply-adds on the f32 pipes, with the
// weights (bf16-rounded, kept as f32 so a float4 shared-memory broadcast
// feeds four FMAs) in 29 KB of shared memory.  Wr2 is stored transposed so
// the 64 -> 64 layer also reads float4s.  Moving the three hidden layers to
// mma/wgmma over tiles of samples is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHid = 64;
constexpr int kGeo = 16;
constexpr int kSh = 16;
constexpr int kBlock = 128;

struct Weights {
  float w2[kHid * kGeo];              // (64, 16)
  float wr1[(kSh + kGeo) * kHid];     // (32, 64)
  float wr2t[kHid * kHid];            // Wr2 transposed: wr2t[j][i] = Wr2[i][j]
  float wr3[kHid * 3];                // (64, 3)
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kBlock)
field_tail_fwd_kernel(const float* __restrict__ h1, const float* __restrict__ sh,
                      const float* __restrict__ w2, const float* __restrict__ wr1,
                      const float* __restrict__ wr2, const float* __restrict__ wr3,
                      float* __restrict__ sigma, float* __restrict__ rgb, int n) {
  __shared__ __align__(16) Weights s;
  for (int k = threadIdx.x; k < kHid * kGeo; k += blockDim.x)
    s.w2[k] = bf16_round(w2[k]);
  for (int k = threadIdx.x; k < (kSh + kGeo) * kHid; k += blockDim.x)
    s.wr1[k] = bf16_round(wr1[k]);
  for (int k = threadIdx.x; k < kHid * kHid; k += blockDim.x)
    s.wr2t[(k % kHid) * kHid + k / kHid] = bf16_round(wr2[k]);
  for (int k = threadIdx.x; k < kHid * 3; k += blockDim.x)
    s.wr3[k] = bf16_round(wr3[k]);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // sigma layer 2: h = bf16(relu(h1)) @ W2
  float h[kGeo];
#pragma unroll
  for (int k = 0; k < kGeo; ++k) h[k] = 0.f;
  const float4* h1v = reinterpret_cast<const float4*>(h1 + (size_t)i * kHid);
#pragma unroll 4
  for (int q = 0; q < kHid / 4; ++q) {
    const float4 v = h1v[q];
    const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
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
  sigma[i] = expf(fminf(fmaxf(h[0], -30.f), 30.f));

  // rgb layer 1: z1 = bf16(sh) @ Wr1[:16] + bf16(h) @ Wr1[16:]
  float r1[kHid];
#pragma unroll
  for (int j = 0; j < kHid; ++j) r1[j] = 0.f;
  const float4* shv = reinterpret_cast<const float4*>(sh + (size_t)i * kSh);
#pragma unroll
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
#pragma unroll
  for (int j = 0; j < kHid; ++j) r1[j] = bf16_round(fmaxf(r1[j], 0.f));

  // rgb layers 2 and 3, one hidden unit at a time: z3 += bf16(relu(z2_j)) Wr3[j]
  float z3[3] = {0.f, 0.f, 0.f};
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
    const float r2 = bf16_round(fmaxf(z, 0.f));
    z3[0] = fmaf(r2, s.wr3[j * 3], z3[0]);
    z3[1] = fmaf(r2, s.wr3[j * 3 + 1], z3[1]);
    z3[2] = fmaf(r2, s.wr3[j * 3 + 2], z3[2]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rgb[(size_t)i * 3 + c] = 1.f / (1.f + expf(-z3[c]));
  }
}

}  // namespace

// h1 (n, 64), sh (n, 16), w2 (64, 16), wr1 (32, 64), wr2 (64, 64), wr3 (64, 3),
// all f32 and contiguous -> sigma (n,), rgb (n, 3) f32.
// Returns cudaGetLastError().
extern "C" int field_tail_fwd(const void* h1, const void* sh, const void* w2,
                              const void* wr1, const void* wr2, const void* wr3,
                              void* sigma, void* rgb, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int grid = (n + kBlock - 1) / kBlock;
  field_tail_fwd_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)h1, (const float*)sh, (const float*)w2, (const float*)wr1,
      (const float*)wr2, (const float*)wr3, (float*)sigma, (float*)rgb, n);
  return (int)cudaGetLastError();
}
