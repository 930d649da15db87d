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
// outputs 16) and do 15,360 FLOP per sample: 46 FLOP per byte, far below
// the ~295 at which the bf16 tensor cores would be the limit, so bytes
// bound it.  The design keeps the card's memory busy and the math off the
// f32 pipes:
// - the four layers run on the tensor cores (field_tail_mma.cuh: 60
//   mma.sync.m16n8k16 per 16 samples, activations in registers);
// - the weights are packed once per weight update into bf16 B fragments
//   (15 KB) by the wrapper and copied into shared memory once per block;
// - a persistent grid of two blocks of 8 warps per SM: each warp walks
//   groups of 16 samples with its own two-stage cp.async ring (5 KB a
//   stage), so the next group's 5 KB are in flight while it computes, about
//   80 KB per SM;
// - sigma and rgb go through 256 B of shared memory per warp and leave as
//   16-byte coalesced stores.
// On an H100 it runs at 84% of its bytes bound at 1,048,576 samples
// (PERF.md).
#include "field_tail_mma.cuh"

namespace {

using namespace ft;

constexpr int kStages = 2;
constexpr int kGroup = 16;                            // samples per warp step
constexpr int kStageFloats = kGroup * (kHid + kSh);   // 1,280 f32 = 5 KB
constexpr int kOutFloats = kGroup * 4;                // sigma 16, rgb 48
constexpr size_t kSmem =
    kFragsFwd * kFragBytes +
    (size_t)kWarps * (kStages * kStageFloats + kOutFloats) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
field_tail_fwd_mma(const float* __restrict__ h1, const float* __restrict__ sh,
                   const uint4* __restrict__ wpack, float* __restrict__ sigma,
                   float* __restrict__ rgb, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* wf = reinterpret_cast<uint2*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ring = reinterpret_cast<float*>(smem + kFragsFwd * kFragBytes) +
                warp * (kStages * kStageFloats + kOutFloats);
  float* out = ring + kStages * kStageFloats;

  const int n_groups = (n + kGroup - 1) / kGroup;
  const int stride = gridDim.x * kWarps;
  int grp = blockIdx.x * kWarps + warp;
  if (grp < n_groups) {
    load_rows_async(ring, ring + kGroup * kHid, h1, sh, grp * kGroup, kGroup,
                    n, lane, 32);
  }
  cp_async_commit();
  copy_frags(reinterpret_cast<uint4*>(smem), wpack,
             kFragsFwd * kFragBytes / 16, threadIdx.x, kThreads);
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  for (int it = 0; grp < n_groups; grp += stride, ++it) {
    const int nxt = grp + stride;
    if (nxt < n_groups) {
      float* s = ring + ((it + 1) % kStages) * kStageFloats;
      load_rows_async(s, s + kGroup * kHid, h1, sh, nxt * kGroup, kGroup, n,
                      lane, 32);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();

    const float* s = ring + (it % kStages) * kStageFloats;
    TailFwd f;
    tail_forward(s, s + kGroup * kHid, 0, wf, lane, f);
    if (t == 0) {
      out[g] = expf(fminf(fmaxf(f.h[0][0], -30.f), 30.f));
      out[g + 8] = expf(fminf(fmaxf(f.h[0][2], -30.f), 30.f));
    }
    if (t < 2) {
      // this lane's rgb columns: 2t, 2t + 1 (t = 1: column 2 only)
      float* o = out + kGroup;
      o[g * 3 + 2 * t] = sigmoid(f.z3[0]);
      o[(g + 8) * 3 + 2 * t] = sigmoid(f.z3[2]);
      if (t == 0) {
        o[g * 3 + 1] = sigmoid(f.z3[1]);
        o[(g + 8) * 3 + 1] = sigmoid(f.z3[3]);
      }
    }
    __syncwarp();
    const int s0 = grp * kGroup;
    if (s0 + kGroup <= n) {
      // lanes 0-3: 16 sigmas; lanes 4-15: 48 rgb floats, 16 bytes each
      if (lane < 4) {
        reinterpret_cast<float4*>(sigma + s0)[lane] =
            reinterpret_cast<const float4*>(out)[lane];
      } else if (lane < 16) {
        reinterpret_cast<float4*>(rgb + (size_t)s0 * 3)[lane - 4] =
            reinterpret_cast<const float4*>(out + kGroup)[lane - 4];
      }
    } else {
      const int valid = n - s0;
      if (lane < valid) sigma[s0 + lane] = out[lane];
      for (int q = lane; q < valid * 3; q += 32)
        rgb[(size_t)s0 * 3 + q] = out[kGroup + q];
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

}  // namespace

// h1 (n, 64), sh (n, 16) f32, contiguous and 16-byte aligned; wpack the
// bf16 B fragments of `pack_weights` (at least the 60 forward ones);
// -> sigma (n,), rgb (n, 3) f32, 16-byte aligned.  n_blocks blocks of 256
// threads walk the groups of 16 samples.  Returns cudaGetLastError().
extern "C" int field_tail_fwd(const void* h1, const void* sh,
                              const void* wpack, void* sigma, void* rgb,
                              int n, int n_blocks, void* stream) {
  if (n < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      field_tail_fwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  field_tail_fwd_mma<<<n_blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)h1, (const float*)sh, (const uint4*)wpack, (float*)sigma,
      (float*)rgb, n);
  return (int)cudaGetLastError();
}
