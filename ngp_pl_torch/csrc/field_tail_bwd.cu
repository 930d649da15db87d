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
// (field_tail_mma.cuh): x = relu(h1), h = x W2, z1 = [sh | h] Wr1,
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
// two gradients in, dh1 out) and do ~45k FLOP per sample, 76 FLOP per byte:
// at the bf16 tensor-core rate that is bytes.  The design:
// - every product runs on the tensor cores (mma.sync.m16n8k16, bf16 in,
//   f32 sums).  Each warp takes 16 samples through the shared forward
//   (field_tail_mma.cuh, 60 mma) and back through the four transposed
//   layers (56 mma) in registers; the relu masks are bits taken from the
//   accumulator fragments, and d_r2, d_r1 come out in the same C layout, so
//   each lane masks its own elements.
// - the weight gradients are contractions over the samples, dW = A^T dZ:
//   each tile of 128 samples (8 warps x 16) leaves its bf16 operands in
//   shared memory (row strides padded against bank conflicts), and
//   ldmatrix.trans feeds them to mma with the sample index as the K
//   dimension.  Each warp holds 7-8 of the 60 16x8 output tiles in its
//   accumulators over all its tiles; h1 and sh are read from device memory
//   once.  Each block writes its partial and a second kernel sums them in
//   block order, so the weight gradients are deterministic.
// - a persistent grid of one block of 8 warps per SM (226 KB of shared
//   memory: 29 KB of packed weights, a two-stage cp.async ring of 42 KB
//   tiles of inputs, 108 KB of staged operands) loads the next tile while
//   it computes the current one.
// - dh1 leaves as 16-byte stores (lane pairs swap halves of their
//   fragments), each 32-byte sector written whole.
// On an H100 it runs at 46-48% of its bytes bound (PERF.md): the
// shared memory and 202 registers allow one block, 8 warps, per SM, and a
// tile's two phases (per sample, then the contraction) run one after the
// other, with 2 warps per scheduler to hide their latency.
#include "field_tail_mma.cuh"

namespace {

using namespace ft;

constexpr int kTile = 128;                  // samples per block step
// weight-gradient layout of the partials and of the output
constexpr int kOffW2 = 0;
constexpr int kOffWr1 = kOffW2 + kHid * kGeo;            // 1024
constexpr int kOffWr2 = kOffWr1 + (kSh + kGeo) * kHid;   // 3072
constexpr int kOffWr3 = kOffWr2 + kHid * kHid;           // 7168
constexpr int kGrads = kOffWr3 + kHid * 3;               // 7360

// bf16 row strides of the staged operands: 16-byte rows, and 8 rows at
// stride ld land in 8 distinct 16-byte bank groups
constexpr int kLd64 = 72;
constexpr int kLd32 = 40;
constexpr int kLd16 = 24;
constexpr int kLd8 = 8;

struct Stage {                               // one tile of inputs, f32
  float h1[kTile * kHid];                    // swizzled (field_tail_mma.cuh)
  float sh[kTile * kSh];
  float gs[kTile];
  float gr[kTile * 3];
};

struct Tiles {                               // bf16 operands of one tile
  __nv_bfloat16 x[kTile * kLd64];            // bf16(relu(h1))
  __nv_bfloat16 shh[kTile * kLd32];          // [bf16(sh) | bf16(h)]
  __nv_bfloat16 r1[kTile * kLd64];
  __nv_bfloat16 r2[kTile * kLd64];
  __nv_bfloat16 dz1[kTile * kLd64];
  __nv_bfloat16 dz2[kTile * kLd64];
  __nv_bfloat16 dz3[kTile * kLd8];           // columns 3-7 zero
  __nv_bfloat16 dh[kTile * kLd16];
};

constexpr size_t kSmem =
    kFragsAll * kFragBytes + 2 * sizeof(Stage) + sizeof(Tiles);
static_assert(kSmem <= 232448, "more shared memory than a block may use");

__device__ __forceinline__ void load_stage_async(
    Stage& s, const float* __restrict__ h1, const float* __restrict__ sh,
    const float* __restrict__ g_sigma, const float* __restrict__ g_rgb,
    int row0, int n) {
  const int tid = threadIdx.x;
  load_rows_async(s.h1, s.sh, h1, sh, row0, kTile, n, tid, kThreads);
  if (tid < kTile / 4) {
    const int bytes = min(max((n - row0 - 4 * tid) * 4, 0), 16);
    cp_async16(s.gs + 4 * tid, bytes ? g_sigma + row0 + 4 * tid : g_sigma,
               bytes);
  } else if (tid < kTile / 4 + kTile * 3 / 4) {
    const int q = tid - kTile / 4;
    const long long off = 3LL * row0 + 4 * q;
    const int bytes = (int)min(max((3LL * n - off) * 4, 0LL), 16LL);
    cp_async16(s.gr + 4 * q, bytes ? g_rgb + off : g_rgb, bytes);
  }
}

// Stores A fragments (rows r0 + g, r0 + g + 8 of the tile) as bf16 at
// column col0 of a staged operand with row stride ld.
template <int KC>
__device__ __forceinline__ void store_a(__nv_bfloat16* tile, int ld, int r0,
                                        int col0, const uint32_t (&a)[KC][4],
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + g + 8 * (q & 1);
      const int col = col0 + 16 * kc + 8 * (q >> 1) + 2 * t;
      *reinterpret_cast<uint32_t*>(tile + row * ld + col) = a[kc][q];
    }
  }
}

// A fragment of (tile^T)[16 mt.., 16 kc..]: rows of the tile are samples (K).
__device__ __forceinline__ void ldsm_a_t(uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int ld,
                                         int mt, int kc, int lane) {
  const int j = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p =
      tile + (kc * 16 + (j >> 1) * 8 + r) * ld + mt * 16 + (j & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
      : "memory");
}

// B fragments of tile[16 kc.., 8 nt..] and tile[16 kc.., 8 (nt + 1)..].
__device__ __forceinline__ void ldsm_b2_t(uint32_t (&b)[2][2],
                                          const __nv_bfloat16* tile, int ld,
                                          int nt, int kc, int lane) {
  const int j = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p =
      tile + (kc * 16 + (j & 1) * 8 + r) * ld + (nt + (j >> 1)) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(smem_u32(p))
      : "memory");
}

// B fragment of tile[16 kc.., 8 nt..].
__device__ __forceinline__ void ldsm_b_t(uint32_t (&b)[2],
                                         const __nv_bfloat16* tile, int ld,
                                         int nt, int kc, int lane) {
  const int j = (lane >> 3) & 1, r = lane & 7;
  const __nv_bfloat16* p = tile + (kc * 16 + j * 8 + r) * ld + nt * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_u32(p))
      : "memory");
}

// Zeroes the elements of c (C layout) whose bit in mask is clear.
template <int NT>
__device__ __forceinline__ void apply_mask(float (&c)[NT][4], uint32_t mask) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!((mask >> (4 * nt + e)) & 1u)) c[nt][e] = 0.f;
}

// Forward and backward of one warp's 16 samples (rows r0.. of the tile):
// stages its bf16 operands in `t` and stores dh1 for the rows below n.
__device__ __forceinline__ void warp_bwd(const Stage& s, Tiles& t,
                                         const uint2* wf, int r0, int row0,
                                         int n, float* __restrict__ dh1,
                                         int lane) {
  const int g = lane >> 2, tq = lane & 3;
  TailFwd f;
  tail_forward(s.h1, s.sh, r0, wf, lane, f);
  store_a<4>(t.x, kLd64, r0, 0, f.xa, lane);
  {
    const uint32_t sha[1][4] = {{f.sha[0], f.sha[1], f.sha[2], f.sha[3]}};
    const uint32_t ha[1][4] = {{f.ha[0], f.ha[1], f.ha[2], f.ha[3]}};
    store_a<1>(t.shh, kLd32, r0, 0, sha, lane);
    store_a<1>(t.shh, kLd32, r0, kSh, ha, lane);
  }
  store_a<4>(t.r1, kLd64, r0, 0, f.r1a, lane);
  store_a<4>(t.r2, kLd64, r0, 0, f.r2a, lane);

  // sigmoid backward: this lane's columns 2tq, 2tq + 1 of rows g, g + 8
  float dz3[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r0 + g + 8 * (e >> 1), col = 2 * tq + (e & 1);
    dz3[e] = 0.f;
    if (col < 3) {
      const float rgb = sigmoid(f.z3[e]);
      dz3[e] = bf16_round(__fmul_rn(__fmul_rn(s.gr[row * 3 + col], rgb),
                                    __fsub_rn(1.f, rgb)));
    }
  }
  const uint32_t dz3a[1][4] = {
      {pack_bf16(dz3[0], dz3[1]), pack_bf16(dz3[2], dz3[3]), 0u, 0u}};
  *reinterpret_cast<uint32_t*>(t.dz3 + (r0 + g) * kLd8 + 2 * tq) = dz3a[0][0];
  *reinterpret_cast<uint32_t*>(t.dz3 + (r0 + g + 8) * kLd8 + 2 * tq) =
      dz3a[0][1];

  // d_z2 = [z2 > 0] (d_z3 Wr3^T)
  float d[8][4];
  uint32_t da[4][4];
  mma_layer<1, 8>(dz3a, wf + kFragWr3T * 32, lane, d);
  apply_mask<8>(d, f.m2);
  c_to_a<8, false>(d, da);
  store_a<4>(t.dz2, kLd64, r0, 0, da, lane);
  // d_z1 = [z1 > 0] (d_z2 Wr2^T)
  mma_layer<4, 8>(da, wf + kFragWr2T * 32, lane, d);
  apply_mask<8>(d, f.m1);
  c_to_a<8, false>(d, da);
  store_a<4>(t.dz1, kLd64, r0, 0, da, lane);
  // d_h = d_z1 Wr1[16:]^T + the TruncExp term on column 0
  float dh[2][4];
  mma_layer<4, 2>(da, wf + kFragWr1hT * 32, lane, dh);
  if (tq == 0) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float ex = expf(fminf(fmaxf(f.h[0][e], -15.f), 15.f));
      dh[0][e] = __fadd_rn(dh[0][e], __fmul_rn(s.gs[r0 + g + 4 * e], ex));
    }
  }
  uint32_t dha[1][4];
  c_to_a<2, false>(dh, dha);
  store_a<1>(t.dh, kLd16, r0, 0, dha, lane);
  // dh1 = [h1 > 0] (d_h W2^T); lane pairs swap halves so that each lane
  // stores 4 neighbouring columns of one row
  mma_layer<1, 8>(dha, wf + kFragW2T * 32, lane, d);
  apply_mask<8>(d, f.m0);
  const bool odd = tq & 1;
  const int row = row0 + r0 + g + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float s0 = odd ? d[j][0] : d[j][2];
    const float s1 = odd ? d[j][1] : d[j][3];
    const float q0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float q1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const float4 v = odd ? make_float4(q0, q1, d[j][2], d[j][3])
                         : make_float4(d[j][0], d[j][1], q0, q1);
    if (row < n) {
      const int col = 8 * j + 2 * (tq & 2);
      *reinterpret_cast<float4*>(dh1 + (size_t)row * kHid + col) = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
field_tail_bwd_mma(const float* __restrict__ h1, const float* __restrict__ sh,
                   const float* __restrict__ g_sigma,
                   const float* __restrict__ g_rgb,
                   const uint4* __restrict__ wpack, float* __restrict__ dh1,
                   float* __restrict__ partial, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint2* wf = reinterpret_cast<const uint2*>(smem);
  Stage* stages = reinterpret_cast<Stage*>(smem + kFragsAll * kFragBytes);
  Tiles& t = *reinterpret_cast<Tiles*>(stages + 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  const int n_tiles = (n + kTile - 1) / kTile;
  int tile = blockIdx.x;
  if (tile < n_tiles)
    load_stage_async(stages[0], h1, sh, g_sigma, g_rgb, tile * kTile, n);
  cp_async_commit();
  copy_frags(reinterpret_cast<uint4*>(smem), wpack,
             kFragsAll * kFragBytes / 16, threadIdx.x, kThreads);

  // this warp's output tiles (16 x 8) of the weight gradients
  const int mt2 = warp >> 1, nt2 = 4 * (warp & 1);    // dWr2: 4 tiles
  const int mt1 = warp >> 2, nt1 = 2 * (warp & 3);    // dWr1: 2 tiles
  const int mt0 = warp >> 1, nt0 = warp & 1;          // dW2: 1 tile
  const bool has3 = warp < 4;                         // dWr3: 1 tile, mt = warp
  float acc2[4][4] = {}, acc1[2][4] = {}, acc0[4] = {}, acc3[4] = {};

  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int nxt = tile + gridDim.x;
    if (nxt < n_tiles)
      load_stage_async(stages[(it + 1) & 1], h1, sh, g_sigma, g_rgb,
                       nxt * kTile, n);
    cp_async_commit();
    cp_async_wait<1>();
    // the stage has landed, and every warp is done with the last tile's
    // operands
    __syncthreads();
    warp_bwd(stages[it & 1], t, wf, warp * 16, tile * kTile, n, dh1, lane);
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t a[4], b[2][2], b1[2];
      ldsm_a_t(a, t.r1, kLd64, mt2, kc, lane);
      ldsm_b2_t(b, t.dz2, kLd64, nt2, kc, lane);
      mma_bf16(acc2[0], a, b[0][0], b[0][1]);
      mma_bf16(acc2[1], a, b[1][0], b[1][1]);
      ldsm_b2_t(b, t.dz2, kLd64, nt2 + 2, kc, lane);
      mma_bf16(acc2[2], a, b[0][0], b[0][1]);
      mma_bf16(acc2[3], a, b[1][0], b[1][1]);
      ldsm_a_t(a, t.shh, kLd32, mt1, kc, lane);
      ldsm_b2_t(b, t.dz1, kLd64, nt1, kc, lane);
      mma_bf16(acc1[0], a, b[0][0], b[0][1]);
      mma_bf16(acc1[1], a, b[1][0], b[1][1]);
      ldsm_a_t(a, t.x, kLd64, mt0, kc, lane);
      ldsm_b_t(b1, t.dh, kLd16, nt0, kc, lane);
      mma_bf16(acc0, a, b1[0], b1[1]);
      if (has3) {
        ldsm_a_t(a, t.r2, kLd64, warp, kc, lane);
        ldsm_b_t(b1, t.dz3, kLd8, 0, kc, lane);
        mma_bf16(acc3, a, b1[0], b1[1]);
      }
    }
  }
  cp_async_wait<0>();

  float* part = partial + (size_t)blockIdx.x * kGrads;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * tq + (e & 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part[kOffWr2 + (mt2 * 16 + r) * kHid + (nt2 + i) * 8 + c] = acc2[i][e];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      part[kOffWr1 + (mt1 * 16 + r) * kHid + (nt1 + i) * 8 + c] = acc1[i][e];
    part[kOffW2 + (mt0 * 16 + r) * kGeo + nt0 * 8 + c] = acc0[e];
    if (has3 && c < 3) part[kOffWr3 + (warp * 16 + r) * 3 + c] = acc3[e];
  }
}

// Sums the blocks' partial weight gradients in block order.
__global__ void field_tail_bwd_reduce(const float* __restrict__ partial,
                                      int n_blocks, float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= kGrads) return;
  float acc = 0.f;
#pragma unroll 8
  for (int b = 0; b < n_blocks; ++b) acc += partial[(size_t)b * kGrads + o];
  out[o] = acc;
}

}  // namespace

// h1 (n, 64), sh (n, 16), g_sigma (n,), g_rgb (n, 3) f32, contiguous and
// 16-byte aligned; wpack the 116 bf16 B fragments of `pack_weights` ->
// dh1 (n, 64) f32 (16-byte aligned) and the weight gradients, concatenated
// flat into wgrad (7360,) f32 as [dW2 | dWr1 | dWr2 | dWr3].  partial is
// scratch of n_blocks * 7360 f32; n_blocks blocks of 256 threads walk the
// tiles of 128 samples.  Returns cudaGetLastError().
extern "C" int field_tail_bwd(const void* h1, const void* sh,
                              const void* g_sigma, const void* g_rgb,
                              const void* wpack, void* dh1, void* wgrad,
                              void* partial, int n, int n_blocks,
                              void* stream) {
  if (n < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      field_tail_bwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  field_tail_bwd_mma<<<n_blocks, kThreads, kSmem, st>>>(
      (const float*)h1, (const float*)sh, (const float*)g_sigma,
      (const float*)g_rgb, (const uint4*)wpack, (float*)dh1, (float*)partial,
      n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  field_tail_bwd_reduce<<<(kGrads + 255) / 256, 256, 0, st>>>(
      (const float*)partial, n_blocks, (float*)wgrad);
  return (int)cudaGetLastError();
}
