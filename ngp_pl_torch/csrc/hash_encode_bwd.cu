// Table gradient of the fused hash encode + first dense layer: K2 fused with
// the K5 scatter and the hashed levels' scatter-add.
//
// Replaces the TPU kernel ngp_pl_tpu/ops/hash_encoding_pallas.py
// `_bwd_kernel_w27` (called by `encode_mlp_bwd_pallas`, unpaired branch),
// which writes per-sample d_rows (L, N, 128) in bf16, together with what
// ngp_pl_tpu/ops/hash_encoding.py `_encode_mlp_pl_bwd` does with them: the
// per-level reduction into the f32 table gradient, by the one-hot MXU kernel
// `scatter_onehot` (ngp_pl_tpu/ops/scatter_accum.py) for the dense coarse
// levels and by XLA's scatter-add for the others.
//
// Semantics (held against the plain version `hash_encode_bwd_plain` in
// ngp_pl_torch/ops/hash_encoding.py): per sample and level, the cell, slot and
// p = local + frac exactly as K1 computes them (csrc/hash_encode_fwd.cu);
//   d_wr[f] = sum_h bf16(g[h]) * bf16(w1[l*4 + f][h])      in f32
// (in the TPU's expanded w1 a lane's weight row depends only on its feature);
// for each of the 8 corners c with weight w = bf16((hat_x * hat_y) * hat_z):
//   d_table[slot][pt(c) * 4 + f] += bf16(d_wr[f] * w)        f32 atomics.
// Those are the TPU's rounding points; only the f32 summation order differs,
// and with atomics it changes from run to run.
//
// What bounds it on an H100: per sample it reads 12 B of x and 256 B of g;
// the 52.6 MB f32 table gradient is zeroed and written once.  The floor is
// those bytes.  The (L, N, 128) d_rows the TPU wrote (537 MB at 262,144
// samples) never exist here: one thread per sample computes its 4 feature
// gradients per level and adds its 32 corner values straight into the table
// with atomicAdd.  The atomics are what this simple design pays for: the
// dense coarse levels (512 and 2,744 rows) take ~32 atomics per sample each
// on few addresses.  A shared-memory pre-reduction or a sort by slot is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kF = 4;        // features per level (brick rows of 27 x 4)
constexpr int kRowW = 128;   // floats per brick row (108 used)
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

__global__ void __launch_bounds__(kBlock)
hash_encode_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ w1,
                       float* __restrict__ d_table, int n, Levels lv) {
  __shared__ __align__(16) float w1s[kMaxLevels * kF * kH];
  const int lf = lv.n_levels * kF;
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
  float gb[kH];
  bool nonzero = false;
  const float4* gv = reinterpret_cast<const float4*>(g + (size_t)i * kH);
#pragma unroll
  for (int q = 0; q < kH / 4; ++q) {
    const float4 v = gv[q];
    gb[4 * q] = bf16_round(v.x);
    gb[4 * q + 1] = bf16_round(v.y);
    gb[4 * q + 2] = bf16_round(v.z);
    gb[4 * q + 3] = bf16_round(v.w);
    nonzero |= (v.x != 0.f) | (v.y != 0.f) | (v.z != 0.f) | (v.w != 0.f);
  }
  // Unused pool slots and samples past early termination have a zero
  // gradient row; their adds would change nothing (d_table starts at +0 and
  // adding +/-0 keeps it +0), and the unused slots all sit at the clamped
  // camera origin, where their atomics would contend on the same points.
  if (!nonzero) return;

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

    float d_wr[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const float* wrow = w1s + (l * kF + f) * kH;
      float acc = 0.f;
#pragma unroll
      for (int h = 0; h < kH; h += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + h);
        acc = fmaf(gb[h], w.x, acc);
        acc = fmaf(gb[h + 1], w.y, acc);
        acc = fmaf(gb[h + 2], w.z, acc);
        acc = fmaf(gb[h + 3], w.w, acc);
      }
      d_wr[f] = acc;
    }

    float wx[2], wy[2], wz[2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      wx[d] = hat(loc[0] + d, p[0]);
      wy[d] = hat(loc[1] + d, p[1]);
      wz[d] = hat(loc[2] + d, p[2]);
    }
    float* row = d_table + (size_t)(lv.offset[l] + (int)slot) * kRowW;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
      const float w = bf16_round(__fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]));
      if (w == 0.f) continue;   // adds exactly zero
      const int pt = ((loc[0] + dx) * 3 + (loc[1] + dy)) * 3 + (loc[2] + dz);
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const float v = bf16_round(__fmul_rn(d_wr[f], w));
        if (v != 0.f) atomicAdd(row + pt * kF + f, v);
      }
    }
  }
}

}  // namespace

// x (n, 3) f32, g (n, 64) f32, w1 (n_levels*4, 64) f32; d_table (rows, 128)
// f32 must be zeroed by the caller and is accumulated into.  The level arrays
// are host pointers of n_levels ints each.  Returns cudaGetLastError().
extern "C" int hash_encode_bwd(const void* x, const void* g, const void* w1,
                               void* d_table, int n, int n_levels,
                               int log2_bricks, const int* res,
                               const int* bgrid, const int* offset,
                               const int* dense, void* stream) {
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
  hash_encode_bwd_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)w1, (float*)d_table, n,
      lv);
  return (int)cudaGetLastError();
}
