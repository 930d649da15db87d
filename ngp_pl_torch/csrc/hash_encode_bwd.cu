// Table gradient of the fused hash encode + first dense layer, one kernel
// template with two instances:
//   K2 fused with K5, F=4: replaces `_bwd_kernel_w27` (the unpaired branch
//     of `encode_mlp_bwd_pallas`, ngp_pl_tpu/ops/hash_encoding_pallas.py)
//     and the one-hot MXU kernel `scatter_onehot`
//     (ngp_pl_tpu/ops/scatter_accum.py) that reduces its output on the dense
//     coarse levels;
//   K4, F=2: replaces `_bwd_kernel` (the paired branch, 64-wide rows, two
//     samples per 128-lane row with a block-diagonal w1: a TPU layout trick
//     that a thread per sample does not need).
// The TPU kernels write per-sample d_rows (L, N, W) in bf16, and
// ngp_pl_tpu/ops/hash_encoding.py `_encode_mlp_pl_bwd` reduces them per
// level into the f32 table gradient (one-hot MXU product on the dense levels
// when W == 128, XLA's scatter-add otherwise).  Both instances fuse that
// reduction: they add straight into the table gradient.
//
// Semantics (held against the plain version `hash_encode_bwd_plain` in
// ngp_pl_torch/ops/hash_encoding.py): per sample and level, the cell, slot and
// p = local + frac exactly as K1 and K3 compute them (csrc/hash_encode_fwd.cu);
//   d_wr[f] = sum_h bf16(g[h]) * bf16(w1[l*F + f][h])      in f32
// (in the TPU's expanded w1 a lane's weight row depends only on its feature);
// for each of the 8 corners c with weight w = (hat_x * hat_y) * hat_z,
// rounded to bf16 for F=4 only (as the forward: `_bwd_kernel_w27` expands
// the weights with a bf16 dot, `_bwd_kernel` keeps them in f32):
//   d_table[slot][pt(c) * F + f] += bf16(d_wr[f] * w)        f32 atomics.
// Those are the TPU's rounding points; only the f32 summation order differs,
// and with atomics it changes from run to run.
//
// What bounds it on an H100: per sample it reads 12 B of x and 256 B of g;
// the f32 table gradient (52.6 MB at L=8, F=4; 56.5 MB at L=16, F=2, both
// T=2^19) is zeroed and written once.  The floor is those bytes.  The
// d_rows the TPU wrote (537 MB at 262,144 samples, either geometry) never
// exist here: one thread per sample computes its F feature gradients per
// level and adds its 8 x F corner values straight into the table with
// atomicAdd.  The atomics are what this simple design pays for: they
// contend on the dense coarse levels (512 and 2,744 rows at L=8, F=4; 512
// and 1,331 rows at L=16, F=2), and at L=16, F=2 the 56.5 MB gradient no
// longer fits the 50 MB L2, where the atomics are resolved.  A shared-memory
// pre-reduction, a sort by slot or float2 atomics are later work.
#include <cuda_bf16.h>
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

// F features per level, table gradient rows of 32 * F floats (27 corner
// points x F, padded), corner weights rounded to bf16 when kRoundW.
template <int F, bool kRoundW>
__global__ void __launch_bounds__(kBlock)
hash_encode_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ w1,
                       float* __restrict__ d_table, int n, Levels lv) {
  constexpr int kRowW = 32 * F;
  __shared__ __align__(16) float w1s[kMaxLevels * F * kH];
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

    float d_wr[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float* wrow = w1s + (l * F + f) * kH;
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
      float w = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
      if (kRoundW) w = bf16_round(w);
      if (w == 0.f) continue;   // adds exactly zero
      const int pt = ((loc[0] + dx) * 3 + (loc[1] + dy)) * 3 + (loc[2] + dz);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float v = bf16_round(__fmul_rn(d_wr[f], w));
        if (v != 0.f) atomicAdd(row + pt * F + f, v);
      }
    }
  }
}

template <int F, bool kRoundW>
int launch(const void* x, const void* g, const void* w1, void* d_table,
           int n, int n_levels, int log2_bricks, const int* res,
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
  hash_encode_bwd_kernel<F, kRoundW>
      <<<grid, kBlock, 0, (cudaStream_t)stream>>>(
          (const float*)x, (const float*)g, (const float*)w1,
          (float*)d_table, n, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// K2 fused with K5: x (n, 3) f32, g (n, 64) f32, w1 (n_levels*4, 64) f32;
// d_table (rows, 128) f32 must be zeroed by the caller and is accumulated
// into.  The level arrays are host pointers of n_levels ints each.  Returns
// cudaGetLastError().
extern "C" int hash_encode_bwd(const void* x, const void* g, const void* w1,
                               void* d_table, int n, int n_levels,
                               int log2_bricks, const int* res,
                               const int* bgrid, const int* offset,
                               const int* dense, void* stream) {
  return launch<4, true>(x, g, w1, d_table, n, n_levels, log2_bricks, res,
                         bgrid, offset, dense, stream);
}

// K4: as above with w1 (n_levels*2, 64) f32 and d_table (rows, 64) f32.
extern "C" int hash_encode_bwd_f2(const void* x, const void* g,
                                  const void* w1, void* d_table, int n,
                                  int n_levels, int log2_bricks,
                                  const int* res, const int* bgrid,
                                  const int* offset, const int* dense,
                                  void* stream) {
  return launch<2, false>(x, g, w1, d_table, n, n_levels, log2_bricks, res,
                          bgrid, offset, dense, stream);
}
