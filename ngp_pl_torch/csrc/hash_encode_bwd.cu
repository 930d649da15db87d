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
//   d_table[slot][pt(c) * F + f] += bf16(d_wr[f] * w)        in f32.
// Those are the TPU's rounding points; only the order of the f32 sums
// differs, and with reductions in device memory it changes from run to run.
//
// What bounds it on an H100.  Per sample it reads 12 B of x and 256 B of g;
// the f32 table gradient (52.6 MB at L=8, F=4; 56.5 MB at L=16, F=2, both
// T=2^19) is zeroed by the caller and written once.  Those bytes are the
// floor.  The d_rows the TPU wrote (537 MB at 262,144 samples) never exist
// here: one thread per sample computes its F feature gradients per level
// and its 8 corner values, which go into the table as reductions that L2
// resolves.  L2 takes them at a rate of requests, not of bytes: on an H100
// ~80G random reductions/s whether each carries 4, 8 or 16 bytes, and up
// to 2.5x that where the lanes of one instruction add into the same
// 128-byte line (benchmarking/table_grad_probe.py).  So the design issues
// few and dense ones:
//   - one vector reduction per corner point: a point's F features are
//     contiguous, 16-byte aligned at F=4 (atomicAdd(float4*), a
//     `red.global.add.v4.f32` on sm_90), 8-byte aligned at F=2, where the
//     z-pair of an even point is one aligned v4 and the other points a v2
//     each.  Per sample and level 8 reductions at F=4 and 6 at F=2, where
//     a scalar per feature took 32 and 16: 64 and 96 per sample in all;
//   - the lanes of a warp stage their corner values in shared memory and
//     issue them cell by cell, 8 lanes per cell, so that one instruction
//     adds the 8 corners of 4 cells, each cell's within 224 bytes of its
//     row (2-3 lines);
//   - on the coarse levels (at most kMergeMaxRes = 256 cells per axis),
//     the lanes of a warp in one cell merge first (a match on the cell,
//     the staged values summed per group): the train pool holds a ray's
//     ~34 samples in consecutive slots, dt = sqrt(3)/1024 apart, so a ray
//     crosses a cell of such a level in ~2.3 samples or more and a warp's
//     lanes fall in one or a few cells; on finer levels almost every lane
//     has a cell of its own, and the match would cost more than it saves.
// Per sample the d_wr contraction is 2,048 multiply-adds against w1 in
// shared memory (kept a sequential f32 chain, as the CPU sums it, so that
// the bf16 rounding of each product sees the same d_wr), and g is read
// coalesced through the staging buffer.  Zero-gradient rows (unused pool
// slots, samples past early termination) add nothing; a warp of them stops.
// What remains, as chip_smoke.py (and, without the reductions,
// benchmarking/table_grad_probe.py) measure it on an H100 80GB HBM3 at
// 700 W (device time of the kernel; the share of the bytes bound is of
// the call, the gradient's zero fill included): at 262,144 random points
// 0.262 ms at F=4 and 0.376 at F=2, 13% and 10% of the bound, held by the
// reductions at the L2's request rate (the kernel without them takes
// 0.109 and 0.173); on a train step's 393,216-slot pool 0.149 and 0.181
// ms, 29% and 25% of the bound, held by the per-sample arithmetic (0.122
// and 0.168 without reductions).  There, by the issue rule above, merging
// leaves ~23 and ~31 reductions per slot (the probe counts them from the
// inputs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kH = 64;       // first-layer width
constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
// the levels with at most this many cells per axis merge lanes by cell
constexpr int kMergeMaxRes = 256;

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

// Rounds a and b to bf16 and back with one packed conversion.
__device__ __forceinline__ void bf16_round2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

__device__ __forceinline__ float hat(int c, float p) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn((float)c, p))));
}

// Vector reductions into the table gradient (sm_90; the result is unused,
// so they compile to RED).
__device__ __forceinline__ void red4(float* p, float a, float b, float c,
                                     float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

__device__ __forceinline__ void red2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// The point of a brick row at local corner (x, y, z), given as 3 bits, x
// high: a cell's corner 0 from its local cell `loc`, and corner c's offset
// from corner 0 (dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1) from c.
__device__ __forceinline__ int point_of(int bits) {
  return ((bits >> 2) * 3 + ((bits >> 1) & 1)) * 3 + (bits & 1);
}

// The vector of F floats a thread holds for one corner.
template <int F> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T make(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void add(float* acc, T v) {
    acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
  }
  static __device__ __forceinline__ void load(float* acc, T v) {
    acc[0] = v.x; acc[1] = v.y; acc[2] = v.z; acc[3] = v.w;
  }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T make(const float* v) {
    return make_float2(v[0], v[1]);
  }
  static __device__ __forceinline__ void add(float* acc, T v) {
    acc[0] += v.x; acc[1] += v.y;
  }
  static __device__ __forceinline__ void load(float* acc, T v) {
    acc[0] = v.x; acc[1] = v.y;
  }
};

// Lane (w, c) of a group of 8 adds corner c of one cell, whose corner 0 is
// at index `base` of the table gradient.  F=4: one v4.  F=2: where the
// z-pair (c, c + 1) of an even c starts at an even point, 16-byte aligned,
// lane c adds both as one v4 with lane c + 1's values; the other corners
// go as one v2 each.  All 32 lanes must call it (the F=2 shuffle).
template <int F>
__device__ __forceinline__ void add_corner(float* d_table, int base, int c,
                                           const float (&acc)[F],
                                           bool issue = true) {
  float* dst = d_table + base + point_of(c) * F;
  if constexpr (F == 4) {
    if (issue) red4(dst, acc[0], acc[1], acc[2], acc[3]);
  } else {
    const float nb0 = __shfl_down_sync(kFull, acc[0], 1);
    const float nb1 = __shfl_down_sync(kFull, acc[1], 1);
    // the point's parity: corner 0's (base / 2, rows are 32 points) plus
    // the corner's offset
    const bool even = (((base >> 1) + point_of(c)) & 1) == 0;
    if (!issue) return;
    if ((c & 1) == 0 && even) {
      red4(dst, acc[0], acc[1], nb0, nb1);
    } else if ((c & 1) == 0 || even) {
      red2(dst, acc[0], acc[1]);
    }
  }
}

// F features per level, table gradient rows of 32 * F floats (27 corner
// points x F, padded), corner weights rounded to bf16 when kRoundW.  One
// thread per sample; a warp's lanes stay converged through the level loop
// (the merge needs all 32).
template <int F, bool kRoundW>
__global__ void __launch_bounds__(kBlock)
hash_encode_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ w1,
                       float* __restrict__ d_table, int n, Levels lv) {
  using V = Vec<F>;
  constexpr int kRowW = 32 * F;
  __shared__ __align__(16) float w1s[kMaxLevels * F * kH];
  // per warp, the corner values of its lanes: [corner][lane ^ corner], so
  // that both the stores (one corner, 32 lanes) and the reads (8 corners,
  // one lane) are free of bank conflicts; first it stages g
  __shared__ typename V::T stage[kWarps][8][32];
  // per warp, the leading lane of each of its cells on a merged level, and
  // its nonzero lanes
  __shared__ int cells[kWarps][32];
  __shared__ int actives[kWarps][32];
  const int lf = lv.n_levels * F;
  for (int k = threadIdx.x; k < lf * kH; k += blockDim.x) {
    w1s[k] = bf16_round(w1[k]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned lane_bit = 1u << lane;
  const int warp = threadIdx.x >> 5;
  typename V::T(*my_stage)[32] = stage[warp];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float xs[3] = {0.f, 0.f, 0.f};
  if (i < n) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xs[a] = fminf(fmaxf(x[3 * i + a], 0.f), 1.f);
    }
  }
  // The warp's 32 rows of g, read coalesced through the stage buffer, 16
  // floats of each row per pass (rows past n read as zero); each row's 4
  // float4 go to slots XOR-swizzled by bits 1-2 of the row, so that both
  // the stores and each lane's reads of its own row are conflict-free.
  float gb[kH];
  unsigned bits = 0;
  {
    float4* tile = reinterpret_cast<float4*>(&my_stage[0][0]);
    const int row0 = i - lane;
    const float4* gv = reinterpret_cast<const float4*>(g);
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j * 8 + (lane >> 2), part = lane & 3;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < n) v = gv[(size_t)(row0 + r) * 16 + pass * 4 + part];
        tile[r * 4 + (part ^ ((r >> 1) & 3))] = v;
      }
      __syncwarp();
#pragma unroll
      for (int part = 0; part < 4; ++part) {
        const float4 v = tile[lane * 4 + (part ^ ((lane >> 1) & 3))];
        float* d = gb + pass * 16 + part * 4;
        bits |= __float_as_uint(v.x) | __float_as_uint(v.y) |
                __float_as_uint(v.z) | __float_as_uint(v.w);
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
        bf16_round2(d[0], d[1]);
        bf16_round2(d[2], d[3]);
      }
      __syncwarp();
    }
  }
  const bool active = (bits & 0x7fffffffu) != 0;   // a nonzero element
  // Unused pool slots and samples past early termination have a zero
  // gradient row: adding it would change nothing (d_table starts at +0 and
  // adding +/-0 keeps it +0), and the unused slots all sit at the clamped
  // camera origin, where their reductions would contend on the same points.
  if (!__any_sync(kFull, active)) return;
  int* my_cells = cells[warp];
  int* my_active = actives[warp];
  // the nonzero lanes, in order: the cells of a level without merges
  const unsigned active_mask = __ballot_sync(kFull, active);
  const int n_active = __popc(active_mask);
  if (active) my_active[__popc(active_mask & (lane_bit - 1))] = lane;
  const int c = lane & 7;

  for (int l = 0; l < lv.n_levels; ++l) {
    int brick[3], loc = 0;
    float p[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = __fmul_rn(xs[a], lv.res_f[l]);
      const float cellf = floorf(pos);
      const float frac = __fsub_rn(pos, cellf);
      const int cell = min(max((int)cellf, 0), lv.res[l] - 1);
      brick[a] = cell >> 1;
      loc = (loc << 1) | (cell & 1);
      p[a] = __fadd_rn((float)(cell & 1), frac);
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
      wx[d] = hat(((loc >> 2) & 1) + d, p[0]);
      wy[d] = hat(((loc >> 1) & 1) + d, p[1]);
      wz[d] = hat((loc & 1) + d, p[2]);
    }
    float w[8], v[8][F];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      w[c] = __fmul_rn(__fmul_rn(wx[c >> 2], wy[(c >> 1) & 1]), wz[c & 1]);
    }
    if (kRoundW) {
#pragma unroll
      for (int c = 0; c < 8; c += 2) bf16_round2(w[c], w[c + 1]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int f = 0; f < F; f += 2) {
        v[c][f] = __fmul_rn(d_wr[f], w[c]);
        v[c][f + 1] = __fmul_rn(d_wr[f + 1], w[c]);
        bf16_round2(v[c][f], v[c][f + 1]);
      }
    }

    // Stage the corner values; index of corner 0 in the table gradient.
    if (active) {
#pragma unroll
      for (int c = 0; c < 8; ++c) my_stage[c][lane ^ c] = V::make(v[c]);
    }
    const int base =
        (lv.offset[l] + (int)slot) * kRowW + point_of(loc) * F;
    // The cells of this level: on a merged level the lanes in one cell
    // form a group under its lowest lane; elsewhere, and where no two
    // lanes share a cell, each nonzero lane is its own.
    unsigned peers = lane_bit;
    bool grouped = false;
    if (lv.res[l] <= kMergeMaxRes) {
      const unsigned key = active ? (slot << 3) | (unsigned)loc : kFull;
      peers = __match_any_sync(kFull, key);
      grouped = __any_sync(kFull, active && peers != lane_bit);
    }
    int n_cells = n_active;
    const int* list = my_active;
    if (grouped) {
      const bool leads = active && lane == __ffs(peers) - 1;
      const unsigned leaders = __ballot_sync(kFull, leads);
      if (leads) my_cells[__popc(leaders & (lane_bit - 1))] = lane;
      n_cells = __popc(leaders);
      list = my_cells;
    }
    __syncwarp();
    // Four cells at a time: lane (w, c) takes corner c of cell k + w (its
    // sum over the cell's lanes, where they merged) and issues it, so that
    // one instruction carries the 8 corners of each cell, which lie within
    // 224 bytes of one row.
    for (int k = 0; k < n_cells; k += 4) {
      const int idx = k + (lane >> 3);
      const int src = list[idx < n_cells ? idx : k];
      float acc[F];
      if (grouped) {
        const unsigned mask = __shfl_sync(kFull, peers, src);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = 0.f;
        for (unsigned m = mask; m; m &= m - 1) {
          V::add(acc, my_stage[c][(__ffs(m) - 1) ^ c]);
        }
      } else {
        V::load(acc, my_stage[c][src ^ c]);
      }
      add_corner<F>(d_table, __shfl_sync(kFull, base, src), c, acc,
                    idx < n_cells);
    }
    __syncwarp();
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
// d_table (rows, 128) f32, 16-byte aligned, must be zeroed by the caller
// and is accumulated into.  The level arrays are host pointers of n_levels
// ints each.  Returns cudaGetLastError().
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
