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
// interpolation and the 32 -> 64 contraction.  The TPU left the gather in
// XLA because it has no gather hardware; the encode ablation bench (K9)
// showed that streaming pre-gathered rows costs more here than gathering,
// so the gather stays fused.  K3's TPU kernel paired two samples per
// 128-lane row with a block-diagonal w1, a layout trick for its 128-lane
// tiles that this design does not need.
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
// The design.  One warp takes a tile of 16 samples through all levels, with
// the first layer on the tensor cores (mma.sync.m16n8k16, bf16 operands,
// f32 sums).  Per level the product is A (16 samples x 8F) times B (8F x
// 64): A's column k holds bf16(v * w) of one (corner, feature) and B's row
// k holds bf16(w1[l*F + feature]), repeated for every corner.  The sum over
// k is the sum over corners and features of exact products, which is
// sum_f feature * bf16(w1) up to the order of the f32 sums.  Fragment
// layout (g = lane / 4, t = lane % 4): lane (g, t) holds rows g and g + 8
// (two samples) and columns 2t, 2t+1, 2t+8, 2t+9 of each 16-wide k-chunk.
// Those columns are given to whole corners:
//   F=4: chunk kc = dx (two chunks per level), the four columns are the 4
//     features of corner (dx, dy, dz) = (kc, t >> 1, t & 1);
//   F=2: one chunk per level, columns 2t, 2t+1 are the 2 features of
//     corner (0, t >> 1, t & 1) and 2t+8, 2t+9 those of corner (1, ...).
// So lane (g, t) gathers, for samples g and g + 8, the points of its two
// corners (dx = 0, 1; dy, dz from t): four independent 8-byte loads per
// level, and B's fragment does not depend on t or on the corner (b0, b1 =
// w1 of features (0, 1), (2, 3) at F=4, (0, 1) twice at F=2, column n =
// 8 nt + g), read from a bf16 copy of w1 in shared memory, w1b[l][n][f].
// The feats output is one more product per chunk, against a 0/1 selector
// B (column f sums the columns of feature f): exact products, f32 sums.
// The warp stages its tile's feats in shared memory and writes them at the
// end of the tile as whole lines (the tile's 16 rows are contiguous); a
// kernel instance without feats (the render path) has none of that code.
// h1 leaves from the C fragments, each quad writing a whole 32-byte sector
// of a row; h1 and feats are stored with the streaming hint (evict first),
// as nothing reads them before the next kernel.
//
// What bounds it on an H100 (80GB HBM3, 700 W; device time, 262,144
// random points; benchmarking/encode_fwd_probe.py builds twins of this
// source with one part of the work taken out).  The bytes bound is the h1
// write, 256 B per sample: 0.027 ms for K1, 0.034 for K3.
//   - K1 takes 0.075 ms (36% of the bound) and 0.054 without its table
//     reads: the per-sample work (cell, slot and weights computed by each
//     lane of a quad for its two samples, the weighting, the products, the
//     stores) holds it more than the gather.  With each mma replaced by
//     four adds it takes 0.071: the contraction costs little.
//   - K3 takes 0.155 ms (22%), 0.089 without its table reads and 0.097
//     with the same points on a 14.5 MB table that the L2 holds: its
//     56.5 MB f32 table does not fit the L2, and the reads that miss cost
//     it ~0.06 ms.  The design leaves them: the table is the f32 parameter
//     the function is defined on, and a sample's 8 corners already come
//     in the 4 sectors that hold them.
//   - The gather: a quad's four points of one instruction span 40 bytes
//     (base + {0, 1, 3, 4} + 9 dx), at most 2 sectors, so 4 sectors per
//     (sample, level), where the one-thread-per-sample design this
//     replaces made 8 single-point requests, one lane each, bound by their
//     latency: a level's loads waited on its own index math, levels ran
//     one after the other, and 64 accumulators sat in one thread (116
//     registers, 16 warps per SM).  Here level l + 1's loads
//     are issued before level l's products; 96 registers, 20 warps per SM.
//   - Fewer registers for more warps (`__launch_bounds__` asking for 6
//     blocks) was slower in the probe.
// The tensor cores sum exact products in another order than the plain
// version's f32 chain, so only the rounding of the f32 sums differs from
// it: K1_TOL of chip_smoke.py, 1e-5 of max; the card reads at most 6.5e-7
// of max on h1 and 1.5e-7 on feats.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kH = 64;       // first-layer width
constexpr int kNT = kH / 8;  // n-tiles of the product
constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;
constexpr int kTile = 16;    // samples per warp step

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float hat(int c, float p) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn((float)c, p))));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 8 bytes of one corner point: 4 halves at F=4, 2 floats at F=2.
__device__ __forceinline__ uint2 load_point(const __half* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ uint2 load_point(const float* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

// bf16(v * w) of a point's features, packed in pairs: F=4 gives features
// (0, 1) in lo and (2, 3) in hi, F=2 features (0, 1) in lo.
__device__ __forceinline__ uint2 weigh(uint2 raw, float w, __half) {
  const __half2 a = *reinterpret_cast<const __half2*>(&raw.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&raw.y);
  return make_uint2(pack_bf16(__fmul_rn(__low2float(a), w),
                              __fmul_rn(__high2float(a), w)),
                    pack_bf16(__fmul_rn(__low2float(b), w),
                              __fmul_rn(__high2float(b), w)));
}
__device__ __forceinline__ uint2 weigh(uint2 raw, float w, float) {
  return make_uint2(pack_bf16(__fmul_rn(__uint_as_float(raw.x), w),
                              __fmul_rn(__uint_as_float(raw.y), w)),
                    0u);
}

// What a lane holds of one level before its products: the raw points of
// its two corners (dx = 0, 1) for its two samples (s = 0: row g, 1: g + 8),
// and their weights.
struct Gathered {
  uint2 raw[2][2];   // [s][dx]
  float w[2][2];
};

// Level l's cell of one sample, its row and the point of corner (0, dy, dz)
// of the lane, and the lane's two weights (dx = 0, 1).
template <bool kRoundW>
__device__ __forceinline__ void corner_of(const float (&xs)[3], int l,
                                          const Levels& lv, int dy, int dz,
                                          int& row, int& pt0,
                                          float (&w)[2]) {
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
  row = lv.offset[l] + (int)slot;
  pt0 = (loc[0] * 3 + loc[1] + dy) * 3 + loc[2] + dz;
  const float wyz_y = hat(loc[1] + dy, p[1]);
  const float wyz_z = hat(loc[2] + dz, p[2]);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    float v = __fmul_rn(__fmul_rn(hat(loc[0] + dx, p[0]), wyz_y), wyz_z);
    w[dx] = kRoundW ? bf16_round(v) : v;
  }
}

template <int F, typename T, bool kRoundW>
__device__ __forceinline__ Gathered gather(const T* __restrict__ table,
                                           const float (&xs)[2][3], int l,
                                           const Levels& lv, int dy, int dz) {
  constexpr int kRowW = 32 * F;
  Gathered gth;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    int row, pt0;
    corner_of<kRoundW>(xs[s], l, lv, dy, dz, row, pt0, gth.w[s]);
    const T* base = table + (size_t)row * kRowW + pt0 * F;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      gth.raw[s][dx] = load_point(base + 9 * dx * F);
    }
  }
  return gth;
}

template <int F, typename T, bool kRoundW, bool kFeats>
__global__ void __launch_bounds__(kBlock)
hash_encode_fwd_kernel(const float* __restrict__ x,
                       const T* __restrict__ table,
                       const float* __restrict__ w1,
                       float* __restrict__ h1,
                       float* __restrict__ feats,
                       int n, Levels lv) {
  // Dynamic shared memory (`smem_bytes`): w1 in bf16, w1b[(l * 64 + n) * F
  // + f], so that lane g reads its b0, b1 (all F features of column n) as
  // one 8-byte (F=4) or 4-byte (F=2) word; then, when feats are written,
  // each warp's tile of feats, rows of L F floats padded by 4 so that the 8
  // rows one store instruction writes fall in distinct banks.
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = lv.n_levels;
  __nv_bfloat16* w1b = reinterpret_cast<__nv_bfloat16*>(smem);
  for (int k = threadIdx.x; k < L * F * kH; k += blockDim.x) {
    const int l = k / (F * kH), f = (k / kH) % F, col = k % kH;
    w1b[(l * kH + col) * F + f] = __float2bfloat16_rn(w1[k]);
  }
  const int fstride = L * F + 4;
  float* fs = reinterpret_cast<float*>(smem + L * F * kH * 2) +
              (threadIdx.x >> 5) * kTile * fstride;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dy = t >> 1, dz = t & 1;
  const int lf = L * F;
  // the feature selector: column f of B sums the A columns of feature f
  const float one = 1.f;
  const uint32_t sel0 = pack_bf16(g == 0 ? one : 0.f, g == 1 ? one : 0.f);
  const uint32_t sel1 = F == 4 ? pack_bf16(g == 2 ? one : 0.f,
                                           g == 3 ? one : 0.f)
                               : sel0;
  const int tiles = (n + kTile - 1) / kTile;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);

  for (int tile = warp; tile < tiles; tile += gridDim.x * kWarps) {
    int rows[2];
    float xs[2][3];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      rows[s] = tile * kTile + g + 8 * s;
      const int i = min(rows[s], n - 1);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        xs[s][a] = fminf(fmaxf(__ldg(x + 3 * i + a), 0.f), 1.f);
      }
    }
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }

    Gathered cur = gather<F, T, kRoundW>(table, xs, 0, lv, dy, dz);
    for (int l = 0; l < L; ++l) {
      // level l + 1's loads go out before level l's products
      Gathered nxt;
      if (l + 1 < L) nxt = gather<F, T, kRoundW>(table, xs, l + 1, lv, dy, dz);

      uint2 vw[2][2];  // [s][dx]: bf16(v * w) in feature pairs
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          vw[s][dx] = weigh(cur.raw[s][dx], cur.w[s][dx], T());
        }
      }
      constexpr int KC = F == 4 ? 2 : 1;
      uint32_t a[KC][4];
      if constexpr (F == 4) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          a[kc][0] = vw[0][kc].x;
          a[kc][1] = vw[1][kc].x;
          a[kc][2] = vw[0][kc].y;
          a[kc][3] = vw[1][kc].y;
        }
      } else {
        a[0][0] = vw[0][0].x;
        a[0][1] = vw[1][0].x;
        a[0][2] = vw[0][1].x;
        a[0][3] = vw[1][1].x;
      }

      const __nv_bfloat16* wl = w1b + (l * kH + g) * F;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t b0, b1;
        if constexpr (F == 4) {
          const uint2 b = *reinterpret_cast<const uint2*>(wl + nt * 8 * F);
          b0 = b.x;
          b1 = b.y;
        } else {
          b0 = b1 = *reinterpret_cast<const uint32_t*>(wl + nt * 8 * F);
        }
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) mma_bf16(acc[nt], a[kc], b0, b1);
      }

      if constexpr (kFeats) {
        float fc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) mma_bf16(fc, a[kc], sel0, sel1);
        // lane (g, t < F / 2) holds features 2t, 2t + 1 of rows g, g + 8
        if (2 * t < F) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            *reinterpret_cast<float2*>(fs + (g + 8 * s) * fstride + l * F +
                                       2 * t) =
                make_float2(fc[2 * s], fc[2 * s + 1]);
          }
        }
      }
      if (l + 1 < L) cur = nxt;
    }

#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (rows[s] >= n) continue;
      float* out = h1 + (size_t)rows[s] * kH + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        __stcs(reinterpret_cast<float2*>(out + nt * 8),
               make_float2(acc[nt][2 * s], acc[nt][2 * s + 1]));
      }
    }
    if constexpr (kFeats) {
      // the tile's rows of feats are contiguous: the warp's 8-byte stores
      // fill whole lines
      __syncwarp();
      const int row0 = tile * kTile, q2 = lf / 2;
      const int valid = min(kTile, n - row0) * q2;
      float2* dst = reinterpret_cast<float2*>(feats + (size_t)row0 * lf);
      for (int q = lane; q < valid; q += 32) {
        const int r = q / q2, c = q % q2;
        __stcs(dst + q,
               *reinterpret_cast<const float2*>(fs + r * fstride + 2 * c));
      }
      __syncwarp();
    }
  }
}

// The kernel's dynamic shared memory for L levels, with or without the
// feats staging.
template <int F>
size_t smem_bytes(int L, bool feats) {
  return (size_t)L * F * kH * 2 +
         (feats ? (size_t)kWarps * kTile * (L * F + 4) * sizeof(float) : 0);
}

// Launches the kernel on a grid of the blocks that fit the card at once
// with its shared memory, no more than the tiles need; each warp walks the
// tiles with the grid's stride.
template <int F, typename T, bool kRoundW, bool kFeats>
void run(const void* x, const void* table, const void* w1, void* h1,
         void* feats, int n, const Levels& lv, void* stream) {
  auto kernel = hash_encode_fwd_kernel<F, T, kRoundW, kFeats>;
  const size_t smem = smem_bytes<F>(lv.n_levels, kFeats);
  static int resident[kMaxLevels + 1] = {};
  int& blocks = resident[lv.n_levels];
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                  smem);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = (n + kTile - 1) / kTile;
  const int grid = min(blocks, (tiles + kWarps - 1) / kWarps);
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const T*)table, (const float*)w1, (float*)h1,
      (float*)feats, n, lv);
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
  if (feats != nullptr) {
    run<F, T, kRoundW, true>(x, table, w1, h1, feats, n, lv, stream);
  } else {
    run<F, T, kRoundW, false>(x, table, w1, h1, feats, n, lv, stream);
  }
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