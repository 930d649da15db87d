// K9: stripped variants of the packed-f16 encode forward, the encode-kernel
// ablation bench.  Replaces the Pallas kernels of
// benchmarking/micro_pallas_fwd.py: `make_variant` (pallas_call :56) and
// `make_variant_bn` (:231) with the bodies `full_kernel`, `no_decode_kernel`,
// `no_wrow_kernel`, `no_ft_kernel` and `stream_kernel`, and
// `make_variant_interleaved` (:267) with `full_kernel_il`.  `make_variant_bn`
// computes the same function as `make_variant` with another TPU block; here
// both are the same kernel, with its own chunk of 128 samples.
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
// What bounds it on an H100 (80GB HBM3, 700 W): bytes.  At the bench's
// N = 196,608 and L = 8 a contracting variant reads 402.7 MB of rows, 18.9
// MB of p-values (3 of meta_T's 4 rows) and w1, and writes 50.3 MB of h1
// and 25.2 MB of ft2: 0.148 ms at 3.35 TB/s, far past the 50 MB L2.  Its
// contraction, 2.58e10 flops, takes 0.026 ms on the tensor cores at their
// peak.  The first design (a block per 128 samples) took 0.38-0.45 ms of
// device time, 33-37% of that bound: each block staged the level's 32 KB of
// f32 w1 from the L2 into bf16 again (402.7 MB through the L2 per call, as
// much as the rows), each of a sample's 16 threads loaded its three
// p-values, the next level's rows went out only after the barrier and
// nothing was in flight during the decode, and every half went through an
// integer decoder with a branch.
//
// The design (0.171-0.178 ms, 83-87% of the bound; kernel_ab.py, PERF.md):
//   - The wrapper's call first packs w1 into bf16 `mma` B fragments, once
//     (`encode_ablation_pack_kernel`, 16 KB a level).
//   - A persistent grid, 2 blocks of 4 warps per SM, walks (tile of 128
//     samples, level) items.  Each item's rows (32 KB, contiguous in both
//     layouts), its p-values and the level's packed w1 go through a
//     two-stage cp.async ring, so the next item's 50 KB are in flight while
//     this one is decoded and multiplied.  Rows land with their 16-byte
//     units XOR-swizzled by the sample's parity, so the fragment loads
//     below hit 32 distinct banks.
//   - A warp takes 32 samples (two m16 tiles sharing each B fragment).  The
//     contraction order is permuted so that a lane's A fragments come from
//     whole 16-byte units of the rows: for k-chunk 2cp + h, lane (g, t)
//     reads unit 4cp + t of its samples g and g + 8, whose words 2h and
//     2h + 1 give the column pairs (t) and (t + 4), each pair a lane j and
//     j + 64 of one word.  All four words of a unit carry the same corner
//     point, c = 4cp + t (and 16 + c in the high halves), so a lane computes
//     two point weights per unit from the sample's p-values, loaded once
//     per sample into shared memory and read as broadcasts.  B is packed in
//     the same permuted order (`pack_w1_layout` spells it out).
//   - The decode is a bit move: a half's sign to bit 31 and its exponent
//     and mantissa to bits 13..27 give an f32 whose value is dec(h) *
//     2^-112 for every pattern (subnormals become f32 subnormals, exponent
//     31 a normal number), and multiplying it by w * 2^112 rounds the same
//     real, dec(h) * w, once: bit-equal to the TPU decoder's product for
//     all 65,536 patterns, with no branch
//     (tests/test_torch_encode_ablation_layout.py checks the identity, the
//     pack and the summation order).
//   - ft2 is one more `mma` per k-chunk against a 0/1 selector (column f
//     sums the valid lanes of feature f), written from the C fragments.
//   - K9-stream moves 478.2 MB (bound 0.143 ms).  It issues all (up to 8)
//     levels' 16-byte loads of a unit of h1 at once, through the read-only
//     cache, sums them in level order and writes ft2's zeros as 16-byte
//     stores, on a grid sized by the occupancy: 0.158 ms (90%, 3.03 TB/s),
//     against 0.161 for `sum(0)` and `torch.zeros` and 0.165 for the first
//     design.  benchmarking/encode_ablation_probe.py's twins (streaming
//     loads, write-back stores, 4 levels in flight) read the same or up to
//     3% slower: device memory is the limit.
// Products of two bf16 values are exact in f32, so every variant differs
// from its plain version only in the order of its f32 sums (K9_TOL of
// chip_smoke.py, 1e-5 of max); stream sums in the plain version's order.
// The variants are compile-time flags of one template, so each stripped
// instance really drops its work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWords = 64;    // u32 words per row: f16 lanes j and j + 64
constexpr int kLanes = 128;   // lanes per row
constexpr int kH = 64;        // h1 width
constexpr int kF = 4;         // features per level
constexpr int kTile = 128;    // samples per item
constexpr int kWarps = 4;     // a warp per 32 samples
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kUnitsPerRow = kWords / 4;                 // 16-byte units
constexpr int kRowUnits = kTile * kUnitsPerRow;          // 2,048: 32 KB
constexpr int kMetaUnits = 3 * kTile / 4;                // px, py, pz
constexpr int kW1Units = kLanes * kH * 2 / 16;           // 1,024: 16 KB
constexpr int kStageUnits = kRowUnits + kMetaUnits + kW1Units;
constexpr size_t kSmemBytes = (size_t)kStages * kStageUnits * 16;
constexpr int kValidPts = 11;  // high lanes 64 + 4c.. are corner lanes (< 108)
constexpr float kDecScale = 0x1p112f;
constexpr int kStreamLevels = 8;   // K9-stream: levels' loads in flight

static_assert(kTile == kWarps * 32, "a warp per 32 samples");
static_assert(kRowUnits % kThreads == 0 && kW1Units % kThreads == 0 &&
                  kMetaUnits <= kThreads,
              "whole copies per thread");

enum Variant { kFull, kNoDecode, kNoWrow, kNoFt, kStream };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// bf16(dec(lo) * w_lo), bf16(dec(hi) * w_hi) of one word, packed (lane j in
// the low half).  Decoding variants get the weights times 2^112 and move
// each half's bits into an f32 of value dec * 2^-112; no_decode reads the
// word as an f32 for both halves.
template <Variant V>
__device__ __forceinline__ uint32_t weigh(uint32_t u, float w_lo,
                                          float w_hi) {
  float lo, hi;
  if constexpr (V == kNoDecode) {
    lo = hi = __uint_as_float(u);
  } else {
    lo = __uint_as_float(((u << 16) & 0x80000000u) |
                         ((u << 13) & 0x0FFFE000u));
    hi = __uint_as_float((u & 0x80000000u) | ((u >> 3) & 0x0FFFE000u));
  }
  return pack_bf16(__fmul_rn(lo, w_lo), __fmul_rn(hi, w_hi));
}

__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// Start row (of 64 words) of the item at sample n0 in level l.  Interleaved
// rows are laid out (n / bn, L, bn, 64); a tile never crosses a block.
template <bool kIl>
__device__ __forceinline__ size_t tile_row(int n0, int l, int n, int levels,
                                           int bn) {
  return kIl ? ((size_t)(n0 / bn) * levels + l) * bn + (n0 % bn)
             : (size_t)l * n + n0;
}

// w1big (L, 128, 64) f32 -> bf16 B fragments, laid out [l][kc][ntp][lane]
// [4 words]: b0, b1 of n-tile 2 ntp, then b0, b1 of n-tile 2 ntp + 1, for
// lane (g, t) and k-chunk kc = 2 cp + h.  b0 (b1) holds rows 2t, 2t + 1
// (2t + 8, 2t + 9) of the chunk: lanes j and j + 64 of word j = 16 cp + 4 t
// + 2 h (+ 1 for b1), column 8 nt + g.
__global__ void encode_ablation_pack_kernel(const float* __restrict__ w1big,
                                            uint32_t* __restrict__ w1p,
                                            int levels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= levels * kW1Units * 4) return;
  const int q = i & 3, lane = (i >> 2) & 31, ntp = (i >> 7) & 3;
  const int kc = (i >> 9) & 7, l = i >> 12;
  const int col = (2 * ntp + (q >> 1)) * 8 + (lane >> 2);
  const int j = 16 * (kc >> 1) + 4 * (lane & 3) + 2 * (kc & 1) + (q & 1);
  const float* w = w1big + (size_t)l * kLanes * kH;
  w1p[i] = pack_bf16(w[j * kH + col], w[(j + kWords) * kH + col]);
}

template <Variant V, bool kIl>
__global__ void __launch_bounds__(kThreads, 2)
encode_ablation_kernel(const uint4* __restrict__ rows,
                       const float* __restrict__ meta,
                       const uint4* __restrict__ w1p, float* __restrict__ h1,
                       float* __restrict__ ft2, int n, int levels, int bn) {
  const int tid = threadIdx.x;

  if constexpr (V == kStream) {
    // h1 unit u (4 floats) = the sum over levels of unit u of each level's
    // rows, in level order, with up to kStreamLevels levels' loads in
    // flight per thread; then ft2's zeros
    const size_t units = (size_t)n * kUnitsPerRow;
    const size_t threads = (size_t)gridDim.x * kThreads;
    const size_t first = blockIdx.x * (size_t)kThreads + tid;
    for (size_t u = first; u < units; u += threads) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int l0 = 0; l0 < levels; l0 += kStreamLevels) {
        uint4 q[kStreamLevels];
#pragma unroll
        for (int k = 0; k < kStreamLevels; ++k) {
          if (l0 + k < levels) {
            q[k] = __ldg(rows + (size_t)(l0 + k) * units + u);
          }
        }
#pragma unroll
        for (int k = 0; k < kStreamLevels; ++k) {
          if (l0 + k < levels) {
            acc.x += __uint_as_float(q[k].x);
            acc.y += __uint_as_float(q[k].y);
            acc.z += __uint_as_float(q[k].z);
            acc.w += __uint_as_float(q[k].w);
          }
        }
      }
      __stcs(reinterpret_cast<float4*>(h1) + u, acc);
    }
    const size_t zeros = (size_t)levels * kF * n / 4;
    for (size_t u = first; u < zeros; u += threads) {
      __stcs(reinterpret_cast<float4*>(ft2) + u,
             make_float4(0.f, 0.f, 0.f, 0.f));
    }
  } else {
    constexpr bool kMeta = V != kNoWrow;
    constexpr bool kFt = V != kNoFt;
    constexpr float kScale = V == kNoDecode ? 1.f : kDecScale;
    extern __shared__ __align__(128) uint4 smem[];
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int tiles = n / kTile;
    const int items =
        (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
        levels;

    // item i: tile blockIdx.x + (i / levels) * gridDim.x, level i % levels
    auto issue = [&](int i) {
      const int l = i % levels;
      const int n0 = ((int)blockIdx.x + i / levels * (int)gridDim.x) * kTile;
      uint4* st = smem + (i % kStages) * kStageUnits;
      const uint4* src =
          rows + tile_row<kIl>(n0, l, n, levels, bn) * kUnitsPerRow;
#pragma unroll
      for (int k = 0; k < kRowUnits / kThreads; ++k) {
        const int u = tid + k * kThreads, s = u / kUnitsPerRow;
        cp_async16(st + s * kUnitsPerRow + ((u % kUnitsPerRow) ^ ((s & 1) << 2)),
                   src + u);
      }
      if (kMeta && tid < kMetaUnits) {
        const int a = tid / (kTile / 4), c = tid % (kTile / 4);
        cp_async16(st + kRowUnits + tid,
                   meta + ((size_t)l * 4 + a) * n + n0 + 4 * c);
      }
      const uint4* w = w1p + (size_t)l * kW1Units;
#pragma unroll
      for (int k = 0; k < kW1Units / kThreads; ++k) {
        cp_async16(st + kRowUnits + kMetaUnits + tid + k * kThreads,
                   w + tid + k * kThreads);
      }
    };

    float acc[2][kH / 8][4];
    issue(0);
    cp_async_commit();
    for (int i = 0; i < items; ++i) {
      if (i + 1 < items) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int l = i % levels;
      const int n0 = ((int)blockIdx.x + i / levels * (int)gridDim.x) * kTile;
      const uint4* rs = smem + (i % kStages) * kStageUnits;
      const float* ms = reinterpret_cast<const float*>(rs + kRowUnits);
      const uint4* ws = rs + kRowUnits + kMetaUnits;
      if (l == 0) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int nt = 0; nt < kH / 8; ++nt) {
            acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] =
                0.f;
          }
        }
      }
      // the lane's samples: s = warp * 32 + 16 m + g + 8 r, row r of the
      // m16 tile's fragment
      float p[2][2][3];
      if constexpr (kMeta) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int s = warp * 32 + 16 * m + g + 8 * r;
#pragma unroll
            for (int a = 0; a < 3; ++a) p[m][r][a] = ms[a * kTile + s];
          }
        }
      }
      float ft[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int cp = 0; cp < 4; ++cp) {
        const int c = 4 * cp + t;   // the unit's corner point (16 + c high)
        uint4 raw[2][2];
        float w_lo[2][2], w_hi[2][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int s = warp * 32 + 16 * m + g + 8 * r;
            raw[m][r] = rs[s * kUnitsPerRow + (c ^ ((g & 1) << 2))];
            if constexpr (kMeta) {
              const float* q = p[m][r];
              w_lo[m][r] =
                  __fmul_rn(point_weight(c, q[0], q[1], q[2]), kScale);
              w_hi[m][r] =
                  c < kValidPts
                      ? __fmul_rn(point_weight(16 + c, q[0], q[1], q[2]),
                                  kScale)
                      : 0.f;
            } else {
              w_lo[m][r] = w_hi[m][r] = kScale;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              a[m][r] = weigh<V>(word(raw[m][r], 2 * h), w_lo[m][r],
                                 w_hi[m][r]);
              a[m][2 + r] = weigh<V>(word(raw[m][r], 2 * h + 1), w_lo[m][r],
                                     w_hi[m][r]);
            }
          }
          const int kc = 2 * cp + h;
#pragma unroll
          for (int ntp = 0; ntp < kH / 16; ++ntp) {
            const uint4 b = ws[(kc * (kH / 16) + ntp) * 32 + lane];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_bf16(acc[m][2 * ntp], a[m], b.x, b.y);
              mma_bf16(acc[m][2 * ntp + 1], a[m], b.z, b.w);
            }
          }
          if constexpr (kFt) {
            // column f of the selector sums the chunk's valid lanes of
            // feature f: pair t carries feature 2h, pair t + 4 feature
            // 2h + 1; a high lane is valid while c < 11
            const bool hv = c < kValidPts;
            const uint32_t sel0 = pack_bf16(g == 2 * h ? 1.f : 0.f,
                                            g == 2 * h && hv ? 1.f : 0.f);
            const uint32_t sel1 = pack_bf16(g == 2 * h + 1 ? 1.f : 0.f,
                                            g == 2 * h + 1 && hv ? 1.f : 0.f);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma_bf16(ft[m], a[m], sel0, sel1);
          }
        }
      }
      // ft2[l, f, n]: lane (g, t < 2) holds features 2t, 2t + 1 of rows g
      // and g + 8 of each m16 tile (zeros for no_ft)
      if (t < 2) {
        float* out = ft2 + ((size_t)l * kF + 2 * t) * n + n0 + warp * 32 + g;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            __stcs(out + 16 * m + 8 * r, ft[m][2 * r]);
            __stcs(out + n + 16 * m + 8 * r, ft[m][2 * r + 1]);
          }
        }
      }
      if (l == levels - 1) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float* out = h1 + (size_t)(n0 + warp * 32 + 16 * m + g + 8 * r) *
                                  kH + 2 * t;
#pragma unroll
            for (int nt = 0; nt < kH / 8; ++nt) {
              __stcs(reinterpret_cast<float2*>(out + nt * 8),
                     make_float2(acc[m][nt][2 * r], acc[m][nt][2 * r + 1]));
            }
          }
        }
      }
      __syncthreads();   // the stage is free for item i + 2
    }
  }
}

// Blocks of one instance resident on the card at once.
template <Variant V, bool kIl>
int resident_blocks(size_t smem) {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, encode_ablation_kernel<V, kIl>, kThreads, smem);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

int pack_w1(const void* w1big, void* w1p, int levels, cudaStream_t stream) {
  const int words = levels * kW1Units * 4;
  encode_ablation_pack_kernel<<<(words + 255) / 256, 256, 0, stream>>>(
      (const float*)w1big, (uint32_t*)w1p, levels);
  return (int)cudaGetLastError();
}

template <Variant V, bool kIl>
int launch(const void* rows, const void* meta, const void* w1big, void* w1p,
           void* h1, void* ft2, int n, int levels, int bn, void* stream) {
  if (n < kTile || n % kTile || levels < 1 ||
      (kIl && (bn < kTile || bn % kTile || n % bn))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = V == kStream ? 0 : kSmemBytes;
  if (smem > 0) {
    const int err = pack_w1(w1big, w1p, levels, st);
    if (err) return err;
    static bool attr = false;
    if (!attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          encode_ablation_kernel<V, kIl>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      attr = true;
    }
  }
  const long long work =
      V == kStream ? ((long long)n * kUnitsPerRow + kThreads - 1) / kThreads
                   : n / kTile;
  const int grid = (int)std::min<long long>(resident_blocks<V, kIl>(smem),
                                            work);
  encode_ablation_kernel<V, kIl><<<grid, kThreads, smem, st>>>(
      (const uint4*)rows, (const float*)meta, (const uint4*)w1p, (float*)h1,
      (float*)ft2, n, levels, bn);
  return (int)cudaGetLastError();
}

}  // namespace

// w1big (L, 128, 64) f32 -> w1p (L * 16,384 bytes): the bf16 B fragments
// every contracting entry packs first (exposed for the card tests).
// Returns cudaGetLastError().
extern "C" int encode_ablation_pack_w1(const void* w1big, void* w1p,
                                       int levels, void* stream) {
  if (levels < 1) return (int)cudaErrorInvalidValue;
  return pack_w1(w1big, w1p, levels, (cudaStream_t)stream);
}

// Each entry: rows (L, n, 64) u32 ((n / bn, L, bn, 64) for full_il), meta
// (L, 4, n) f32, w1big (L, 128, 64) f32, w1p scratch of L * 16,384 bytes
// (unused by stream) -> h1 (n, 64) f32, ft2 (L, 4, n) f32; n a multiple of
// 128 (and of bn, itself a multiple of 128, for full_il).  Returns
// cudaGetLastError().
#define K9_ENTRY(name, V, IL)                                                 \
  extern "C" int name(const void* rows, const void* meta, const void* w1big, \
                      void* w1p, void* h1, void* ft2, int n, int levels,     \
                      int bn, void* stream) {                                \
    return launch<V, IL>(rows, meta, w1big, w1p, h1, ft2, n, levels, bn,     \
                         stream);                                            \
  }

K9_ENTRY(encode_ablation_full, kFull, false)
K9_ENTRY(encode_ablation_no_decode, kNoDecode, false)
K9_ENTRY(encode_ablation_no_wrow, kNoWrow, false)
K9_ENTRY(encode_ablation_no_ft, kNoFt, false)
K9_ENTRY(encode_ablation_stream, kStream, false)
K9_ENTRY(encode_ablation_full_il, kFull, true)
