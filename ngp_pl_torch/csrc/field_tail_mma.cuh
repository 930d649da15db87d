// The field tail's forward on the tensor cores, shared by K7
// (field_tail_fwd.cu) and K8 (field_tail_bwd.cu).
//
// One warp takes 16 samples through the four layers with
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators):
//   h  = bf16(relu(h1)) W2               64 -> 16   8 mma
//   z1 = [bf16(sh) | bf16(h)] Wr1        32 -> 64  16 mma
//   z2 = bf16(relu(z1)) Wr2              64 -> 64  32 mma
//   z3 = bf16(relu(z2)) Wr3 (8 columns)  64 -> 8    4 mma
// Activations stay in registers: the C fragments of two neighbouring
// n-tiles (16 x 8 each) are rounded to bf16 in place and are the A fragment
// of the next layer's 16-wide k-chunk, so no layer goes through shared
// memory.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 x b32: a0 (g, 2t..2t+1), a1 (g+8, 2t..),
//     a2 (g, 2t+8..), a3 (g+8, 2t+8..); the lower column in the low half.
//   B (16 x 8), 2 x b32: b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g).
//   C (16 x 8) f32: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// The wrapper (`pack_weights` in ngp_pl_torch/ops/field_tail.py) stores
// every weight as bf16 B fragments in lane order, 256 bytes per fragment,
// so a lane reads its b0, b1 with one conflict-free 8-byte load: the
// packing ldmatrix would do on every read is done once per weight update.
//
// The inputs come in through cp.async into f32 stages whose 16-byte chunks
// are XOR-swizzled by row, so that the fragment reads (8-byte, 4 rows per
// half-warp) meet no bank conflicts without padding:
//   h1 rows (64 f32, 16 chunks): chunk c of row r at c ^ (2 (r & 3));
//   sh rows (16 f32, 4 chunks):  chunk c of row r at c ^ (2 ((r >> 1) & 1)).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ft {

constexpr int kHid = 64;
constexpr int kGeo = 16;
constexpr int kSh = 16;
constexpr int kWarps = 8;            // warps per block, both kernels
constexpr int kThreads = 32 * kWarps;

// B fragments in the packed weight buffer, in fragments of 32 lanes x 8 B.
// Forward: W2 (k 64, n 16), Wr1 (32, 64), Wr2 (64, 64), Wr3 padded (64, 8).
// Backward: Wr3^T padded (16, 64), Wr2^T (64, 64), Wr1[16:]^T (64, 16),
// W2^T (16, 64).  Within a set the fragment (nt, kc) is at nt * KC + kc.
constexpr int kFragW2 = 0;
constexpr int kFragWr1 = 8;
constexpr int kFragWr2 = 24;
constexpr int kFragWr3 = 56;
constexpr int kFragsFwd = 60;
constexpr int kFragWr3T = 60;
constexpr int kFragWr2T = 68;
constexpr int kFragWr1hT = 100;
constexpr int kFragW2T = 108;
constexpr int kFragsAll = 116;
constexpr int kFragBytes = 32 * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// c[nt] = a x B for the NT n-tiles of a layer of KC k-chunks whose B
// fragments start at `frags` (shared memory).  The n-tiles are the inner
// loop, so that neighbouring products do not wait on each other.
template <int KC, int NT>
__device__ __forceinline__ void mma_layer(const uint32_t (&a)[KC][4],
                                          const uint2* frags, int lane,
                                          float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = frags[(nt * KC + kc) * 32 + lane];
      mma_bf16(c[nt], a[kc], b.x, b.y);
    }
  }
}

// The A fragments of bf16(relu(c)) (or bf16(c) with kRelu false) for the
// KC = NT / 2 k-chunks the n-tiles of c form; bit 4 nt + e of the returned
// mask is c[nt][e] > 0.
template <int NT, bool kRelu>
__device__ __forceinline__ uint32_t c_to_a(const float (&c)[NT][4],
                                           uint32_t (&a)[NT / 2][4]) {
  uint32_t mask = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c[nt][e] > 0.f) mask |= 1u << (4 * nt + e);
      v[e] = kRelu ? fmaxf(c[nt][e], 0.f) : c[nt][e];
    }
    a[nt / 2][(nt & 1) * 2] = pack_bf16(v[0], v[1]);
    a[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
  }
  return mask;
}

// Element (r, col) of an h1 stage (rows of 64 f32) and of an sh stage
// (rows of 16 f32), two neighbouring columns (col even).
__device__ __forceinline__ float2 ld_h1(const float* s, int r, int col) {
  const int chunk = (col >> 2) ^ ((r & 3) << 1);
  return *reinterpret_cast<const float2*>(s + r * kHid + chunk * 4 +
                                          (col & 3));
}
__device__ __forceinline__ float2 ld_sh(const float* s, int r, int col) {
  const int chunk = (col >> 2) ^ (((r >> 1) & 1) << 1);
  return *reinterpret_cast<const float2*>(s + r * kSh + chunk * 4 +
                                          (col & 3));
}

// Copies rows [row0, row0 + rows) of h1 (n, 64) and sh (n, 16) into the
// swizzled stages, threads `tid` of `nthreads`; rows past n are zeros.
__device__ __forceinline__ void load_rows_async(float* h1s, float* shs,
                                                const float* __restrict__ h1,
                                                const float* __restrict__ sh,
                                                int row0, int rows, int n,
                                                int tid, int nthreads) {
  for (int q = tid; q < rows * (kHid / 4); q += nthreads) {
    const int r = q >> 4, c = q & 15;
    const bool ok = row0 + r < n;
    const float* src = ok ? h1 + (size_t)(row0 + r) * kHid + c * 4 : h1;
    cp_async16(h1s + r * kHid + ((c ^ ((r & 3) << 1)) << 2), src,
               ok ? 16 : 0);
  }
  for (int q = tid; q < rows * (kSh / 4); q += nthreads) {
    const int r = q >> 2, c = q & 3;
    const bool ok = row0 + r < n;
    const float* src = ok ? sh + (size_t)(row0 + r) * kSh + c * 4 : sh;
    cp_async16(shs + r * kSh + ((c ^ (((r >> 1) & 1) << 1)) << 2), src,
               ok ? 16 : 0);
  }
}

// Copies the uint4s [0, count) of src (global) into dst (shared).
__device__ __forceinline__ void copy_frags(uint4* dst,
                                           const uint4* __restrict__ src,
                                           int count, int tid, int nthreads) {
  for (int q = tid; q < count; q += nthreads) dst[q] = src[q];
}

// The forward of one warp's 16 samples: rows r0 .. r0 + 15 of the stages.
struct TailFwd {
  uint32_t xa[4][4];    // bf16(relu(h1)), A fragments of 4 k-chunks
  uint32_t m0;          // h1 > 0, bit 4 j + e of a (16, 64) C layout
  float h[2][4];        // h = x W2, f32 accumulators
  uint32_t sha[4];      // bf16(sh)
  uint32_t ha[4];       // bf16(h)
  uint32_t r1a[4][4];   // bf16(relu(z1))
  uint32_t m1;          // z1 > 0
  uint32_t r2a[4][4];   // bf16(relu(z2))
  uint32_t m2;          // z2 > 0
  float z3[4];          // z3, columns 2t, 2t + 1 (3 of 8 are real)
};

__device__ __forceinline__ void tail_forward(const float* h1s,
                                             const float* shs, int r0,
                                             const uint2* wf, int lane,
                                             TailFwd& f) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
  f.m0 = 0;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const float2 v[4] = {ld_h1(h1s, ra, 16 * kc + 2 * t),
                         ld_h1(h1s, rb, 16 * kc + 2 * t),
                         ld_h1(h1s, ra, 16 * kc + 8 + 2 * t),
                         ld_h1(h1s, rb, 16 * kc + 8 + 2 * t)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // a_q holds the C-layout elements of n-tile 2 kc + q / 2, e = 2 (q % 2)
      const int bit = 4 * (2 * kc + (q >> 1)) + 2 * (q & 1);
      if (v[q].x > 0.f) f.m0 |= 1u << bit;
      if (v[q].y > 0.f) f.m0 |= 1u << (bit + 1);
      f.xa[kc][q] = pack_bf16(fmaxf(v[q].x, 0.f), fmaxf(v[q].y, 0.f));
    }
  }
  mma_layer<4, 2>(f.xa, wf + kFragW2 * 32, lane, f.h);

  {
    const float2 v[4] = {ld_sh(shs, ra, 2 * t), ld_sh(shs, rb, 2 * t),
                         ld_sh(shs, ra, 8 + 2 * t), ld_sh(shs, rb, 8 + 2 * t)};
#pragma unroll
    for (int q = 0; q < 4; ++q) f.sha[q] = pack_bf16(v[q].x, v[q].y);
  }
  uint32_t ha[1][4];
  c_to_a<2, false>(f.h, ha);
#pragma unroll
  for (int q = 0; q < 4; ++q) f.ha[q] = ha[0][q];
  const uint32_t in1[2][4] = {{f.sha[0], f.sha[1], f.sha[2], f.sha[3]},
                              {f.ha[0], f.ha[1], f.ha[2], f.ha[3]}};
  float z[8][4];
  mma_layer<2, 8>(in1, wf + kFragWr1 * 32, lane, z);
  f.m1 = c_to_a<8, true>(z, f.r1a);
  mma_layer<4, 8>(f.r1a, wf + kFragWr2 * 32, lane, z);
  f.m2 = c_to_a<8, true>(z, f.r2a);
  float z3[1][4];
  mma_layer<4, 1>(f.r2a, wf + kFragWr3 * 32, lane, z3);
#pragma unroll
  for (int e = 0; e < 4; ++e) f.z3[e] = z3[0][e];
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

}  // namespace ft
