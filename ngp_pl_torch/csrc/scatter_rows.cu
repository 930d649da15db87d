// K6: accumulating row scatter, out[clamp(idx[p]), :] += rows[p, :].
//
// Replaces the TPU kernel ngp_pl_tpu/ops/scatter_accum.py `scatter_accum`,
// which walks the samples in order on one core and read-modify-writes a
// VMEM-resident accumulator, one (1, W) row at a time.  The JAX package has
// no runtime caller for it (only benchmarks and tests); the table gradient
// of the train path goes through csrc/hash_encode_bwd.cu instead.
//
// Semantics (held against `scatter_rows_plain`, a clamped `index_add_`):
// out (n_rows, w) f32, zeroed by the caller, gets every row p of rows (n, w)
// f32 added at row clamp(idx[p], 0, n_rows - 1) (idx int64), as
// `scatter_accum` clips its indices: no row is dropped.
//
// What bounds it on an H100 (80GB HBM3, 700 W): each input row is read
// once and the output is written once, so the least time is the bytes'
// (262,144 rows of 128 floats into 16,384: 144.7 MB, 0.043 ms at 3.35
// TB/s; the JAX scatter bench's runs of 74 equal indices, 327,680 rows into
// 512: 170.7 MB, 0.051 ms).  Hopper's blocks run in no order, so the TPU's
// serial accumulator becomes reductions in the L2, and the L2 is what
// holds the uniform input: benchmarking/scatter_rows_probe.py reads
// 0.051 ms for the row reads alone (reductions compiled out), 0.040 ms for
// the reductions alone (rows not read) and 0.073 ms for both, the fill of
// the L2 from device memory, its reads into the SMs and its f32
// reductions sharing its bandwidth.  The first design (a warp per row,
// scalar reductions) ran there at the same 0.074 ms; on the runs its
// scalar reductions of one output line per row serialised (0.119 ms).
// The design:
//   - A warp takes 8 consecutive input rows and a lane 4 consecutive
//     columns of each (`red.global.add.v4.f32`, atomicAdd on float4), so a
//     128-float row is one vector instruction per warp.  Where w % 4 != 0
//     or a pointer is not 16-byte aligned the same kernel runs with scalar
//     loads and reductions (0.078 ms on the uniform input).
//   - A lane loads 4 rows at once (16-byte streaming loads, so the output's
//     lines stay in the L2), then walks them in order: a run of equal
//     consecutive indices is summed in registers and reduced once, so the
//     runs input makes about one reduction per warp instead of 8 that
//     contend for one line: 0.054-0.056 ms, 2.18x the first design.
//   - The probe's twins (16 or 32 rows a warp, 8 or 16 rows in flight,
//     loads through the read-only cache, fewer registers) read within 3%
//     on the uniform input or slower.
// Reductions run in no fixed order and a run's rows are summed first, so
// the result differs from the plain version only in the order of f32
// additions: K6_TOL of chip_smoke.py, 1e-5 of max (the card reads up to
// 1.6e-6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;   // 8 warps
constexpr int kSeg = 8;       // consecutive input rows per warp
constexpr int kBatch = 4;     // rows a lane loads at once

__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float zero_of(float) { return 0.f; }

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }

__device__ __forceinline__ void reduce(float4* p, const float4& v) {
  atomicAdd(p, v);   // RED.E.ADD.F32x4 on sm_90: the result is not read
}
__device__ __forceinline__ void reduce(float* p, float v) { atomicAdd(p, v); }

// V = float4 (w % 4 == 0, 16-byte aligned rows and out) or float; a row
// holds w / (sizeof(V) / 4) units of V.  Warp s takes rows [8 s, 8 s + 8).
template <typename V>
__global__ void __launch_bounds__(kBlock)
scatter_rows_kernel(const V* __restrict__ rows,
                    const int64_t* __restrict__ idx, V* __restrict__ out,
                    int n, int units, int n_rows) {
  const size_t seg = (blockIdx.x * (size_t)kBlock + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (seg * kSeg >= (size_t)n) return;
  const int p0 = (int)(seg * kSeg);
  const int p1 = min(p0 + kSeg, n);
  // column blocks of 32 units, warp-uniform; the run logic below is
  // uniform too, since every lane reads the same indices
  for (int c0 = 0; c0 < units; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < units;
    V acc = zero_of(V());
    int64_t cur = -1;
    for (int b = p0; b < p1; b += kBatch) {
      V v[kBatch];
      int64_t r[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int p = b + i;
        r[i] = -1;
        v[i] = zero_of(V());
        if (p < p1) {
          const int64_t q = __ldg(idx + p);
          r[i] = q < 0 ? 0 : (q >= n_rows ? n_rows - 1 : q);
          if (active) v[i] = __ldcs(rows + (size_t)p * units + c);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (r[i] < 0) break;
        if (r[i] == cur) {
          add_to(acc, v[i]);
        } else {
          if (cur >= 0 && active) reduce(out + cur * units + c, acc);
          acc = v[i];
          cur = r[i];
        }
      }
    }
    if (cur >= 0 && active) reduce(out + cur * units + c, acc);
  }
}

template <typename V>
void run(const void* rows, const void* idx, void* out, int n, int units,
         int n_rows, cudaStream_t stream) {
  const long long segs = ((long long)n + kSeg - 1) / kSeg;
  const int grid = (int)((segs + kBlock / 32 - 1) / (kBlock / 32));
  scatter_rows_kernel<V><<<grid, kBlock, 0, stream>>>(
      (const V*)rows, (const int64_t*)idx, (V*)out, n, units, n_rows);
}

}  // namespace

// rows (n, w) f32, idx (n,) int64, out (n_rows, w) f32 (zeroed by the
// caller).  Returns cudaGetLastError().
extern "C" int scatter_rows(const void* rows, const void* idx, void* out,
                            int n, int w, int n_rows, void* stream) {
  if (n < 1 || w < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
  const bool vec = w % 4 == 0 && ((uintptr_t)rows | (uintptr_t)out) % 16 == 0;
  if (vec) {
    run<float4>(rows, idx, out, n, w / 4, n_rows, (cudaStream_t)stream);
  } else {
    run<float>(rows, idx, out, n, w, n_rows, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
