// K6: accumulating row scatter, out[idx[p], :] += rows[p, :].
//
// Replaces the TPU kernel ngp_pl_tpu/ops/scatter_accum.py `scatter_accum`,
// which walks the samples in order on one core and read-modify-writes a
// VMEM-resident accumulator, one (1, W) row at a time.  The JAX package has
// no runtime caller for it (only benchmarks and tests); the table gradient
// of the train path goes through csrc/hash_encode_bwd.cu instead.
//
// Semantics (held against `scatter_rows_plain`, which is `index_add_`):
// out (n_rows, w) f32, zeroed by the caller, gets every row p of rows (n, w)
// f32 added at row idx[p] (int64).  Indices outside [0, n_rows) are dropped.
//
// What bounds it on an H100: each input row is read once and the output is
// written once, so the floor is bytes.  Hopper's blocks run in no order, so
// the TPU's serial accumulator becomes one warp per input row adding its w
// floats with f32 atomics (coalesced: lane c takes columns c, c + 32, ...).
// Atomic order is not deterministic; rows that share an index contend.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;   // 8 warps, one input row each

__global__ void __launch_bounds__(kBlock)
scatter_rows_kernel(const float* __restrict__ rows,
                    const int64_t* __restrict__ idx, float* __restrict__ out,
                    int n, int w, int n_rows) {
  const int p = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= n) return;
  const int64_t r = idx[p];
  if (r < 0 || r >= n_rows) return;
  const float* src = rows + (size_t)p * w;
  float* dst = out + (size_t)r * w;
  for (int c = lane; c < w; c += 32) {
    atomicAdd(dst + c, src[c]);
  }
}

}  // namespace

// rows (n, w) f32, idx (n,) int64, out (n_rows, w) f32 (zeroed by the
// caller).  Returns cudaGetLastError().
extern "C" int scatter_rows(const void* rows, const void* idx, void* out,
                            int n, int w, int n_rows, void* stream) {
  if (n < 1 || w < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
  const int warps_per_block = kBlock / 32;
  const int grid = (n + warps_per_block - 1) / warps_per_block;
  scatter_rows_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const int64_t*)idx, (float*)out, n, w, n_rows);
  return (int)cudaGetLastError();
}
