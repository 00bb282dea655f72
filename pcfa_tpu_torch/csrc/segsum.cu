// Segment row-sum (the warp's image gradient) for sm_90a:
//   out[p, k] = sum over i with idx[i] == p of upd[i, k]
// with (N, K) update rows into `nrows` zero-initialised float32 cells.
//
// Replaces the Pallas kernel of pcfa_tpu/ops/pallas/segsum.py:
// `segment_rows_pallas`, which sorts the rows by cell and splats them as
// blocked one-hot matmuls on the MXU, because a TPU serialises a scatter
// with colliding indices. On Hopper the splat is what the hardware does
// well: one float32 atomicAdd per element, resolved in the L2 cache, as the
// reference's own CUDA warp backward does (resample2d_kernel.cu). No sort.
//
// Bound on the H100 (PWCNet's warps at 384x1280, B = 1): the largest warp
// reads N x K = 30,720 x 128 float32 rows (15.7 MB) and writes 31,137 x 128
// cells (15.9 MB); memory-bound, ~9.5 us at 3.35 TB/s.
//
// Design. One thread per element, consecutive threads on consecutive
// columns of a row: the row reads are coalesced and each warp's atomics hit
// consecutive addresses of one or two cells. An index outside [0, nrows)
// is skipped, so no write leaves the buffer. Atomics make the order of the
// additions, and so the float32 rounding, vary from run to run. The rows
// are float32 only: the warp's backward always builds them in float32, as
// the TPU kernel takes them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int64_t* __restrict__ idx, const float* __restrict__ upd,
              float* __restrict__ out, int64_t n, int k, int64_t nrows) {
  const int64_t total = n * k;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int64_t i = e / k;
    const int64_t p = idx[i];
    if (p >= 0 && p < nrows) atomicAdd(out + p * k + (e - i * k), upd[e]);
  }
}

}  // namespace

// upd: float32 (n, k); idx: int64 (n); out: float32 (nrows, k),
// zero-filled by the caller. Returns cudaGetLastError().
extern "C" int pcfa_segsum(const void* idx, const void* upd, void* out,
                           int64_t n, int k, int64_t nrows, void* stream) {
  if (n < 0 || k <= 0 || nrows < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t blocks = (n * k + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks < 65536 * 16 ? blocks : 65536 * 16));
  segsum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(idx), static_cast<const float*>(upd),
      static_cast<float*>(out), n, k, nrows);
  return (int)cudaGetLastError();
}
