// Correlation-window lookup of RAFT's materialized pyramid, forward and
// backward, for sm_90a.
//
// Replaces the Pallas kernels of pcfa_tpu/ops/pallas/corr_lookup.py:
// `_vslice_fwd_impl` (the vertical 2-tap blend, with an XLA einsum for the
// horizontal step) and `_vslice_bwd` (its transpose). Here the whole 2-D
// window is one kernel.
//
// Math. All (2r+1)^2 samples of one query at one level share a single
// fractional offset (fx, fy), because the window offsets are integers. So
// the window reads one (P+1)x(P+1) patch (P = 2r+1) with its top-left cell
// at (floor(x)-r, floor(y)-r), zero outside the map, and blends it:
//   out[n, l*P*P + a*P + b] = bilinear sample at (x + a - r, y + b - r).
// The FIRST offset index a moves x: the reference's transposed-window
// quirk (pcfa_tpu/ops/correlation.py:149-174).
//
// Bound on the H100 (RAFT at 376x1248, B = 2, bf16: N = 14,664 queries,
// levels 47x156, 23x78, 11x39, 5x19): the forward writes N*4*81 outputs
// (9.5 MB) and reads at most N*4*100 patch cells (11.7 MB); the backward
// reads the 9.5 MB cotangent, but the zeroed gradient maps it fills hold
// N*9,650 elements (283 MB), which the wrapper's torch.zeros writes. Both
// are memory-bound; the backward by the gradient maps' bytes.
//
// Design. One warp per (query, level): the lanes stage the patch (or, in
// the backward, the 81 cotangents) in shared memory, then each lane
// produces outputs (forward) or patch-cell gradients (backward; each cell
// gathers its <= 4 window cotangents). Each query owns its own gradient
// map, so no atomics are needed and only in-bound cells are written. All
// levels go in one launch (grid.y = level). The integer corner is clipped
// before any index arithmetic, so non-finite or exploding coordinates can
// not index out of bounds: a clipped window lies wholly outside the map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSide = 16;  // P + 1 <= 16, i.e. radius <= 7
constexpr int kWarps = 8;     // queries per block

struct Levels {
  const void* map[kMaxLevels];
  void* dmap[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// First patch cell along one axis and the shared fractional offset. The
// corner is clipped into [-(P+1), extent]: beyond either end the patch is
// wholly outside the map, so clipping changes nothing but keeps NaN/inf
// coordinates (fmaxf/fminf return the non-NaN operand) in int range.
__device__ __forceinline__ void corner(float c, float scale, int radius,
                                       int extent, int* first, float* frac) {
  const float s = c * scale;
  const float f = floorf(s);
  *frac = s - f;
  const float lo = fminf(fmaxf(f - (float)radius, -(float)(2 * radius + 2)),
                         (float)extent);
  *first = (int)lo;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_window_fwd_kernel(Levels lv, const float* __restrict__ coords,
                       T* __restrict__ out, int n_query, int num_levels,
                       int radius) {
  __shared__ float patch[kWarps][kMaxSide * kMaxSide];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const int l = blockIdx.y;
  if (n >= n_query) return;  // whole warp; only __syncwarp below
  const int P = 2 * radius + 1;
  const int S = P + 1;
  const int H = lv.h[l], W = lv.w[l];
  const float scale = 1.0f / (float)(1 << l);
  int x0, y0;
  float fx, fy;
  corner(coords[2 * (int64_t)n], scale, radius, W, &x0, &fx);
  corner(coords[2 * (int64_t)n + 1], scale, radius, H, &y0, &fy);

  const T* map = static_cast<const T*>(lv.map[l]) + (int64_t)n * H * W;
  float* p = patch[warp];
  for (int k = lane; k < S * S; k += 32) {
    const int u = k / S, v = k - u * S;  // u: row (y), v: column (x)
    const int y = y0 + u, x = x0 + v;
    p[k] = (y >= 0 && y < H && x >= 0 && x < W)
               ? load_f(map, (int64_t)y * W + x) : 0.0f;
  }
  __syncwarp();

  T* o = out + ((int64_t)n * num_levels + l) * P * P;
  for (int k = lane; k < P * P; k += 32) {
    const int a = k / P, b = k - a * P;  // a moves x, b moves y
    const float top = (1.0f - fx) * p[b * S + a] + fx * p[b * S + a + 1];
    const float bot =
        (1.0f - fx) * p[(b + 1) * S + a] + fx * p[(b + 1) * S + a + 1];
    store_f(o, k, (1.0f - fy) * top + fy * bot);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_window_bwd_kernel(Levels lv, const float* __restrict__ coords,
                       const T* __restrict__ grad_out, int n_query,
                       int num_levels, int radius) {
  __shared__ float gwin[kWarps][kMaxSide * kMaxSide];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const int l = blockIdx.y;
  if (n >= n_query) return;
  const int P = 2 * radius + 1;
  const int S = P + 1;
  const int H = lv.h[l], W = lv.w[l];
  const float scale = 1.0f / (float)(1 << l);
  int x0, y0;
  float fx, fy;
  corner(coords[2 * (int64_t)n], scale, radius, W, &x0, &fx);
  corner(coords[2 * (int64_t)n + 1], scale, radius, H, &y0, &fy);

  const T* go = grad_out + ((int64_t)n * num_levels + l) * P * P;
  float* g = gwin[warp];
  for (int k = lane; k < P * P; k += 32) g[k] = load_f(go, k);
  __syncwarp();

  T* dmap = static_cast<T*>(lv.dmap[l]) + (int64_t)n * H * W;
  for (int k = lane; k < S * S; k += 32) {
    const int u = k / S, v = k - u * S;
    const int y = y0 + u, x = x0 + v;
    if (y < 0 || y >= H || x < 0 || x >= W) continue;
    // cell row u is row b = u (weight 1-fy) or b = u-1 (weight fy) of a
    // window sample; likewise column v for a = v (1-fx) or a = v-1 (fx)
    float acc = 0.0f;
#pragma unroll
    for (int db = 0; db < 2; ++db) {
      const int b = u - db;
      if (b < 0 || b >= P) continue;
      const float wy = db == 0 ? 1.0f - fy : fy;
#pragma unroll
      for (int da = 0; da < 2; ++da) {
        const int a = v - da;
        if (a < 0 || a >= P) continue;
        const float wx = da == 0 ? 1.0f - fx : fx;
        acc += wy * wx * g[a * P + b];
      }
    }
    store_f(dmap, (int64_t)y * W + x, acc);
  }
}

bool valid_args(int dtype, int num_levels, int radius, int n_query) {
  return (dtype == 0 || dtype == 1) && num_levels >= 1 &&
         num_levels <= kMaxLevels && radius >= 0 &&
         2 * radius + 2 <= kMaxSide && n_query >= 0;
}

Levels make_levels(int num_levels, const int* heights, const int* widths) {
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
  }
  return lv;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (maps, output and cotangent alike);
// coords: float32 (n_query, 2) in level-0 pixels; out: (n_query,
// num_levels * P * P). Returns cudaGetLastError() after the launch.
extern "C" int pcfa_corr_window_fwd(int dtype, int num_levels,
                                    const void* const* maps,
                                    const int* heights, const int* widths,
                                    const void* coords, void* out,
                                    int n_query, int radius, void* stream) {
  if (!valid_args(dtype, num_levels, radius, n_query))
    return (int)cudaErrorInvalidValue;
  if (n_query == 0) return 0;
  Levels lv = make_levels(num_levels, heights, widths);
  for (int l = 0; l < num_levels; ++l) lv.map[l] = maps[l];
  const dim3 grid((n_query + kWarps - 1) / kWarps, num_levels);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  if (dtype == 0)
    corr_window_fwd_kernel<float><<<grid, block, 0, s>>>(
        lv, c, static_cast<float*>(out), n_query, num_levels, radius);
  else
    corr_window_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        lv, c, static_cast<__nv_bfloat16*>(out), n_query, num_levels, radius);
  return (int)cudaGetLastError();
}

// dmaps: the zero-filled gradient maps, one per level (allocated by the
// caller); grad_out: (n_query, num_levels * P * P).
extern "C" int pcfa_corr_window_bwd(int dtype, int num_levels,
                                    void* const* dmaps,
                                    const int* heights, const int* widths,
                                    const void* coords, const void* grad_out,
                                    int n_query, int radius, void* stream) {
  if (!valid_args(dtype, num_levels, radius, n_query))
    return (int)cudaErrorInvalidValue;
  if (n_query == 0) return 0;
  Levels lv = make_levels(num_levels, heights, widths);
  for (int l = 0; l < num_levels; ++l) lv.dmap[l] = dmaps[l];
  const dim3 grid((n_query + kWarps - 1) / kWarps, num_levels);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  if (dtype == 0)
    corr_window_bwd_kernel<float><<<grid, block, 0, s>>>(
        lv, c, static_cast<const float*>(grad_out), n_query, num_levels,
        radius);
  else
    corr_window_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        lv, c, static_cast<const __nv_bfloat16*>(grad_out), n_query,
        num_levels, radius);
  return (int)cudaGetLastError();
}
